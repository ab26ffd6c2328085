"""Drive the PyTorch port's live cost-metered server on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. device: the card's name, count, and `nvidia-smi` name and power limit;
  2. build: every kernel of `src/repro_torch/csrc/` with nvcc for sm_90a,
     one process each, in parallel; ptxas's register/shared-memory lines;
  3. kernels: each kernel against its plain PyTorch version at the served
     shapes, in bf16, with |kernel - plain| <= 1e-3 + 2**-7 |plain| on
     every element (one bf16 step of the result; `repro_torch.kernels.
     bf16_gate`); the same gate must reject a planted fault (the kernel
     run with the last page, or the last key tile, of one row dropped);
     then the kernel, the plain version and the yardstick PyTorch call
     timed on the device (CUDA graphs of repeated calls, timed with CUDA
     events), each beside its bound;
  4. small-input check: a narrow 2-layer model through the kernels on the
     card against the same model through the plain versions on the CPU;
  5. main path: full-width llama31-8b (all 32 layers, random weights from
     a seed) through `build_engine` -> `Engine` -> `RealExecutor` ->
     `CostMeter`, serving 8 chat requests (512:256) that overlap; every
     request must finish, and the kernels' launch counts must be 32 per
     prefill call and 32 per decode step.
Then a `kernels` JSON line, the `nvidia-smi` line, and as the last line
`{"ok": true, "device": {...}}`. Needs no network and imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12          # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor FLOP/s (data sheet)
# served shapes: llama31-8b heads, page 16, 8 slots of 512 + 256 tokens
B, HQ, HKV, D, PAGE, MAXP = 8, 32, 8, 128, 16, 48


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def device_ms(fn, arg_sets, per_graph=20, replays=5) -> float:
    """Device time of one call: `per_graph` calls (cycling over
    `arg_sets`, so their data does not all sit in L2) captured in a CUDA
    graph, replayed `replays` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(per_graph):
            fn(*arg_sets[i % len(arg_sets)])
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (replays * per_graph)
    del g
    return ms


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / MEM_BW * 1e3, flops / BF16_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def hold(name, pairs, faulty, fault_ref):
    """Gate each (kernel, plain) pair; then require that the gate rejects
    `faulty`, the kernel's output on inputs that drop a little of the work
    that `fault_ref` covers."""
    from repro_torch.kernels import bf16_gate
    err = max(max_abs(o, r) for o, r in pairs)
    gate = max(bf16_gate(o, r) for o, r in pairs)
    if not gate <= 1:
        fail(f"{name} disagrees with its plain version: max abs {err}, "
             f"gate {gate} > 1")
    fault = {"max_abs": max_abs(faulty, fault_ref),
             "gate": bf16_gate(faulty, fault_ref)}
    if not fault["gate"] > 1:
        fail(f"{name}: the gate accepts a planted fault: {fault}")
    return err, gate, fault


def check_paged(gen):
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    dev = "cuda"
    P = B * MAXP + 1
    # ragged: empty, one token, exact page boundaries, the full 768
    lens = torch.tensor([0, 1, 16, 17, 256, 512, 700, 768], dtype=torch.int32,
                        device=dev)
    bt = (torch.randperm(P - 1, generator=gen, device=dev)[:B * MAXP] + 1) \
        .to(torch.int32).reshape(B, MAXP)
    q = torch.randn(B, HQ, D, generator=gen, device=dev).bfloat16()
    pools = [(torch.randn(P, PAGE, HKV, D, generator=gen, device=dev)
              .bfloat16(),
              torch.randn(P, PAGE, HKV, D, generator=gen, device=dev)
              .bfloat16()) for _ in range(4)]
    pairs = []
    for kp, vp in pools[:2]:
        out = paged_attention_kernel(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        pairs.append((out, paged_attention_ref(q, kp, vp, bt, lens)))
        if not torch.all(out[0] == 0):
            fail("paged attention: seq_len 0 did not give 0")
    # planted fault: the 768-token row without its last page, as a loop
    # bound off by one page would give
    short = lens.clone()
    short[-1] -= PAGE
    kp, vp = pools[1]
    err, gate, fault = hold("paged attention", pairs,
                            paged_attention_kernel(q, kp, vp, bt, short),
                            pairs[1][1])
    args = [(q, kp, vp, bt, lens) for kp, vp in pools]
    n_tok = int(lens.sum())
    nbytes = (2 * n_tok * HKV * D * 2 + 2 * q.numel() * 2 + bt.numel() * 4
              + lens.numel() * 4)
    flops = 4 * n_tok * HQ * D
    b_ms, b_by = bound(nbytes, flops)
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:71",
        "max_abs_err": err, "gate": gate, "fault": fault,
        "fault_desc": "the 768-token row's last page dropped",
        "ms": device_ms(paged_attention_kernel, args),
        "plain_ms": device_ms(paged_attention_ref, args),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"B={B} Hq={HQ} Hkv={HKV} D={D} page={PAGE} "
                 f"max_pages={MAXP} seq_lens={lens.tolist()}",
    }


def check_flash(gen):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    dev = "cuda"
    pairs = []
    sets = {}
    for L in (512, 576):   # 576: a multiple of 64, not of 128
        sets[L] = [tuple(torch.randn(B, L, h, D, generator=gen, device=dev)
                         .bfloat16() for h in (HQ, HKV, HKV))
                   for _ in range(2)]
        for q, k, v in sets[L]:
            out = flash_attention_kernel(q, k, v, causal=True)
            torch.cuda.synchronize()
            pairs.append((out, flash_attention_ref(q, k, v, causal=True)))
    L = 512                # the served prompt length, chat 512:256
    # planted fault: the last 64-key tile dropped, as a tile count off by
    # one would give; it changes only the last 64 query rows
    q, k, v = sets[L][0]
    err, gate, fault = hold(
        "flash attention", pairs,
        flash_attention_kernel(q, k[:, :-64].contiguous(),
                               v[:, :-64].contiguous(), causal=True),
        pairs[0][1])
    args = sets[L]
    lib_args = [tuple(t.transpose(1, 2).contiguous() for t in a)
                for a in args]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    nbytes = 2 * (2 * B * L * HQ * D + 2 * B * L * HKV * D)
    flops = 4 * B * HQ * L * L * D / 2
    b_ms, b_by = bound(nbytes, flops)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "max_abs_err": err, "gate": gate, "fault": fault,
        "fault_desc": "the last 64-key tile of Lp 512 dropped",
        "ms": device_ms(lambda q, k, v: flash_attention_kernel(
            q, k, v, causal=True), args),
        "plain_ms": device_ms(lambda q, k, v: flash_attention_ref(
            q, k, v, causal=True), args, per_graph=4),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(sdpa, lib_args),
        "shape": f"B={B} Sq=Sk={L} Hq={HQ} Hkv={HKV} D={D} causal",
    }


def small_input_check():
    """A 2-layer model at head_dim 128 through the kernels on the card and
    through the plain versions on the CPU, on the same bf16 weights and
    tokens: K/V pools within 0.02 and at least 90% of greedy tokens equal
    (a flip needs a near-tie of two logits)."""
    import numpy as np
    from repro_torch.configs import reduced
    from repro_torch.models import init_params
    from repro_torch.serving import runner
    cfg = reduced("llama31-8b", d_model=512, ff=1024, vocab=1024)
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    sides = {dev: dict(params=_tree_map(lambda t: t.to(dev), params),
                       pools=runner.init_pools(cfg, 33, PAGE, device=dev),
                       seq=torch.zeros(4, dtype=torch.int32, device=dev))
             for dev in ("cpu", "cuda")}
    pre, dec = runner.make_step_fns(cfg, PAGE)
    rng = np.random.default_rng(0)
    lens = np.array([37, 0, 128, 5], np.int32)
    tokens = np.zeros((4, 128), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(0, 1000, n)
    bt = np.arange(1, 33, dtype=np.int32).reshape(4, 8)
    active = lens > 0
    streams = {}
    cur = np.zeros(4, np.int32)
    for step in range(9):
        for dev, s in sides.items():
            t = lambda a: torch.from_numpy(a).to(dev)
            if step == 0:
                out, s["seq"] = pre(s["params"], s["pools"], t(bt), s["seq"],
                                    t(tokens), t(lens), t(active))
            else:
                out, s["seq"] = dec(s["params"], s["pools"], t(bt), s["seq"],
                                    t(cur), t(active))
            streams.setdefault(dev, []).append(out.cpu().numpy()[active])
        cur[active] = streams["cpu"][-1]      # both fed the CPU's tokens
    diff = max(float((a[n][1:].float() -
                      b[n][1:].float().cpu()).abs().max())
               for a, b in zip(sides["cpu"]["pools"], sides["cuda"]["pools"])
               for n in ("k", "v"))
    agree = float(np.mean(np.concatenate(
        [x == y for x, y in zip(streams["cpu"], streams["cuda"])])))
    if not (diff <= 0.02 and agree >= 0.9):
        fail(f"small-input check: pool diff {diff}, token agreement {agree}")
    return diff, agree


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_kernel
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.serving import ArrivalSpec, runner

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    print(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions, then timed
    runner.set_matmul_precision()     # the plain versions' einsums in fp32
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_paged(gen), check_flash(gen)]
    for r in rows:
        f = r["fault"]
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} "
              f"gate={r['gate']:.3g} (pass <= 1); planted fault "
              f"({r['fault_desc']}): max_abs={f['max_abs']:.3g} "
              f"gate={f['gate']:.3g} (rejected)", flush=True)
        print(f"kernel {r['name']}: ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) at "
              f"{r['shape']}", flush=True)
    torch.cuda.empty_cache()

    # 4. small input: kernels on the card against plain versions on the CPU
    diff, agree = small_input_check()
    print(f"small-input check: pool max diff {diff:.3g}, greedy tokens "
          f"equal {agree:.3f}", flush=True)

    # 5. main path
    t0 = time.perf_counter()
    eng = build_engine("llama31-8b", device="cuda", seed=0)
    ex = eng.ex
    n_params = sum(t.numel() for layer in ex.params["layers"]
                   for part in layer.values() for t in part.values())
    n_params += sum(ex.params[k].numel() for k in ("embed", "lm_head"))
    n_params += ex.params["final_norm"]["scale"].numel()
    print(f"main path: llama31-8b, {ex.cfg.num_layers} layers, d_model "
          f"{ex.cfg.d_model}, {n_params / 1e9:.2f} B parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    spec = ArrivalSpec(lam=4.0, n_requests=8, io_shape="chat", scale=1.0,
                       seed=0)
    paged_attention_kernel.launches = 0
    flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    reqs, meter = serve(eng, spec, price_per_hr=1.0,
                        log=lambda s: print(s, flush=True))
    wall = time.perf_counter() - t0
    launches = {"paged_attention": paged_attention_kernel.launches,
                "flash_attention": flash_attention_kernel.launches}
    L = ex.cfg.num_layers
    print(f"main path: {len(reqs)} requests in {wall:.1f} s wall, engine "
          f"clock {eng.t:.2f} s, {ex.n_prefill_calls} prefill calls, "
          f"{ex.n_decode_steps} decode steps, launches {launches}",
          flush=True)
    if not all(r.finish_time is not None for r in reqs):
        fail("not every request finished")
    want = sum(r.max_new_tokens for r in reqs)
    got = eng.metrics.get("repro:generation_tokens_total")
    if got != want:
        fail(f"generated {got} tokens, expected {want}")
    if launches["flash_attention"] != L * ex.n_prefill_calls or \
            launches["paged_attention"] != L * ex.n_decode_steps or \
            not ex.n_prefill_calls or not ex.n_decode_steps:
        fail(f"launch counts {launches} != {L} x ({ex.n_prefill_calls} "
             f"prefill calls, {ex.n_decode_steps} decode steps)")
    if not all(bool(torch.isfinite(p[n].float()).all())
               for p in (ex.pools[0], ex.pools[-1]) for n in ("k", "v")):
        fail("non-finite values in the KV pools")
    summ = meter.summary()
    print(f"main path: tokens {int(got)}, meter avg $/MTok at $1/hr "
          f"{summ['time_weighted_avg']:.4f}", flush=True)

    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    main()
