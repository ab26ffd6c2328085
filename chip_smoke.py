"""Drive the PyTorch port's live cost-metered server on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. device: the card's name, count, and `nvidia-smi` name and power limit;
  2. build: every kernel of `src/repro_torch/csrc/` with nvcc for sm_90a,
     one process each, in parallel; ptxas's register/shared-memory lines;
  3. kernels: each kernel against its plain PyTorch version at the served
     shapes of llama31-8b, qwen3-30b-a3b and jamba-v0.1-52b. The attention
     kernels in bf16 with |kernel - plain| <= 1e-3 + 2**-7 |plain| on every
     element (one bf16 step of the result; `repro_torch.kernels.bf16_gate`;
     flash also with the prefill's padding mask `kv_len`); the int8 matmul
     bit for bit; the selective scan's y and h_final in fp32 with
     |kernel - plain| <= 1e-5 + 1e-4 |plain| (`fp32_gate`) at the prefill
     (8, 512, 8192, 16) and decode (8, 1, 8192, 16) shapes. Each check
     must also reject a planted fault (the kernel run with the last page,
     the last key tile or the last 128-wide K tile dropped, the scan's
     decode step with h0 read as zeros, or its prefill without the last 32
     steps). Then the kernel, the plain version and the yardstick PyTorch
     call timed on the device (CUDA graphs of repeated calls, timed with
     CUDA events), each beside its bound; flash also at a served prefill
     call's kv_len, half the slots at 512 and half at 0;
  4. small-input checks: narrow models (llama31-8b in bf16 and in int8,
     qwen3-30b-a3b in bf16, 2 layers; jamba-v0.1-52b in bf16 and int8, 8
     layers) through the kernels on the card against the same models
     through the plain versions on the CPU;
  5. main paths: full-width models (random weights from a seed) through
     `build_engine` -> `Engine` -> `RealExecutor` -> `CostMeter`, each
     serving 8 chat requests (512:256, lambda 4/s, seed 0) that overlap:
     llama31-8b in bf16 and int8 (32 layers), qwen3-30b-a3b in bf16, int8
     and fp8 (48 layers), jamba-v0.1-52b in int8 and fp8 (32 layers: 4
     attention, 28 Mamba, 16 MoE). Every request must finish with its
     token count, the K/V pools and Mamba states must stay finite, and the
     kernels' launch counts, set to 0 before each path and read after it,
     must be one flash launch per attention layer per prefill call, one
     paged launch per attention layer per decode step, one scan launch per
     Mamba layer per call and, under int8, one int8 launch per `linear`
     per call (225 for llama31-8b, 193 for qwen3-30b-a3b, 177 for
     jamba-v0.1-52b).
Then a `kernels` JSON line, the `nvidia-smi` line, and as the last line
`{"ok": true, "device": {...}}`. Needs no network and imports no JAX.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12          # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor FLOP/s (data sheet)
INT8_PEAK = 1979e12       # H100 SXM dense int8 tensor OP/s (data sheet)
FP32_PEAK = 67e12         # H100 SXM fp32 FLOP/s outside the tensor cores
# exponentials: 16 a clock per SM in the special-function units, 132 SMs
# at the 1.98 GHz boost clock
EXP_RATE = 132 * 16 * 1.98e9
# served shapes: 8 slots of 512 + 256 tokens at page 16; head_dim 128 with
# llama31-8b's 32/8 heads and qwen3-30b-a3b's 32/4
B, HQ, D, PAGE, MAXP = 8, 32, 128, 16, 48
HKV = {"llama31-8b": 8, "qwen3-30b-a3b": 4}
# (M, K, N) of the int8 products on the main paths: 8 rows in decode and
# for the prefill lm_head, 8 x 512 for the other prefill projections
INT8_SHAPES = [
    (8, 4096, 14336, "llama31-8b decode gate/up"),
    (4096, 4096, 14336, "llama31-8b prefill gate/up"),
    (8, 14336, 4096, "llama31-8b decode down"),
    (8, 4096, 128256, "llama31-8b lm_head"),
    (8, 2048, 4096, "qwen3-30b-a3b decode wq"),
    (4096, 2048, 512, "qwen3-30b-a3b prefill wk/wv"),
    (8, 4096, 16384, "jamba-v0.1-52b decode in_proj"),
    (4096, 8192, 288, "jamba-v0.1-52b prefill x_proj"),
    (8, 256, 8192, "jamba-v0.1-52b decode dt_proj"),
]
# the selective scan at jamba-v0.1-52b's served shapes (B, S, d_inner, N):
# prefill of 8 slots at Lp 512 from a zero state, and a decode step
SSM_SHAPES = [(8, 512, 8192, 16, "prefill"), (8, 1, 8192, 16, "decode")]
MAIN_PATHS = [("llama31-8b", "bf16"), ("llama31-8b", "int8"),
              ("qwen3-30b-a3b", "bf16"), ("qwen3-30b-a3b", "int8"),
              ("qwen3-30b-a3b", "fp8"), ("jamba-v0.1-52b", "int8"),
              ("jamba-v0.1-52b", "fp8")]


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


def bound(nbytes: float, ops: float, peak: float = BF16_PEAK):
    t_bytes, t_ops = nbytes / MEM_BW * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def hold(name, pairs, faulty, fault_ref, gate_fn=None):
    """Gate each (kernel, plain) pair; then require that the gate rejects
    `faulty`, the kernel's output on inputs that drop a little of the work
    that `fault_ref` covers (no fault check where `faulty` is None). The
    gate is `bf16_gate` unless `gate_fn`."""
    from repro_torch.kernels import bf16_gate
    gate_fn = gate_fn or bf16_gate
    err = max(max_abs(o, r) for o, r in pairs)
    gate = max(gate_fn(o, r) for o, r in pairs)
    if not gate <= 1:
        fail(f"{name} disagrees with its plain version: max abs {err}, "
             f"gate {gate} > 1")
    if faulty is None:
        return err, gate, None
    fault = {"max_abs": max_abs(faulty, fault_ref),
             "gate": gate_fn(faulty, fault_ref)}
    if not fault["gate"] > 1:
        fail(f"{name}: the gate accepts a planted fault: {fault}")
    return err, gate, fault


def check_paged(gen, arch):
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    dev, hkv = "cuda", HKV[arch]
    P = B * MAXP + 1
    # ragged: empty, one token, exact page boundaries, the full 768
    lens = torch.tensor([0, 1, 16, 17, 256, 512, 700, 768], dtype=torch.int32,
                        device=dev)
    bt = (torch.randperm(P - 1, generator=gen, device=dev)[:B * MAXP] + 1) \
        .to(torch.int32).reshape(B, MAXP)
    q = torch.randn(B, HQ, D, generator=gen, device=dev).bfloat16()
    pools = [(torch.randn(P, PAGE, hkv, D, generator=gen, device=dev)
              .bfloat16(),
              torch.randn(P, PAGE, hkv, D, generator=gen, device=dev)
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
    err, gate, fault = hold(f"paged attention ({arch})", pairs,
                            paged_attention_kernel(q, kp, vp, bt, short),
                            pairs[1][1])
    args = [(q, kp, vp, bt, lens) for kp, vp in pools]
    n_tok = int(lens.sum())
    nbytes = (2 * n_tok * hkv * D * 2 + 2 * q.numel() * 2 + bt.numel() * 4
              + lens.numel() * 4)
    flops = 4 * n_tok * HQ * D
    b_ms, b_by = bound(nbytes, flops)
    return {
        "max_abs_err": err, "gate": gate, "fault": fault,
        "fault_desc": "the 768-token row's last page dropped",
        "ms": device_ms(paged_attention_kernel, args),
        "plain_ms": device_ms(paged_attention_ref, args),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"{arch}: B={B} Hq={HQ} Hkv={hkv} D={D} page={PAGE} "
                 f"max_pages={MAXP} seq_lens={lens.tolist()}",
    }


def check_flash(gen, arch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    dev, hkv = "cuda", HKV[arch]
    pairs = []
    sets = {}
    for L in (512, 576):   # 576: a multiple of 64, not of 128
        sets[L] = [tuple(torch.randn(B, L, h, D, generator=gen, device=dev)
                         .bfloat16() for h in (HQ, hkv, hkv))
                   for _ in range(2)]
        for q, k, v in sets[L]:
            out = flash_attention_kernel(q, k, v, causal=True)
            torch.cuda.synchronize()
            pairs.append((out, flash_attention_ref(q, k, v, causal=True)))
    # the prefill's padding mask: ragged prompt lengths, and 0 for a slot
    # that does not prefill (the mean of V over all keys)
    kv_len = torch.tensor([512, 0, 1, 63, 64, 300, 511, 37],
                          dtype=torch.int32, device=dev)
    q, k, v = sets[512][1]
    out = flash_attention_kernel(q, k, v, causal=True, kv_len=kv_len)
    torch.cuda.synchronize()
    pairs.append((out, flash_attention_ref(q, k, v, causal=True,
                                           kv_len=kv_len)))
    L = 512                # the served prompt length, chat 512:256
    # planted fault: the last 64-key tile dropped, as a tile count off by
    # one would give; it changes only the last 64 query rows
    q, k, v = sets[L][0]
    err, gate, fault = hold(
        f"flash attention ({arch})", pairs,
        flash_attention_kernel(q, k[:, :-64].contiguous(),
                               v[:, :-64].contiguous(), causal=True),
        pairs[0][1])
    args = sets[L]
    lib_args = [tuple(t.transpose(1, 2).contiguous() for t in a)
                for a in args]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    nbytes = 2 * (2 * B * L * HQ * D + 2 * B * L * hkv * D)
    flops = 4 * B * HQ * L * L * D / 2
    b_ms, b_by = bound(nbytes, flops)
    # what a served prefill call passes: the slots that prefill have their
    # prompt (here all 512 tokens), the others kv_len 0 (the mean of V);
    # the least work is q, K and the causal product for the prefilling
    # slots, V and the output for all
    n_pre = B // 2
    mix = torch.tensor([L] * n_pre + [0] * (B - n_pre), dtype=torch.int32,
                       device=dev)
    mix_bytes = 2 * (n_pre * L * HQ * D + B * L * HQ * D + n_pre * L * hkv * D
                     + B * L * hkv * D) + 4 * B
    mix_b_ms, mix_b_by = bound(mix_bytes, 4 * n_pre * HQ * L * L * D / 2)
    return {
        "max_abs_err": err, "gate": gate, "fault": fault,
        "fault_desc": "the last 64-key tile of Lp 512 dropped",
        "ms": device_ms(lambda q, k, v: flash_attention_kernel(
            q, k, v, causal=True), args),
        "plain_ms": device_ms(lambda q, k, v: flash_attention_ref(
            q, k, v, causal=True), args, per_graph=4),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(sdpa, lib_args),
        "served_mix": {
            "kv_len": mix.tolist(),
            "ms": device_ms(lambda q, k, v: flash_attention_kernel(
                q, k, v, causal=True, kv_len=mix), args),
            "bound_ms": mix_b_ms, "bound_by": mix_b_by},
        "shape": f"{arch}: B={B} Sq=Sk={L} Hq={HQ} Hkv={hkv} D={D} causal "
                 f"(checked also at Sq=Sk=576 and with kv_len "
                 f"{kv_len.tolist()})",
    }


def ssm_inputs(gen, Bsz, S, di, N, with_h0):
    """Unit-normal u, B, C, D and h0, dt = softplus(unit normal) and the
    model's A = -(1..N) per channel, all fp32 on the card."""
    import torch.nn.functional as F
    dev = "cuda"
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev) \
        .expand(di, N).contiguous()
    return (r(Bsz, S, di), F.softplus(r(Bsz, S, di)), r(Bsz, S, N),
            r(Bsz, S, N), A, r(di), r(Bsz, di, N) if with_h0 else None)


def check_ssm(gen):
    """The selective scan against its plain version at jamba-v0.1-52b's
    served prefill and decode shapes, y and h_final each through
    `fp32_gate`; a planted fault must fail it: at decode the step run with
    h0 read as zeros, as a scan that drops the carried state would; at
    prefill h_final of the scan run without its last 32 steps, as one
    that drops the last chunk of staged time steps would.
    Timed at both shapes; the plain version at prefill is a 512-step
    Python loop, captured whole in the CUDA graph like any other call."""
    from repro_torch.kernels import fp32_gate
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_kernel
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    variants = []
    for Bsz, S, di, N, what in SSM_SHAPES:
        decode = what == "decode"
        sets = [ssm_inputs(gen, Bsz, S, di, N, decode) for _ in range(2)]
        pairs = []
        for args in sets:
            y, h = ssm_scan_kernel(*args)
            torch.cuda.synchronize()
            yr, hr = ssm_scan_ref(*args)
            pairs += [(y, yr), (h, hr)]
        if decode:      # y of the step with the carried state dropped
            faulty, fault_ref = ssm_scan_kernel(*sets[0][:-1], None)[0], \
                pairs[0][1]
        else:           # h_final with the last 32-step chunk dropped
            u, dt, Bm, Cm = (t[:, :-32].contiguous() for t in sets[0][:4])
            faulty, fault_ref = ssm_scan_kernel(u, dt, Bm, Cm,
                                                *sets[0][4:])[1], pairs[1][1]
        err, gate, fault = hold(f"ssm_scan ({what})", pairs, faulty,
                                fault_ref, gate_fn=fp32_gate)
        # u, dt and y once each; B and C; A and D; h0 where read, h_final
        elems = Bsz * S * di
        nbytes = 4 * (3 * elems + 2 * Bsz * S * N + di * N + di
                      + Bsz * di * N * (2 if decode else 1))
        flops = elems * (6 * N + 3)
        terms = {"bytes": nbytes / MEM_BW * 1e3,
                 "fp32 operations": flops / FP32_PEAK * 1e3,
                 "exponentials": elems * N / EXP_RATE * 1e3}
        term = max(terms, key=terms.get)
        variants.append({
            "max_abs_err": err, "gate": gate, "fault": fault,
            "fault_desc": ("the decode step run with h0 read as zeros"
                           if decode else "h_final of the prefill run "
                           "without its last 32 steps"),
            "ms": device_ms(ssm_scan_kernel, sets),
            "plain_ms": device_ms(ssm_scan_ref, sets,
                                  per_graph=2 if S > 1 else 20,
                                  replays=3 if S > 1 else 5),
            "bound_ms": terms[term],
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_terms_ms": terms,
            "library_ms": None,
            "library_note": "none: no single PyTorch call computes a "
                            "selective scan",
            "shape": f"jamba-v0.1-52b {what}: B={Bsz} S={S} d_inner={di} "
                     f"N={N}" + (", random h0" if decode else ", h0 zero"),
        })
        del sets, pairs
        torch.cuda.empty_cache()
    return variants


def int_mm(x, w, xs, ws):
    """The yardstick: `torch._int_mm` followed by the same scaling."""
    return torch._int_mm(x, w).float() * (xs * ws)


def int_mm_rows(x):
    """cuBLASLt's int8 GEMM refuses M <= 16: x padded with zero rows to
    M = 17, the smallest it takes."""
    M = x.shape[0]
    return x if M > 16 else torch.cat([x, x.new_zeros(17 - M, x.shape[1])])


def check_int8(gen):
    """The int8 kernel bit for bit against its plain version at every
    served shape; a planted fault (the last 128-wide K tile dropped) must
    break the equality. Timed at every shape."""
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_kernel
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    dev = "cuda"
    variants = []
    for M, K, N, what in INT8_SHAPES:
        # enough weight sets that cycling over them overflows the 50 MB L2,
        # as a decode step's weights, each read once, do
        n_sets = max(2, min(6, -(-120_000_000 // (K * N))))
        sets = []
        for _ in range(n_sets):
            sets.append((
                torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8),
                torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                              dtype=torch.int8),
                torch.rand(1, generator=gen, device=dev) * 0.02 + 1e-3,
                torch.rand(1, N, generator=gen, device=dev) * 0.02 + 1e-3))
        x, w, xs, ws = sets[0]
        out = int8_matmul_kernel(x, w, xs, ws)
        torch.cuda.synchronize()
        ref = int8_matmul_ref(x, w, xs, ws)
        if not torch.equal(out, ref):
            fail(f"int8 matmul at {(M, K, N)} is not bit-exact: "
                 f"{int((out != ref).sum())} elements differ, max abs "
                 f"{max_abs(out, ref)}")
        faulty = int8_matmul_kernel(x[:, :-128].contiguous(), w[:-128], xs, ws)
        n_bad = int((faulty != ref).sum())
        if n_bad == 0:
            fail(f"int8 matmul at {(M, K, N)}: the exact check accepts the "
                 "planted fault")
        nbytes = M * K + K * N + 4 + 4 * N + 4 * M * N
        b_ms, b_by = bound(nbytes, 2 * M * N * K, INT8_PEAK)
        del out, ref, faulty
        variants.append({
            "max_abs_err": 0.0, "fault": {
                "elements_differing": n_bad, "of": M * N},
            "fault_desc": "the last 128-wide K tile dropped",
            "ms": device_ms(int8_matmul_kernel, sets),
            "plain_ms": device_ms(int8_matmul_ref, sets, per_graph=2),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(int_mm, [(int_mm_rows(a[0]),) + a[1:]
                                             for a in sets]),
            "library_note": "torch._int_mm + scaling" + (
                "" if M > 16 else f", x padded from M={M} to M=17"),
            "shape": f"{what}: M={M} K={K} N={N}",
        })
        del sets
        torch.cuda.empty_cache()
    return variants


def small_input_check(arch="llama31-8b", quant="bf16"):
    """A narrow model at head_dim 128 (2 layers; jamba-v0.1-52b 8: 7 Mamba
    layers, d_state 4, and one attention layer) through the kernels on the
    card and through the plain versions on the CPU, on the same weights
    (quantized on the CPU, then moved) and tokens.

    In bf16, and in int8 without Mamba layers: K/V pools within 0.02 (five
    bf16 steps at |K| < 1) and at least 90% of greedy tokens equal (a flip
    needs a near-tie of two logits); jamba's Mamba states too, each within
    5% of its layer's largest magnitude (conv holds bf16 activations, one
    step 2**-8 of the largest; h inherits a few such steps through u, dt,
    B and C). A decode step that drops the carried h or conv state moves
    them by far more.

    jamba in int8: its bf16 MoE GEMMs round differently on the two
    devices, each `linear`'s per-tensor activation quantization turns such
    a difference into a flipped int8 step (1/127 of the tensor's largest
    value), and a router near-tie sends a token elsewhere; on the CPU,
    nudging 1-100% of one side's MoE outputs by one bf16 step left 96-99%
    of K/V and 93-97% of conv elements within 0.02, and 85-96% of tokens
    equal (on the card: 99.2%, 92.3% and 92.6%, with 99.3% of h). So, by
    shares: at least 90% of K/V and 85% of conv elements within 0.02, 98%
    of h elements within 5% of the layer's largest |h|, and 80% of greedy
    tokens equal. A decode step that drops the carried h leaves 90-92% of
    h; one that drops the conv state 35% of conv, 67% of h and 59% of
    tokens."""
    import numpy as np
    from repro_torch.configs import reduced
    from repro_torch.models import init_params
    from repro_torch.quant import BY_NAME
    from repro_torch.serving import runner
    cfg = reduced(arch, d_model=512, ff=1024, vocab=1024)
    params = init_params(cfg, device="cpu", quant=quant,
                         generator=torch.Generator().manual_seed(1))
    sides = {dev: dict(params=_tree_map(lambda t: t.to(dev), params),
                       pools=runner.init_pools(cfg, 33, PAGE, 4, device=dev),
                       seq=torch.zeros(4, dtype=torch.int32, device=dev))
             for dev in ("cpu", "cuda")}
    pre, dec = runner.make_step_fns(cfg, PAGE, qcfg=BY_NAME[quant])
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
    pools = list(zip(sides["cpu"]["pools"], sides["cuda"]["pools"]))
    diff = max(float((a[n][1:].float() -
                      b[n][1:].float().cpu()).abs().max())
               for a, b in pools if "k" in a for n in ("k", "v"))
    # the share of elements within a bound: 0.02 for the bf16 activations
    # (K/V past the trash page, conv), 5% of the layer's largest |h| for h;
    # and the Mamba states' largest difference over the layer's largest
    # magnitude, in the worst layer
    counts = {"k": [0, 0], "conv": [0, 0], "h": [0, 0]}
    rel = {"conv": 0.0, "h": 0.0}
    for a, b in pools:
        for n, x in a.items():
            x, y = x.float(), b[n].float().cpu()
            if n in ("k", "v"):
                x, y = x[1:], y[1:]
            top = max(float(x.abs().max()), 1e-30)
            if n in rel:
                rel[n] = max(rel[n], float((x - y).abs().max()) / top)
            tol = 0.05 * top if n == "h" else 0.02
            c = counts["k" if n == "v" else n]
            c[0] += int(((x - y).abs() <= tol).sum())
            c[1] += x.numel()
    share = {n: ok / tot if tot else 1.0 for n, (ok, tot) in counts.items()}
    agree = float(np.mean(np.concatenate(
        [x == y for x, y in zip(streams["cpu"], streams["cuda"])])))
    if cfg.ssm is not None and quant == "int8":
        ok = (share["k"] >= 0.9 and share["conv"] >= 0.85
              and share["h"] >= 0.98 and agree >= 0.8)
    else:
        ok = (diff <= 0.02 and rel["conv"] <= 0.05 and rel["h"] <= 0.05
              and agree >= 0.9)
    if not ok:
        fail(f"small-input check {arch} {quant}: K/V max diff {diff}, "
             f"Mamba states' max diff over their largest {rel}, shares "
             f"within bounds {share}, token agreement {agree}")
    return diff, rel, share, agree


def layer_counts(cfg):
    """Layers of the whole stack by kind, from `unit_pattern` (the first
    U layers) times the R repeats: attention, Mamba, dense MLP, MoE."""
    from repro_torch.models.model import unit_pattern, unit_size
    R = cfg.num_layers // unit_size(cfg)
    n = {"attn": 0, "mamba": 0, "mlp": 0, "moe": 0}
    for kind, is_moe in unit_pattern(cfg):
        n[kind] += R
        if is_moe:
            n["moe"] += R
        elif cfg.d_ff:
            n["mlp"] += R
    return n


def int8_launches_per_call(cfg) -> int:
    """`linear` calls of one prefill call or decode step: four projections
    per attention layer (wq, wk, wv, wo) and per Mamba layer (in_proj,
    x_proj, dt_proj, out_proj), the dense MLPs' projections (the MoE
    experts dequantize and never reach the kernel), and the lm_head."""
    n = layer_counts(cfg)
    mlp = 3 if cfg.mlp_kind == "swiglu" else 2
    return 4 * (n["attn"] + n["mamba"]) + mlp * n["mlp"] + 1


def main_path(arch, quant, kernels):
    """Serve 8 chat requests on the full-width `arch` in `quant`; returns
    the path's readings and its kernels' launch counts."""
    import numpy as np
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.serving import ArrivalSpec
    t0 = time.perf_counter()
    eng = build_engine(arch, device="cuda", seed=0, quant=quant)
    torch.cuda.synchronize()          # the weights are drawn on the card
    ex = eng.ex
    n_params = _n_weights(ex.params)
    print(f"main path {arch} {quant}: {ex.cfg.num_layers} layers "
          f"{layer_counts(ex.cfg)}, d_model "
          f"{ex.cfg.d_model}, {n_params / 1e9:.2f} B weights, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    spec = ArrivalSpec(lam=4.0, n_requests=8, io_shape="chat", scale=1.0,
                       seed=0)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    reqs, meter = serve(eng, spec, price_per_hr=1.0,
                        log=lambda s: print(s, flush=True))
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    n, calls = layer_counts(ex.cfg), (ex.n_prefill_calls, ex.n_decode_steps)
    print(f"main path {arch} {quant}: {len(reqs)} requests in {wall:.1f} s "
          f"wall, engine clock {eng.t:.2f} s, {calls[0]} prefill calls, "
          f"{calls[1]} decode steps, launches {launches}", flush=True)
    if not all(r.finish_time is not None for r in reqs):
        fail(f"{arch} {quant}: not every request finished")
    want = sum(r.max_new_tokens for r in reqs)
    got = eng.metrics.get("repro:generation_tokens_total")
    if got != want:
        fail(f"{arch} {quant}: generated {got} tokens, expected {want}")
    expect = {"flash_attention": n["attn"] * calls[0],
              "paged_attention": n["attn"] * calls[1],
              "int8_matmul": (int8_launches_per_call(ex.cfg) * sum(calls)
                              if quant == "int8" else 0),
              "ssm_scan": n["mamba"] * sum(calls)}
    if launches != expect or not all(calls):
        fail(f"{arch} {quant}: launch counts {launches} != {expect} "
             f"({calls[0]} prefill calls, {calls[1]} decode steps)")
    if not all(bool(torch.isfinite(t.float()).all())
               for p in ex.pools for t in p.values()):
        fail(f"{arch} {quant}: non-finite values in the KV pools or the "
             "Mamba states")
    out = {
        "arch": arch, "quant": quant, "requests": len(reqs),
        "finished": sum(r.finish_time is not None for r in reqs),
        "output_tokens": int(got), "prefill_calls": calls[0],
        "decode_steps": calls[1], "engine_clock_s": eng.t,
        "tokens_per_s": got / eng.t,
        "ttft_p50_ms": 1e3 * float(np.median([r.ttft for r in reqs])),
        "usd_per_mtok_at_1usd_hr": meter.summary()["time_weighted_avg"],
        "launches": launches, "wall_s": wall,
    }
    print(f"main path {arch} {quant}: tokens {out['output_tokens']}, "
          f"tokens/s {out['tokens_per_s']:.1f}, TTFT p50 "
          f"{out['ttft_p50_ms']:.1f} ms, meter avg $/MTok at $1/hr "
          f"{out['usd_per_mtok_at_1usd_hr']:.4f}", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_kernel
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_kernel
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_kernel
    from repro_torch.serving import runner
    start = time.perf_counter()

    def phase(name):
        print(f"-- {name} at {time.perf_counter() - start:.1f} s",
              flush=True)

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    print(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    phase("build")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions, then timed
    phase("kernels")
    runner.set_matmul_precision()     # the plain versions' einsums in fp32
    gen = torch.Generator(device="cuda").manual_seed(0)
    meta = {
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention/kernel.py:71"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:76"),
        "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                        "src/repro/kernels/int8_matmul/kernel.py:43"),
        "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:55"),
    }
    variants = {
        "paged_attention": [check_paged(gen, a) for a in HKV],
        "flash_attention": [check_flash(gen, a) for a in HKV],
        "int8_matmul": check_int8(gen),
        "ssm_scan": check_ssm(gen),
    }
    for name, vs in variants.items():
        for v in vs:
            f = v["fault"]
            gate = (f"gate={v['gate']:.3g} (pass <= 1)" if "gate" in v
                    else "bit-exact")
            fault = (f"planted fault ({v['fault_desc']}): {f} (rejected)"
                     if f is not None else "no planted fault at this shape")
            print(f"kernel {name} [{v['shape']}]: max_abs_err="
                  f"{v['max_abs_err']:.3g} {gate}; {fault}", flush=True)
            print(f"kernel {name} [{v['shape']}]: ms={v['ms']:.4f} "
                  f"plain_ms={v['plain_ms']:.4f} library_ms="
                  f"{v['library_ms']} bound_ms={v['bound_ms']:.4f} "
                  f"({v.get('bound_term', v['bound_by'])}) "
                  f"{v.get('library_note', '')}", flush=True)
            if "served_mix" in v:
                m = v["served_mix"]
                print(f"kernel {name} [{v['shape']}]: at the served mix "
                      f"kv_len={m['kv_len']}: ms={m['ms']:.4f} bound_ms="
                      f"{m['bound_ms']:.4f} ({m['bound_by']})", flush=True)
    torch.cuda.empty_cache()

    # 4. small inputs: kernels on the card against plain versions on the CPU
    phase("small-input checks")
    for arch, quant in (("llama31-8b", "bf16"), ("llama31-8b", "int8"),
                        ("qwen3-30b-a3b", "bf16"), ("jamba-v0.1-52b", "bf16"),
                        ("jamba-v0.1-52b", "int8")):
        diff, rel, share, agree = small_input_check(arch, quant)
        print(f"small-input check {arch} {quant}: K/V max diff {diff:.3g}; "
              f"Mamba states' max diff over their largest: conv "
              f"{rel['conv']:.4g}, h {rel['h']:.4g}; "
              f"shares within bounds: K/V {share['k']:.5f}, conv "
              f"{share['conv']:.5f}, h {share['h']:.5f}; greedy tokens "
              f"equal {agree:.3f}", flush=True)

    # 5. main paths, one engine on the card at a time
    kernels = {"paged_attention": paged_attention_kernel,
               "flash_attention": flash_attention_kernel,
               "int8_matmul": int8_matmul_kernel,
               "ssm_scan": ssm_scan_kernel}
    paths = []
    for arch, quant in MAIN_PATHS:
        phase(f"main path {arch} {quant}")
        paths.append(main_path(arch, quant, kernels))
        gc.collect()
        torch.cuda.empty_cache()
    phase("done")
    print(json.dumps({"main_paths": paths}))

    rows = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name, vs in variants.items():
        by_path = {f"{p['arch']} {p['quant']}": p["launches"][name]
                   for p in paths}
        row = {"name": name, "route": "cuda", "source": meta[name][0],
               "replaces": meta[name][1],
               "launches": sum(by_path.values()),
               "max_abs_err": max(v["max_abs_err"] for v in vs)}
        row.update({k: vs[0][k] for k in keys[1:]})   # the first variant
        row["launches_by_path"] = by_path
        row["variants"] = [{k: v[k] for k in ("shape",) + keys
                            + ("bound_term", "bound_terms_ms", "served_mix")
                            if k in v}
                           for v in vs]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


def _n_weights(tree) -> int:
    """Parameters of a tree, a quantized weight counted once (not its
    scales)."""
    if isinstance(tree, dict):
        if "q" in tree:
            return tree["q"].numel()
        return sum(_n_weights(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_weights(v) for v in tree)
    return tree.numel()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    main()
