"""Why flash attention feeds P to the tensor cores as three bf16 terms,
and what the kernel's parts cost: on one card, or (--cpu) in emulation.

    python3 scripts/flash_variants.py          # on the card
    python3 scripts/flash_variants.py --cpu    # the emulation, CPU only

On the card: builds `src/repro_torch/csrc/flash_attention.cu` as it is
and variants of it made by editing its source (P as 1 or 2 bf16 terms
instead of 3; 4 K/V stages instead of 2) into `build/flash_variants/`,
prints ptxas's spill line for each, and times each (`chip_smoke.device_ms`:
CUDA graphs of repeated calls) at the served prefill shape (B 8, Sq = Sk
512, Hq 32, Hkv 8 and 4, causal) beside its gate against the plain
version, in turns (variants, then the same in reverse). The kernel as it
is also runs with the served mix's `kv_len` (4 slots of 512, 4 of 0),
with the idle slots at 1 key instead of 0, and on the 4 busy slots alone.

With --cpu: the plain version with P rounded to n bf16 terms (n = 1, 2,
3; each term the rounded remainder of the ones before) held to
`bf16_gate` at the served shapes, and `chip_smoke.py`'s small-input
check run on the CPU with that attention on one side and the plain
version on the other (llama31-8b in int8 and bf16, qwen3-30b-a3b in
bf16). Prints one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from repro_torch.kernels import bf16_gate  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, flash_attention_ref)

PV_LOOP = "for (int n = 0; n < 3; ++n)\n        hopper::wgmma_m64n128k16_rs"
STAGES = "constexpr int STAGES = 2;"


def variants():
    """{name: source}: the kernel as it is and its edited variants."""
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert PV_LOOP in src and STAGES in src, "the kernel's source moved"
    return {"as is (3 terms, 2 stages)": src,
            "P as 1 term": src.replace(PV_LOOP,
                                       PV_LOOP.replace("< 3", "< 1")),
            "P as 2 terms": src.replace(PV_LOOP,
                                        PV_LOOP.replace("< 3", "< 2")),
            "4 stages": src.replace(STAGES, STAGES.replace("2", "4"))}


def build_variants():
    from repro_torch.kernels import build
    out = os.path.join(ROOT, "build", "flash_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(variants().items()):
        cu = os.path.join(out, f"v{i}.cu")
        so = os.path.join(out, f"libv{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs, spills = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        spills[name] = [line.strip() for line in log.splitlines()
                        if "spill" in line or "Used" in line]
        lib = ctypes.CDLL(so)
        lib.flash_attention_bf16.restype = ctypes.c_int
        lib.flash_attention_bf16.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        libs[name] = lib
    return libs, spills


def call(lib, q, k, v, kv_len=None):
    o = torch.empty_like(q)
    B, Sq, Hq, D = q.shape
    err = lib.flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        0 if kv_len is None else kv_len.data_ptr(), o.data_ptr(), B, Sq,
        k.shape[1], Hq, k.shape[2], D, 1,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bf16: CUDA error {err}")
    return o


def on_card():
    import chip_smoke
    from repro_torch.serving import runner
    if not torch.cuda.is_available():
        sys.exit("flash_variants: no CUDA device (use --cpu)")
    runner.set_matmul_precision()
    libs, spills = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": chip_smoke.smi_line(), "ptxas": spills, "runs": {}}
    B, L = 8, 512
    for hkv in (8, 4):
        sets = [tuple(torch.randn(B, L, h, 128, generator=gen, device="cuda")
                      .bfloat16() for h in (32, hkv, hkv)) for _ in range(2)]
        q, k, v = sets[0]
        ref = flash_attention_ref(q, k, v, causal=True)
        runs = {}
        for name in list(libs) + list(libs)[::-1]:      # in turns
            lib = libs[name]
            runs.setdefault(name, {"gate": bf16_gate(call(lib, q, k, v), ref),
                                   "ms": []})["ms"].append(
                chip_smoke.device_ms(lambda *a: call(lib, *a), sets))
        lib = libs["as is (3 terms, 2 stages)"]
        mix0, mix1 = (torch.tensor([L] * 4 + [idle] * 4, dtype=torch.int32,
                                   device="cuda") for idle in (0, 1))
        busy = [tuple(t[:4].contiguous() for t in a) for a in sets]
        runs["as is, served mix (4 x 512, 4 x 0)"] = chip_smoke.device_ms(
            lambda *a: call(lib, *a, mix0), sets)
        runs["as is, idle slots at 1 key"] = chip_smoke.device_ms(
            lambda *a: call(lib, *a, mix1), sets)
        runs["as is, the 4 busy slots alone"] = chip_smoke.device_ms(
            lambda *a: call(lib, *a), busy)
        out["runs"][f"B 8, Sq = Sk 512, Hq 32, Hkv {hkv}"] = runs
        for name, r in runs.items():
            print(f"Hkv {hkv}: {name}: {r}", flush=True)
    print(json.dumps(out))


def attention_in_terms(n_terms):
    """The plain version with P rounded to `n_terms` bf16 terms before
    P V, the row sums from fp32 P (as the kernel does)."""
    def attention(q, k, v, *, causal=True, kv_len=None):
        B, Sq, Hq, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / D ** 0.5
        cols = torch.arange(Sk)
        valid = (cols[None, :] <= torch.arange(Sq)[:, None] if causal
                 else torch.ones(Sq, Sk, dtype=torch.bool))[None, None, None]
        if kv_len is not None:
            valid = valid & (cols < kv_len[:, None])[:, None, None, None, :]
        s = torch.where(valid, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        rest, terms = p, torch.zeros_like(p)
        for _ in range(n_terms):
            t = rest.bfloat16().float()
            terms, rest = terms + t, rest - t
        o = torch.einsum("bhgqk,bkhd->bhgqd", terms, v.float()) / \
            p.sum(-1, keepdim=True)
        return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    return attention


def small_input_kv_diff(arch, quant, attention):
    """`chip_smoke.small_input_check`'s schedule on the CPU, once with the
    plain version and once with `attention`: the K/V pools' largest
    difference and the share of greedy tokens equal."""
    from repro_torch.configs import reduced
    from repro_torch.models import init_params
    from repro_torch.quant import BY_NAME
    from repro_torch.serving import runner
    cfg = reduced(arch, d_model=512, ff=1024, vocab=1024)
    params = init_params(cfg, device="cpu", quant=quant,
                         generator=torch.Generator().manual_seed(1))
    pre, dec = runner.make_step_fns(cfg, 16, qcfg=BY_NAME[quant])
    rng = np.random.default_rng(0)
    lens = np.array([37, 0, 128, 5], np.int32)
    tokens = np.zeros((4, 128), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(0, 1000, n)
    bt = np.arange(1, 33, dtype=np.int32).reshape(4, 8)
    active = lens > 0
    sides = {s: dict(pools=runner.init_pools(cfg, 33, 16, 4, device="cpu"),
                     seq=torch.zeros(4, dtype=torch.int32))
             for s in ("plain", "terms")}
    cur, streams = np.zeros(4, np.int32), {}
    t = torch.from_numpy
    saved = runner.flash_attention
    try:
        for step in range(9):
            for side, s in sides.items():
                runner.flash_attention = (flash_attention_ref if side ==
                                          "plain" else attention)
                if step == 0:
                    out, s["seq"] = pre(params, s["pools"], t(bt), s["seq"],
                                        t(tokens), t(lens), t(active))
                else:
                    out, s["seq"] = dec(params, s["pools"], t(bt), s["seq"],
                                        t(cur), t(active))
                streams.setdefault(side, []).append(out.numpy()[active])
            cur[active] = streams["plain"][-1]
    finally:
        runner.flash_attention = saved
    diff = max(float((a[n][1:].float() - b[n][1:].float()).abs().max())
               for a, b in zip(sides["plain"]["pools"],
                               sides["terms"]["pools"])
               if "k" in a for n in ("k", "v"))
    agree = float(np.mean(np.concatenate(
        [x == y for x, y in zip(streams["plain"], streams["terms"])])))
    return diff, agree


def on_cpu():
    torch.manual_seed(0)
    out = {"device": "cpu (emulation)", "gate": {}, "small_input": {}}
    for hkv in (8, 4):
        for L in (512, 576):
            q = torch.randn(8, L, 32, 128).bfloat16()
            k, v = (torch.randn(8, L, hkv, 128).bfloat16() for _ in range(2))
            ref = flash_attention_ref(q, k, v)
            for n in (1, 2, 3):
                g = bf16_gate(attention_in_terms(n)(q, k, v), ref)
                out["gate"][f"Hkv {hkv}, Sq = Sk {L}, {n} terms"] = g
                print(f"gate, Hkv {hkv}, L {L}, {n} terms: {g:.4f}",
                      flush=True)
    for arch, quant in (("llama31-8b", "int8"), ("llama31-8b", "bf16"),
                        ("qwen3-30b-a3b", "bf16")):
        for n in (1, 2, 3):
            diff, agree = small_input_kv_diff(arch, quant,
                                              attention_in_terms(n))
            out["small_input"][f"{arch} {quant}, {n} terms"] = {
                "kv_max_diff": diff, "tokens_equal": agree}
            print(f"small input {arch} {quant}, {n} terms: K/V max diff "
                  f"{diff}, tokens equal {agree:.3f}", flush=True)
    print(json.dumps(out))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="the emulation on the CPU, not the card")
    args = ap.parse_args(argv)
    on_cpu() if args.cpu else on_card()


if __name__ == "__main__":
    main()
