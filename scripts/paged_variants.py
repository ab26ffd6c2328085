"""What the paged-attention kernel's design choices are worth, and how it
compares with an earlier version of itself, on one card.

    python3 scripts/paged_variants.py [--baseline FILE]

Builds `src/repro_torch/csrc/paged_attention.cu` as it is and variants of
it made by editing its source (no split: one block per (sequence, KV
head); at most 4 blocks a cluster; a ring of 2 or 3 tiles instead of 4;
registers for 4 blocks an SM instead of 5; and, for timing only, one that
skips every tile, which leaves the launch, the cluster and the combine)
into `build/paged_variants/`, and `--baseline`, an earlier
`paged_attention.cu` with the same C entry point (for example the parent
commit's, from `git show`). Prints ptxas's register and spill lines, the
SASS counts of each and, for the builds of the kernel's own source, how
many of the served launch's clusters fit the card at once. Then, for
llama31-8b's and qwen3-30b-a3b's KV heads, at `chip_smoke.check_paged`'s
lengths and at a served decode step with and without idle slots, holds
each build to the plain version (`bf16_gate`; an earlier kernel that
gives a seq_len-0 row 0 is held on the other rows only) and times it
(`chip_smoke.device_ms`) in turns: every build, then the same in
reverse. Prints one JSON object, with every number, as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke  # noqa: E402

EDITS = {
    "no split": ("while (split * 2", "while (false && split * 2"),
    "split <= 4": ("constexpr int MAX_SPLIT = 8;",
                   "constexpr int MAX_SPLIT = 4;"),
    "2 tiles in the ring": ("constexpr int NS = 4;", "constexpr int NS = 2;"),
    "3 tiles in the ring": ("constexpr int NS = 4;", "constexpr int NS = 3;"),
    "4 blocks an SM": ("__launch_bounds__(THREADS, 5)",
                       "__launch_bounds__(THREADS, 4)"),
    # timing only, wrong by design: every block skips its tiles, so what
    # is left is the launch, the cluster's barriers and the combine
    "no tiles (timing only)": (
        "const int cnt = max(0, min(sh.per, (len + TK - 1) / TK - t0));",
        "const int cnt = 0;"),
}

# appended to each build of the kernel's own source: how many clusters of
# the served launch fit the card at once (cudaOccupancyMaxActiveClusters)
CLUSTERS = r"""
extern "C" int paged_attention_max_clusters(int G, int B, int Hkv,
                                            int split) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, Hkv, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e =
      G == 4 ? cudaOccupancyMaxActiveClusters(&n, paged_attention_kernel<4>,
                                              &cfg)
             : cudaOccupancyMaxActiveClusters(&n, paged_attention_kernel<8>,
                                              &cfg);
  return e ? -(int)e : n;
}
"""


def sources(baseline):
    from repro_torch.kernels import build
    src = (build.CSRC / "paged_attention.cu").read_text()
    out = {"as is": src + CLUSTERS}
    for name, (old, new) in EDITS.items():
        assert old in src, f"the kernel's source moved: {old!r}"
        out[name] = src.replace(old, new) + CLUSTERS
    if baseline:
        with open(baseline) as f:
            out["baseline"] = f.read()
    return out


def build_all(srcs):
    from repro_torch.kernels import build
    out = os.path.join(ROOT, "build", "paged_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        cu = os.path.join(out, f"v{i}.cu")
        so = os.path.join(out, f"libv{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs, ptxas, sass, clusters = {}, {}, {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if "spill" in line or "Used" in line]
        sass[name] = chip_smoke.sass_counts(so)
        lib = ctypes.CDLL(so)
        lib.paged_attention_bf16.restype = ctypes.c_int
        lib.paged_attention_bf16.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        if hasattr(lib, "paged_attention_max_clusters"):
            f = lib.paged_attention_max_clusters
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_int] * 4
            # the served launches: B 8, 8 splits; Hkv 8 (G 4), 4 (G 8)
            clusters[name] = {"G 4": f(4, 8, 8, 8), "G 8": f(8, 8, 4, 8)}
        libs[name] = lib
    return libs, ptxas, sass, clusters


def caller(lib):
    def fn(q, kp, vp, bt, lens):
        B, Hq, D = q.shape
        _, page, Hkv, _ = kp.shape
        out = torch.empty_like(q)
        err = lib.paged_attention_bf16(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
            lens.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, page,
            bt.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an earlier paged_attention.cu with "
                    "the same C entry point")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("paged_variants: no CUDA device; this script runs on the "
                 "card")
    from repro_torch.kernels import bf16_gate
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    srcs = sources(args.baseline)
    libs, ptxas, sass, clusters = build_all(srcs)
    for name in libs:
        for line in ptxas[name]:
            print(f"ptxas {name}: {line}")
        print(f"SASS {name}: {sass[name]}")
        if name in clusters:
            print(f"clusters of the served launch that fit at once, "
                  f"{name}: {clusters[name]}")
    fns = {name: caller(lib) for name, lib in libs.items()}
    B, PAGE, MAXP = chip_smoke.B, chip_smoke.PAGE, chip_smoke.MAXP
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for arch in ("llama31-8b", "qwen3-30b-a3b"):
        HQ, hkv, D = chip_smoke.heads(arch)
        P = B * MAXP + 1
        bt = (torch.randperm(P - 1, generator=gen, device="cuda") + 1) \
            .to(torch.int32).reshape(B, MAXP)
        idle_bt = bt.clone()
        idle_bt[:4] = 0
        q = torch.randn(B, HQ, D, generator=gen, device="cuda").bfloat16()
        pools = [tuple(torch.randn(P, PAGE, hkv, D, generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(2)) for _ in range(4)]
        mk = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
        cases = {
            "check_paged": (bt, mk([0, 1, 16, 17, 256, 512, 700, 768])),
            "served": (bt, mk(chip_smoke.SERVED_LENS)),
            "served, slots 0-3 idle": (
                idle_bt, mk([0] * 4 + chip_smoke.SERVED_LENS[4:])),
        }
        for what, (t, lens) in cases.items():
            sets = [(q, kp, vp, t, lens) for kp, vp in pools]
            ref = paged_attention_ref(*sets[0])
            busy = lens > 0
            gates = {}
            for name, fn in fns.items():
                out = fn(*sets[0])
                torch.cuda.synchronize()
                rows_held = busy if name == "baseline" else slice(None)
                gates[name] = bf16_gate(out[rows_held], ref[rows_held])
            order = list(fns) + list(fns)[::-1]
            ms = {name: [] for name in fns}
            for name in order:
                ms[name].append(chip_smoke.device_ms(fns[name], sets))
            b_ms, b_by = chip_smoke.paged_bound(q, t, lens, hkv)
            rows.append({"arch": arch, "Hkv": hkv, "case": what,
                         "seq_lens": lens.tolist(), "bound_ms": b_ms,
                         "bound_by": b_by, "ms": ms, "gate": gates})
            print(f"{arch} {what} seq_lens={lens.tolist()}, bound "
                  f"{b_ms:.4f} ({b_by}): " + "; ".join(
                      f"{n} {t[0]:.4f}/{t[1]:.4f}"
                      + ("" if gates[n] <= 1 else f" GATE {gates[n]:.3g}")
                      for n, t in ms.items()), flush=True)
    print(chip_smoke.smi_line())
    print(json.dumps({"ptxas": ptxas, "sass": sass, "clusters": clusters,
                      "cases": rows,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
