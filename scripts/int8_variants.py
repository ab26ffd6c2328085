"""What the int8 GEMM's design choices are worth, and how it compares with
an earlier version of itself, on one card.

    python3 scripts/int8_variants.py [--baseline FILE]

Builds `src/repro_torch/csrc/int8_matmul.cu` as it is and variants of it
made by editing its source (decode without split-K, with the split rule
looser, or with 6 stages instead of 4; prefill with one tile a block
instead of a persistent grid, always on 128 x 128 tiles, or with 3
stages instead of 4) into `build/int8_variants/`, and `--baseline`, an
earlier `int8_matmul.cu` that reads the weight K-major, with either this
entry point or the one before it, which took no row strides (`(x, w,
x_scale, w_scale, out, M, N, K, stream)`: K a multiple of 16 and N of 8;
for example the parent commit's, from `git show`). Prints ptxas's
register and spill lines for each. Then, at every shape of
`chip_smoke.INT8_SHAPES` (a build without row strides skips those whose K
or N it refuses), holds each build to the plain version bit for bit and
times it (`chip_smoke.device_ms`: CUDA graphs of repeated calls over
enough weight sets to overflow L2) in turns: every build, then the same
in reverse. The operands are stored as the model stores them: rows
padded to a multiple of 16 bytes where K is not one.
Prints one JSON object, with every number, as its last line.
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
    "decode: no split-K": ("while (split < MAX_SPLIT &&",
                           "while (false && split < MAX_SPLIT &&"),
    "decode: split to 2 x the SMs, >= 1 k-tile a split": (
        "SPLIT_FILL = 1, SPLIT_MIN_KT = 16",
        "SPLIT_FILL = 2, SPLIT_MIN_KT = 1"),
    "decode: >= 8 k-tiles a split": ("SPLIT_MIN_KT = 16", "SPLIT_MIN_KT = 8"),
    "decode: 6 stages": ("constexpr int D_STAGES = 4,",
                         "constexpr int D_STAGES = 6,"),
    "prefill: one tile a block": ("PERSISTENT = true", "PERSISTENT = false"),
    "prefill: 128 x 128 tiles always": ("return tiles256 >= SM_COUNT",
                                        "return false"),
    "prefill: 3 stages": ("P_STAGES = 4,", "P_STAGES = 3,"),
}


def sources(baseline):
    """{name: (source, its entry point takes row strides)}."""
    from repro_torch.kernels import build
    src = (build.CSRC / "int8_matmul.cu").read_text()
    out = {"as is": (src, True)}
    for name, (old, new) in EDITS.items():
        assert old in src, f"the kernel's source moved: {old!r}"
        out[name] = (src.replace(old, new), True)
    if baseline:
        with open(baseline) as f:
            base = f.read()
        out["baseline"] = (base, "int ldx" in base)
    return out


def build_all(srcs):
    from repro_torch.kernels import build
    out = os.path.join(ROOT, "build", "int8_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for i, (name, (src, _)) in enumerate(srcs.items()):
        cu = os.path.join(out, f"v{i}.cu")
        so = os.path.join(out, f"libv{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs, ptxas = {}, {}
    for name, (proc, so) in procs.items():
        strided = srcs[name][1]
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if "spill" in line or "Used" in line]
        lib = ctypes.CDLL(so)
        lib.int8_matmul_s8.restype = ctypes.c_int
        lib.int8_matmul_s8.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * (6 if strided else 3) + [ctypes.c_void_p]
        libs[name] = lib
    return libs, ptxas


def caller(lib, strided):
    """fn(x, w, xs, ws) -> out through `lib`; `strided`: its entry point
    takes the row strides of x, w and out."""
    from repro_torch.kernels.int8_matmul.kernel import padded

    def fn(x, w, xs, ws):
        M, K = x.shape
        N = w.shape[1]
        ldo = padded(N, 4) if strided else N
        out = torch.empty((M, ldo), dtype=torch.float32,
                          device=x.device)[:, :N]
        lds = (x.stride(0), w.stride(1), ldo) if strided else ()
        err = lib.int8_matmul_s8(
            x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            out.data_ptr(), M, N, K, *lds,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an earlier int8_matmul.cu that "
                    "reads the weight K-major")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("int8_variants: no CUDA device; this script runs on the card")
    from repro_torch.kernels.int8_matmul.kernel import padded
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    srcs = sources(args.baseline)
    libs, ptxas = build_all(srcs)
    for name, lines in ptxas.items():
        for line in lines:
            print(f"ptxas {name}: {line}")
    every = {name: caller(libs[name], srcs[name][1]) for name in libs}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for M, K, N, what in chip_smoke.INT8_SHAPES:
        n_sets = max(2, min(6, -(-120_000_000 // (K * N))))
        ld = padded(K, 16)
        sets = []
        for _ in range(n_sets):
            sets.append((
                torch.randint(-127, 128, (M, ld), generator=gen,
                              device="cuda", dtype=torch.int8)[:, :K],
                torch.randint(-127, 128, (N, ld), generator=gen,
                              device="cuda", dtype=torch.int8)[:, :K].mT,
                torch.rand(1, generator=gen, device="cuda") * 0.02 + 1e-3,
                torch.rand(1, N, generator=gen, device="cuda") * 0.02 + 1e-3))
        x, wk, xs, ws = sets[0]
        ref = int8_matmul_ref(x, wk, xs, ws)
        # an entry point without row strides takes K % 16 == N % 8 == 0
        fns = {name: fn for name, fn in every.items()
               if srcs[name][1] or not (K % 16 or N % 8)}
        exact = {}
        for name, fn in fns.items():
            out = fn(*sets[0])
            torch.cuda.synchronize()
            exact[name] = bool(torch.equal(out, ref))
        order = list(fns) + list(fns)[::-1]
        ms = {name: [] for name in fns}
        for name in order:
            ms[name].append(chip_smoke.device_ms(fns[name], sets))
        b_ms, b_by = chip_smoke.bound(M * K + K * N + 4 + 4 * N + 4 * M * N,
                                      2 * M * N * K, chip_smoke.INT8_PEAK)
        row = {"shape": what, "M": M, "K": K, "N": N, "bound_ms": b_ms,
               "bound_by": b_by, "ms": ms, "exact": exact}
        rows.append(row)
        print(f"{what} ({M}, {K}, {N}), bound {b_ms:.4f} ({b_by}): " +
              "; ".join(f"{n} {t[0]:.4f}/{t[1]:.4f}"
                        + ("" if exact[n] else " NOT EXACT")
                        for n, t in ms.items()), flush=True)
        del sets, ref
        torch.cuda.empty_cache()
    print(chip_smoke.smi_line())
    print(json.dumps({"ptxas": ptxas, "shapes": rows,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
