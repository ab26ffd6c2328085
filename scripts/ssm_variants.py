"""What the selective-scan kernel's design choices are worth, and how it
compares with an earlier version of itself, on one card.

    python3 scripts/ssm_variants.py [--baseline FILE]

Builds `src/repro_torch/csrc/ssm_scan.cu` as it is and variants of it made
by editing its source (2 or 4 lanes a channel, N split over them and y
reduced with shuffles; chunks of 32 or 64 time steps; a ring of 3 stages;
`expf` of dt * A in place of ex2.approx of dt * A log2 e; y stored from
registers a step at a time instead of staged in shared memory) into
`build/ssm_variants/`, and `--baseline`, an earlier `ssm_scan.cu` with the
same C entry point (for example the parent commit's, from `git show`).
Also, for timing only, builds that leave out one part of the work (the
exponentials, the loads, or the stores of y) and builds that unroll the
step loop 1 or 4 times. Prints ptxas's register and spill lines, the SASS
counts of each and, for
the builds that report it, the prefill kernel's layout: chunk, stages,
lanes, and how many blocks an SM holds at once, with the waves the served
grid (B 8, d_inner 8192) then needs on this card. Then, at
jamba-v0.1-52b's served shapes (`chip_smoke.SSM_SHAPES`: prefill from a
zero state, a decode step from a random h0), holds each build's y and
h_final to the plain version (`fp32_gate`), also at prefill with dt drawn
from [0.001, 0.1] (the range jamba's dt bias starts in, where the state
remembers hundreds of steps), and times it (`chip_smoke.device_ms`) in
turns: every build, then the same in reverse, and reads the SM clock
and power draw while the kernel as it is replays (`nvidia-smi`). Prints
one JSON object, with every number, as its last line.
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
    "2 lanes a channel": [("constexpr int LANES = 1;",
                           "constexpr int LANES = 2;")],
    "4 lanes a channel": [("constexpr int LANES = 1;",
                           "constexpr int LANES = 4;")],
    "chunk 32": [("constexpr int CHUNK = 16;", "constexpr int CHUNK = 32;")],
    "chunk 64": [("constexpr int CHUNK = 16;", "constexpr int CHUNK = 64;")],
    "3 stages": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "expf": [("constexpr float A_SCALE = LOG2E;",
              "constexpr float A_SCALE = 1.0f;"),
             ("{ return exp2_approx(x); }", "{ return expf(x); }")],
    "y stored a step at a time": [("constexpr bool STAGE_Y = true;",
                                   "constexpr bool STAGE_Y = false;")],
    "step loop unrolled 1": [("#pragma unroll 2\n", "#pragma unroll 1\n")],
    "step loop unrolled 4": [("#pragma unroll 2\n", "#pragma unroll 4\n")],
    # timing only, wrong by design: each leaves out one part of the work
    "no exponentials (timing only)": [("{ return exp2_approx(x); }",
                                       "{ return x; }")],
    "no loads (timing only)": [
        ("if (i < len && d0 + c < di) {", "if (false) {"),
        ("e < len * N / W;", "e < 0;")],
    "no y stores (timing only)": [
        ("if (i < len && d0 + c < di)\n      *reinterpret_cast",
         "if (i < len && d0 + c < di && di < 0)\n      *reinterpret_cast")],
}


def sources(baseline):
    from repro_torch.kernels import build
    src = (build.CSRC / "ssm_scan.cu").read_text()
    out = {"as is": src}
    for name, edits in EDITS.items():
        v = src
        for old, new in edits:
            assert old in v, f"the kernel's source moved: {old!r}"
            v = v.replace(old, new)
        out[name] = v
    if baseline:
        with open(baseline) as f:
            out["baseline"] = f.read()
    return out


def sm_clock_under_load(fn, sets, seconds=2.0):
    """`nvidia-smi`'s SM clock and power draw, read once while `fn`
    replays for about `seconds` (a CUDA graph of 20 calls)."""
    import threading
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*sets[0])
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(20):
            fn(*sets[i % len(sets)])
    read = {}

    def sample():
        read["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    t = threading.Timer(seconds / 2, sample)
    t.start()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    while True:
        for _ in range(50):
            g.replay()
        t1.record()
        t1.synchronize()
        if t0.elapsed_time(t1) > seconds * 1e3:
            break
    t.join()
    return read["smi"]


def build_all(srcs):
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan.kernel import layout
    out = os.path.join(ROOT, "build", "ssm_variants")
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
    libs, ptxas, sass, layouts = {}, {}, {}, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if "spill" in line or "Used" in line]
        sass[name] = chip_smoke.sass_counts(so)
        lib = ctypes.CDLL(so)
        lib.ssm_scan_f32.restype = ctypes.c_int
        lib.ssm_scan_f32.argtypes = [ctypes.c_void_p] * 9 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        if hasattr(lib, "ssm_scan_layout"):
            lay = layout(16, lib)
            blocks = 8 * -(-8192 // lay["channels_per_block"])
            per_sm = lay["resident_blocks_per_sm"]
            lay.update(blocks=blocks, sms=sms, waves=(
                -(-blocks // (per_sm * sms)) if per_sm > 0 else None))
            layouts[name] = lay
        libs[name] = lib
    return libs, ptxas, sass, layouts


def caller(lib):
    def fn(u, dt, Bm, Cm, A, D, h0=None):
        B, S, di = u.shape
        N = A.shape[1]
        y = torch.empty_like(u)
        h = torch.empty((B, di, N), dtype=torch.float32, device=u.device)
        err = lib.ssm_scan_f32(
            u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), D.data_ptr(), 0 if h0 is None else h0.data_ptr(),
            y.data_ptr(), h.data_ptr(), B, S, di, N,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return y, h
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an earlier ssm_scan.cu with the "
                    "same C entry point")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ssm_variants: no CUDA device; this script runs on the card")
    from repro_torch.kernels import fp32_gate
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    libs, ptxas, sass, layouts = build_all(sources(args.baseline))
    for name in libs:
        for line in ptxas[name]:
            print(f"ptxas {name}: {line}")
        print(f"SASS {name}: {sass[name]}")
        if name in layouts:
            print(f"layout {name}: {layouts[name]}")
    fns = {name: caller(lib) for name, lib in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for Bsz, S, di, N, what in chip_smoke.SSM_SHAPES:
        decode = what == "decode"
        sets = [chip_smoke.ssm_inputs(gen, Bsz, S, di, N, decode)
                for _ in range(2)]
        cases = {what: sets[0]}
        if not decode:       # slow decay: dt in [0.001, 0.1]
            slow = list(sets[1])
            slow[1] = 0.001 + 0.099 * torch.rand(
                Bsz, S, di, generator=gen, device="cuda")
            cases[f"{what}, dt in [0.001, 0.1]"] = tuple(slow)
        gates = {}
        for case, a in cases.items():
            yr, hr = ssm_scan_ref(*a)
            for name, fn in fns.items():
                y, h = fn(*a)
                torch.cuda.synchronize()
                gates.setdefault(name, {})[case] = {
                    "y": fp32_gate(y, yr), "h_final": fp32_gate(h, hr)}
            del yr, hr
        order = list(fns) + list(fns)[::-1]
        ms = {name: [] for name in fns}
        for name in order:
            ms[name].append(chip_smoke.device_ms(fns[name], sets))
        smi = sm_clock_under_load(fns["as is"], sets)
        print(f"as is, {what}: nvidia-smi clocks.sm, clocks.max.sm, "
              f"power.draw under load: {smi}", flush=True)
        rows.append({"case": what, "shape": [Bsz, S, di, N], "ms": ms,
                     "gate": gates, "as_is_clock_power": smi})
        print(f"ssm_scan {what} (B={Bsz} S={S} d_inner={di} N={N}): " +
              "; ".join(f"{n} {t[0]:.4f}/{t[1]:.4f} ms, gate " + ", ".join(
                  f"{c}: y {g['y']:.3g} h {g['h_final']:.3g}"
                  for c, g in gates[n].items()) for n, t in ms.items()),
              flush=True)
        del sets, cases
        torch.cuda.empty_cache()
    print(chip_smoke.smi_line())
    print(json.dumps({"ptxas": ptxas, "sass": sass, "layouts": layouts,
                      "cases": rows,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
