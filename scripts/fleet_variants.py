"""The fleet-loop kernel against an earlier version of itself, on one card.

    python3 scripts/fleet_variants.py --baseline DIR

Builds `src/repro_torch/csrc/fleet_loop.cu` as it is and the baseline, an
earlier `fleet_loop.cu` in DIR with the `fleet_loop.cuh` it includes and
the same C entry point (for example a commit's, from `git show`), with
the kernels' flags into `build/fleet_variants/`. Prints each build's
ptxas register and spill lines and its float64 instruction counts in the
SASS. Then, at the packed inputs of `chip_smoke.py` phase 7 (the paper's
42-cell grid on `h100-sxm`, and the first 512-lane chunk of its 672-lane
ensemble), requires the two builds' outputs to be equal bit for bit, and
times each launch with CUDA events (the median of 3) in turns: as it is,
the baseline, the baseline, as it is. Prints one JSON object, with every
number and the card's `nvidia-smi` name and power limit, as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke  # noqa: E402


def build_baseline(src_dir: str):
    """Compile the baseline into build/fleet_variants/; returns (library
    path, ptxas log)."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR.parent / "fleet_variants" / "baseline"
    out.mkdir(parents=True, exist_ok=True)
    for name in ("fleet_loop.cu", "fleet_loop.cuh"):
        shutil.copy(os.path.join(src_dir, name), out / name)
    lib = out / "libfleet_loop.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(out / "fleet_loop.cu")], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError("nvcc failed for the baseline:\n" + proc.stdout
                           + proc.stderr)
    return str(lib), proc.stdout + proc.stderr


def ptxas_lines(log: str):
    return [line.strip() for line in log.splitlines()
            if "Used" in line or "spill" in line]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="directory with the earlier fleet_loop.cu/.cuh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fleet_variants: no CUDA device; this script runs on the "
                 "card")
    from repro_torch.kernels import build
    from repro_torch.kernels.fleet_loop.kernel import fleet_loop_kernel

    logs = build.build_all(["fleet_loop"])
    base_path, base_log = build_baseline(args.baseline)
    libs = {"as is": build.load("fleet_loop"),
            "baseline": ctypes.CDLL(base_path)}
    paths = {"as is": str(build.library_path("fleet_loop")),
             "baseline": base_path}
    result = {"builds": {}, "shapes": {}}
    for name, log in (("as is", logs["fleet_loop"]), ("baseline", base_log)):
        sass = chip_smoke.sass_counts(paths[name])
        result["builds"][name] = {
            "ptxas": ptxas_lines(log),
            "sass": {k: sass[k] for k in ("DFMA", "DMUL", "DADD",
                                          "MUFU.RCP64H")}}
        print(f"{name}: {result['builds'][name]}", flush=True)

    def run(name, md, ec, r_arr, cap):
        build._LIBS["fleet_loop"] = libs[name]
        try:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fleet_loop_kernel(md, ec, r_arr, cap)
            e1.record()
            torch.cuda.synchronize()
        finally:
            build._LIBS["fleet_loop"] = libs["as is"]
        return out, e0.elapsed_time(e1)

    for what, cells in (
            ("paper_h100", chip_smoke.paper_grid_on_card().cells),
            ("ensemble chunk 1",
             chip_smoke.paper_grid_on_card(True).cells[:512])):
        md, ec, r_arr, cap = chip_smoke.fleet_inputs(cells, "cuda")
        outs = {name: run(name, md, ec, r_arr, cap)[0] for name in libs}
        differ = [k for k in outs["as is"]
                  if not torch.equal(outs["as is"][k], outs["baseline"][k])]
        if differ:
            sys.exit(f"fleet_variants: [{what}] the builds differ in "
                     f"{differ}")
        ms = {name: [] for name in libs}
        for name in ("as is", "baseline", "baseline", "as is"):
            ms[name].append(sorted(run(name, md, ec, r_arr, cap)[1]
                                   for _ in range(3))[1])
        longest = int(outs["as is"]["rounds"].max())
        row = {"lanes": int(r_arr.shape[0]), "W": int(r_arr.shape[1]),
               "rounds_longest_lane": longest, "ms": ms,
               "ns_per_round": {n: min(v) * 1e6 / longest
                                for n, v in ms.items()},
               "x_baseline": min(ms["baseline"]) / min(ms["as is"])}
        result["shapes"][what] = row
        print(f"[{what}] outputs equal bit for bit; {row}", flush=True)
        del md, ec, r_arr, outs
        torch.cuda.empty_cache()
    result["device"] = torch.cuda.get_device_name(0)
    result["nvidia_smi"] = chip_smoke.smi_line()
    print(result["nvidia_smi"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
