"""Regenerate the §Roofline table from the port's dry-run records
(examples_out/dryrun/*.json, written by `launch.dryrun`) without running
the cells again.

Counterpart of `repro.launch.roofline_report`; the reference reads its
own corpus under results/dryrun/. `--hw` defaults to the card the port
runs on, `h100-sxm`, as `launch.serve`'s sim tier does.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch.roofline import compute_roofline
from repro_torch.simulate.hardware import HW_BY_NAME

RESULTS = Path(__file__).resolve().parents[3] / "examples_out" / "dryrun"


def regenerate(mesh: str = "16x16", quant: str = "bf16",
               hw: str = "h100-sxm"):
    rows = []
    for f in sorted(glob.glob(str(RESULTS / f"*_{mesh}_{quant}.json"))):
        r = json.load(open(f))
        cfg = get_config(r["arch"])
        shape = SHAPES_BY_NAME[r["shape"]]
        t = compute_roofline(
            cfg, shape, mesh_name=r["mesh"], n_devices=r["n_devices"],
            cost=r["cost_analysis"],
            coll_bytes=r["collective_bytes"]["total"],
            hw=HW_BY_NAME[hw], quant=quant)
        rows.append(t)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--quant", default="bf16")
    ap.add_argument("--hw", default="h100-sxm")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()
    rows = regenerate(args.mesh, args.quant, args.hw)
    rows.sort(key=lambda t: t.roofline_frac)
    sep = " | " if args.markdown else " "
    hdr = ["arch", "shape", "bound", "frac", "compute_s", "mem_floor_s",
           "mem_hlo_s", "coll_s", "mfr"]
    if args.markdown:
        print("| " + " | ".join(hdr) + " |")
        print("|" + "---|" * len(hdr))
    else:
        print(f"{'arch':<26} {'shape':<12} {'bound':<11} {'frac':>6} "
              f"{'compute_s':>10} {'memfloor':>9} {'memhlo':>9} "
              f"{'coll_s':>9} {'mfr':>5}")
    for t in rows:
        vals = [t.arch, t.shape, t.bottleneck, f"{t.roofline_frac:.3f}",
                f"{t.compute_s:.3g}", f"{t.memory_analytic_s:.3g}",
                f"{t.memory_s:.3g}", f"{t.collective_s:.3g}",
                f"{t.model_flops_ratio:.2f}"]
        if args.markdown:
            print("| " + " | ".join(vals) + " |")
        else:
            print(f"{vals[0]:<26} {vals[1]:<12} {vals[2]:<11} {vals[3]:>6} "
                  f"{vals[4]:>10} {vals[5]:>9} {vals[6]:>9} {vals[7]:>9} "
                  f"{vals[8]:>5}")


if __name__ == "__main__":
    main()
