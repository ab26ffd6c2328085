#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from: the
program's sound runs on a dozen seeds and more, and the control's on
three or more, each a run of the cell at its own load and length.

The control is the nearest precision below the configuration's: for a
bf16 configuration the program's own int8 path (`--quant int8` served,
judged against the bf16 reference); for an int8 one, the reference in
int4 (int4 weights, int8 activations) put in the program's place on the
same prompts and served tokens, the gap read of the token it puts first
at each position, and held to the cell's own limits (`"control"` in the
row). The benchmark's own runs do not run it.

    python3 bench/control.py --workload mixtral-8x7b-int8.chat-batch \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 35
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

CONTROL = {"int8": "int4", "bf16": "int8"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    import torch
    from bench import manifest as mf, run
    from repro_torch.quant import BY_NAME
    run.caches()
    manifest = mf.load_manifest()
    cfile = mf.load_config_file(manifest,
                                mf.cell(manifest, args.workload)["config"])
    stated = cfile["quant"]
    ctl = CONTROL[stated]
    # where the program has the lower precision (bf16's int8), it serves
    # as the control; where it has none (int8's int4), the reference does
    in_reference = ctl not in BY_NAME
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = Path(args.out)
    out.mkdir(exist_ok=True)
    log = out / f"control-{args.workload}.jsonl"
    todo = [(s, False) for s in seeds] + [(s, True) for s in cseeds
                                          if not in_reference]
    if in_reference:
        todo = [(s, s in cseeds) for s in sorted(set(seeds) | set(cseeds))]
    for seed, with_control in todo:
        kw = {}
        if with_control:
            kw = {"control": ctl} if in_reference else {"quant": ctl}
        r = run.run_cell(args.workload, seed, args.seconds, False, **kw)
        ref = r["reference"]
        row = {"workload": args.workload, "seed": seed,
               "served": kw.get("quant", stated), "correct": r["correct"],
               "checks": r["checks"], "control": r.get("control"),
               "metrics": r["metrics"],
               **{k: v for k, v in ref.items() if k[0] != "_"}}
        with open(out / f"gaps-{args.workload}.jsonl", "a") as f:
            f.write(json.dumps({"seed": seed, "served": row["served"],
                                **{k: v for k, v in ref.items()
                                   if k[0] == "_"}}) + "\n")
        line = json.dumps(run.finite(row))
        print(line, flush=True)
        with open(log, "a") as f:
            f.write(line + "\n")
        del r
        gc.collect()
        torch.cuda.empty_cache()
    print(f"card: {run.power_limit()}")


if __name__ == "__main__":
    main()
