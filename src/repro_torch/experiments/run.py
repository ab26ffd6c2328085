"""CLI: run an experiment plan against the resumable store.

    PYTHONPATH=src python -m repro_torch.experiments.run --plan paper_a100 --resume
    PYTHONPATH=src python -m repro_torch.experiments.run --plan mini_2x2 --analyze
    PYTHONPATH=src python -m repro_torch.experiments.run --plan paper_crosshw \
        --resume --analyze --analyze-json
    PYTHONPATH=src python -m repro_torch.experiments.run --plan mini_2x2 \
        --backend jit --device cpu --root /tmp/x

Resume is the default: re-invoking after a kill finishes only the
remaining cells and re-derives an identical consolidated CSV. `--fresh`
prunes cell files orphaned by plan edits (`store.prune`) and re-runs
(overwriting) every current cell instead. `--analyze-json` persists
the cross-hardware tables (spread compression, fp8 inversion, ordering
survival, planner payload) as `analysis.json` beside the store.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.experiments.analyze import report, write_tables
from repro_torch.experiments.plans import PLANS, get_plan
from repro_torch.experiments.runner import PlanRunner
from repro_torch.experiments.store import ExperimentStore


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--plan", required=True,
                    help=f"one of: {', '.join(sorted(PLANS))}")
    ap.add_argument("--resume", action="store_true", default=True,
                    help="skip cells already in the store (default)")
    ap.add_argument("--fresh", dest="resume", action="store_false",
                    help="prune orphaned cell files, then re-run every "
                         "cell, overwriting stored results")
    ap.add_argument("--serial", action="store_true",
                    help="disable the process pool")
    ap.add_argument("--backend", default="process",
                    choices=("process", "vector", "jit"),
                    help="cell execution backend: per-cell process pool, "
                         "the vectorized numpy fleet (lanes x cores; "
                         "identical records), or the fleet-loop CUDA "
                         "kernel (records within the jit tolerance; one "
                         "launch a chunk, in this process)")
    ap.add_argument("--lane-width", type=int, default=None,
                    help="max cells per fleet chunk (vector/jit backends)")
    ap.add_argument("--device", default=None,
                    help="where the jit backend runs: the card by default "
                         "(raises without one), or 'cpu' for the fleet "
                         "loop's plain PyTorch version")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--mp-context", default=None,
                    choices=(None, "fork", "spawn", "forkserver"))
    ap.add_argument("--root", default=None,
                    help="store root (default results/experiments)")
    ap.add_argument("--analyze", action="store_true",
                    help="print the paper-figure report after the run")
    ap.add_argument("--analyze-json", action="store_true",
                    help="write the cross-hardware tables to "
                         "<store>/analysis.json after the run")
    ap.add_argument("--verify", action="store_true",
                    help="integrity-check the store against the plan "
                         "(torn/stale/orphaned cell files) and exit; "
                         "nonzero exit status on any issue")
    ap.add_argument("--worker-timeout", type=float, default=None,
                    help="seconds without any finished unit before the "
                         "pool is declared wedged, killed, and unfinished "
                         "cells re-dispatched (per-cell retry budget)")
    args = ap.parse_args(argv)

    plan = get_plan(args.plan)
    store = ExperimentStore(plan.name, args.root)
    if args.verify:
        res = store.verify(plan)
        for line in res["issues"]:
            print(f"ISSUE   {line}")
        for line in res["missing"]:
            print(f"missing {line}")
        print(f"store {store.dir}: {len(res['issues'])} issue(s), "
              f"{len(res['missing'])} of {len(plan.cells)} cells missing")
        return 1 if res["issues"] else 0
    if not args.resume and store.dir.exists():
        # --fresh also clears orphaned cell files (a plan edit renames
        # cell ids; superseded files would otherwise accumulate forever)
        pruned = store.prune(plan)
        if pruned:
            print(f"pruned {len(pruned)} stale cell file(s) from "
                  f"{store.dir}")
    already = len(store.completed_ids(plan)) if args.resume else 0
    print(f"plan {plan.name}: {len(plan.cells)} cells "
          f"({already} already in store at {store.dir})")

    t0 = time.time()

    def progress(cell, rec, n_done, n_total):
        print(f"[{n_done:>3}/{n_total}] {cell.cell_id:<46} "
              f"tps={rec.tps:>8.1f} c_eff=${rec.c_eff:>8.3f}", flush=True)

    runner = PlanRunner(plan, store=store)
    records = runner.run(resume=args.resume, parallel=not args.serial,
                         max_workers=args.workers,
                         mp_context=args.mp_context, backend=args.backend,
                         lane_width=args.lane_width,
                         worker_timeout=args.worker_timeout,
                         progress=progress, device=args.device)
    print(f"\n{len(records)}/{len(plan.cells)} cells consolidated to "
          f"{store.csv_path} in {time.time() - t0:.1f}s")
    if args.analyze:
        print()
        print(report(records, title=plan.name))
    if args.analyze_json:
        path = store.dir / "analysis.json"
        write_tables(records, path)
        print(f"cross-hardware tables written to {path}")


if __name__ == "__main__":
    raise SystemExit(main())
