"""CLI: invert a committed experiment store into deployment decisions.

    PYTHONPATH=src python -m repro_torch.planner --plan paper_atlas --lam 5
    PYTHONPATH=src python -m repro_torch.planner --plan paper_atlas --lam 5 \
        --slo-ttft-p90 2000 --slo-tpot-p99 100
    PYTHONPATH=src python -m repro_torch.planner --plan paper_crosshw --lam 40 \
        --model mixtral-8x7b --json plan.json
    PYTHONPATH=src python -m repro_torch.planner --plan paper_atlas \
        --portfolio blended_3class --lam 10
    PYTHONPATH=src python -m repro_torch.planner --plan paper_atlas \
        --portfolio workload.json --chip-budget 8

Runs from the store alone — no engines are re-run. Exit status 3 when no
model has any feasible deployment at the requested load, or — in
portfolio mode — when any workload class is infeasible (the planner
refuses to silently price an SLO-infeasible load, paper §6.4).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.slo import SLOTarget
from repro_torch.experiments.analyze import load_store_records
from repro_torch.planner.curves import fit_curves
from repro_torch.planner.optimize import (DEFAULT_MAX_REPLICAS,
                                    AvailabilityTarget, plan_capacity)
from repro_torch.planner.tables import plan_row, render_plans


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--plan", required=True,
                    help="experiment plan whose store to invert "
                         "(e.g. paper_atlas)")
    ap.add_argument("--lam", type=float, default=None,
                    help="offered rate, req/s (stationary planning)")
    ap.add_argument("--day", default=None, metavar="SCENARIO",
                    help="price a 24h lambda(t) scenario (e.g. paper_day) "
                         "against every fitted curve: static-vs-autoscaled "
                         "day cost per footprint (time-aware planning); "
                         "combine with --slo-ttft-p90 to add an "
                         "SLO-aware autoscaler head-to-head")
    ap.add_argument("--flash-crowd", action="store_true",
                    help="render the store's overload verdict: graceful "
                         "degradation vs blind shedding on paired MMPP "
                         "burst cells (requires a flash-crowd store, e.g. "
                         "--plan paper_flashcrowd)")
    ap.add_argument("--portfolio", default=None, metavar="SPEC",
                    help="price a multi-class workload portfolio: SPEC "
                         "is a registered workload name (e.g. "
                         "blended_3class) or a path to a workload JSON "
                         "({'classes': [{name, lam, tiers, io_shape, "
                         "budget_tokens}, ...]}). Prints the silo vs "
                         "consolidated vs routed verdict with greedy-vs-"
                         "exact certification; with --lam, the class mix "
                         "is rescaled to that total rate")
    ap.add_argument("--chip-budget", type=int, default=None, metavar="N",
                    help="portfolio mode: flag whether the routed arm "
                         "fits within N total chips")
    ap.add_argument("--model", default=None,
                    help="restrict to one model (default: every model "
                         "in the store)")
    ap.add_argument("--io-shape", default="chat")
    ap.add_argument("--max-replicas", type=int,
                    default=DEFAULT_MAX_REPLICAS)
    ap.add_argument("--slo-ttft-p90", type=float, default=None,
                    metavar="MS")
    ap.add_argument("--slo-ttft-p99", type=float, default=None,
                    metavar="MS")
    ap.add_argument("--slo-tpot-p99", type=float, default=None,
                    metavar="MS")
    ap.add_argument("--availability", type=float, default=None,
                    metavar="P",
                    help="fleet availability target (e.g. 0.999): buy "
                         "N+1-style spares per option and price them as "
                         "utilization loss on $/M-delivered-tok")
    ap.add_argument("--replica-availability", type=float, default=0.99,
                    metavar="P",
                    help="per-replica steady-state availability "
                         "MTTF/(MTTF+MTTR) used for the spare "
                         "calculation (default 0.99)")
    ap.add_argument("--root", default=None,
                    help="store root (default results/experiments)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the per-model plans as JSON")
    args = ap.parse_args(argv)
    if args.portfolio is not None:
        # portfolio is its own mode; --lam becomes the optional total
        # rate the class mix is rescaled to
        if args.day is not None or args.flash_crowd:
            ap.error("--portfolio cannot be combined with --day or "
                     "--flash-crowd")
    else:
        modes = sum((args.lam is not None, args.day is not None,
                     args.flash_crowd))
        if modes != 1:
            ap.error("exactly one of --lam (stationary), --day "
                     "(lambda(t)), --flash-crowd (overload verdict) or "
                     "--portfolio (workload portfolio) is required")

    records = load_store_records(args.plan, args.root)
    if not records:
        raise SystemExit(
            f"no completed cells in store for {args.plan!r}; run: "
            f"python -m repro_torch.experiments.run --plan {args.plan}")

    slo = None
    if (args.slo_ttft_p90 is not None or args.slo_ttft_p99 is not None
            or args.slo_tpot_p99 is not None):
        slo = SLOTarget(ttft_p90_ms=args.slo_ttft_p90,
                        ttft_p99_ms=args.slo_ttft_p99,
                        tpot_p99_ms=args.slo_tpot_p99)

    if args.portfolio is not None:
        import os
        from repro_torch.planner.portfolio import (WORKLOADS, Workload,
                                             plan_portfolio)
        from repro_torch.planner.tables import portfolio_row, render_portfolio
        if args.portfolio in WORKLOADS:
            workload = WORKLOADS[args.portfolio]
        elif os.path.exists(args.portfolio):
            workload = Workload.from_json(args.portfolio)
        else:
            raise SystemExit(
                f"unknown workload {args.portfolio!r}: not a registered "
                f"name {sorted(WORKLOADS)} and not a JSON file")
        if args.lam is not None:
            workload = workload.scaled(args.lam)
        curves = fit_curves(records, model=args.model)
        if not curves:
            raise SystemExit(
                f"store for {args.plan!r} has no fitted curves")
        plan = plan_portfolio(curves, workload, slo=slo,
                              chip_budget=args.chip_budget)
        print(render_portfolio(plan))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(portfolio_row(plan), f, indent=1,
                          sort_keys=True)
            print(f"\nportfolio verdict written to {args.json}")
        if not plan.feasible:
            raise SystemExit(3)
        return

    if args.flash_crowd:
        from repro_torch.experiments.analyze import (overload_tables,
                                               overload_verdict,
                                               render_overload)
        pairs = overload_tables(records)
        if not pairs:
            raise SystemExit(
                f"store for {args.plan!r} has no flash-crowd pairs "
                f"(no 'flash:<scenario>:<arm>' cells); run: python -m "
                f"repro_torch.experiments.run --plan paper_flashcrowd")
        print(render_overload(pairs))
        verdict = overload_verdict(pairs)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"pairs": pairs, "verdict": verdict}, f,
                          indent=1, sort_keys=True)
            print(f"\noverload tables written to {args.json}")
        if not verdict["degradation_wins"]:
            raise SystemExit(3)
        return

    curves = fit_curves(records, io_shape=args.io_shape, model=args.model)
    if not curves:
        raise SystemExit(
            f"store for {args.plan!r} has no curves for "
            f"model={args.model!r} io_shape={args.io_shape!r}")

    if args.day is not None:
        from repro_torch.planner.day import day_tables, render_day
        from repro_torch.serving.autoscale import (DAY_SCENARIOS,
                                             SLOAutoscalePolicy)
        if args.day not in DAY_SCENARIOS:
            raise SystemExit(f"unknown day scenario {args.day!r}; known: "
                             f"{sorted(DAY_SCENARIOS)}")
        scenario = DAY_SCENARIOS[args.day]
        slo_pol = None
        if args.slo_ttft_p90 is not None:
            # mechanics matched to the scenario's reactive policy so the
            # head-to-head isolates the SIGNAL (p90 vs util), not the lag
            slo_pol = SLOAutoscalePolicy(
                name="slo-p90", ttft_p90_slo_ms=args.slo_ttft_p90,
                scale_up_lag_s=scenario.window_s,
                warmup_s=scenario.window_s,
                scale_down_hold_s=2 * scenario.window_s,
                max_replicas=args.max_replicas)
        rows = day_tables(curves, scenario, slo_pol)
        print(render_day(rows, title=f"{args.plan} x {args.day}"))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rows, f, indent=1, sort_keys=True)
            print(f"\nday tables written to {args.json}")
        return

    avail = None
    if args.availability is not None:
        avail = AvailabilityTarget(
            availability=args.availability,
            replica_availability=args.replica_availability)

    plans = plan_capacity(curves, args.lam, slo,
                          max_replicas=args.max_replicas, avail=avail)
    print(render_plans(
        plans, title=f"{args.plan} @ lambda={args.lam:g} rps"))
    if args.json:
        with open(args.json, "w") as f:
            json.dump([plan_row(p) for p in plans], f, indent=1,
                      sort_keys=True)
        print(f"\nplans written to {args.json}")
    if not any(p.feasible for p in plans):
        raise SystemExit(3)


if __name__ == "__main__":
    main()
