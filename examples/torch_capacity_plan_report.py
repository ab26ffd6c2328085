"""Capacity-plan report on the PyTorch port: from the committed penalty
atlas to a deployment decision in one command.

The paper's point is that the offered rate lambda — not a utilization
preset — drives the self-host decision. The committed `paper_atlas`
store holds the dense C_eff(lambda) continuum for every (model,
hardware, quant) footprint; `repro_torch.planner` inverts it: what
should an operator with THIS lambda and THIS latency SLO actually
deploy, and at what $/M output tokens?

    PYTHONPATH=src python examples/torch_capacity_plan_report.py [--hw h100-sxm]

Reads the committed store through a copy under the examples' own root
(running any missing cells there through the fleet backend first); no
engines are re-run on a populated checkout. `--hw` adds that entry to
the atlas as another generation (its cells run once).
"""
import argparse

from repro_torch.core.slo import SLOTarget
from repro_torch.experiments import PlanRunner, get_plan
from repro_torch.experiments.plans import on_hw
from repro_torch.experiments.store import example_store
from repro_torch.planner import fit_curves, plan_capacity, render_plans
from repro_torch.simulate import HW_BY_NAME


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default=None, choices=sorted(HW_BY_NAME),
                    help="add this entry as another hardware generation")
    args = ap.parse_args(argv)
    plan = get_plan("paper_atlas")
    if args.hw:
        plan = on_hw(plan, args.hw, add=True)
    store = example_store(plan.name)
    cached = len(store.completed_ids(plan))
    print(f"paper_atlas: {cached}/{len(plan.cells)} cells in store "
          f"({store.dir})")
    records = PlanRunner(plan, store=store).run(backend="vector")
    curves = fit_curves(records)

    print("\n=== the operator's question: lambda drives the decision ===")
    for lam in (1.0, 10.0, 200.0):
        plans = plan_capacity(curves, lam)
        print()
        print(f"--- offered rate {lam:g} req/s ---")
        for p in plans:
            b = p.best
            dep = f"{b.hw}/{b.quant} x{b.n_chips}" + \
                (f" R={b.replicas}" if b.replicas > 1 else "")
            print(f"  {p.model:<24} -> {dep:<22} "
                  f"${b.c_eff:>7.3f}/M-tok  util {b.util:.2f}  "
                  f"penalty {b.penalty:.1f}x")
    print("\nNote the inversion: at idle the cheap generation wins "
          "($/hr dominates), at\nsaturation the native-fp8 part wins "
          "(tokens/s dominates) — a single\n'best hardware' answer "
          "does not exist without lambda.")

    print("\n=== an SLO turns splits from waste into the price of "
          "latency ===")
    slo = SLOTarget(ttft_p90_ms=2000.0)
    print(render_plans(plan_capacity(fit_curves(records,
                                                model="llama31-8b"),
                                     200.0, slo),
                       title="llama31-8b @ 200 rps, TTFT p90 <= 2s"))

    print("\n=== and some loads must be refused, not priced ===")
    tight = SLOTarget(ttft_p90_ms=5.0)
    plans = plan_capacity(fit_curves(records, model="llama31-8b"),
                          200.0, tight)
    print(render_plans(plans, title="llama31-8b @ 200 rps, TTFT p90 <= "
                                    "5ms (infeasible)"))


if __name__ == "__main__":
    main()
