"""Portfolio-plan report on the PyTorch port: from the committed penalty
atlas to a multi-model fleet verdict in one command.

One model at one rate is not what an operator runs. The blended
workload here mixes three request classes — reasoning (flagship-only),
chat (mid-tier eligible), autocomplete (any tier) — and prices the same
blend three ways off the committed `paper_atlas` curves:

  silo           one dedicated fleet per class, all on the flagship
  flagship_pool  every class pooled onto the flagship
  routed_pool    a token-budget router picks each class's cheapest
                 eligible tier, survivors pool per model

Every greedy allocation in every arm is certified by the exact
branch-and-bound allocator; the optimality gap is printed per pool and
a beaten greedy is flagged loudly, never hidden.

    PYTHONPATH=src python examples/torch_portfolio_report.py [--hw h100-sxm]

Reads the committed store through a copy under the examples' own root
(running any missing cells there through the fleet backend first); no
engines are re-run on a populated checkout. `--hw` adds that entry to
the atlas as another generation (its cells run once).
"""
import argparse

from repro_torch.experiments import PlanRunner, get_plan
from repro_torch.experiments.plans import on_hw
from repro_torch.experiments.store import example_store
from repro_torch.planner import (BLENDED_3CLASS, PORTFOLIO_LAMS,
                                 certification_rows, fit_curves,
                                 plan_portfolio, render_certification,
                                 render_portfolio)
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

    print("\n=== is greedy_mix leaving money on the table? ===")
    print(render_certification(certification_rows(curves)))
    print("\nThe exact allocator explores the same decision space "
          "(measured footprints x\nreplica counts) by branch-and-bound; "
          "a zero gap is a certificate, not an\nassumption. Any loss "
          "would print as '!! greedy BEATEN'.")

    print("\n=== the 3-class blend: silo vs consolidated vs routed ===")
    for lam in PORTFOLIO_LAMS:
        print()
        print(render_portfolio(
            plan_portfolio(curves, BLENDED_3CLASS.scaled(lam),
                           chip_budget=8)))

    print("\nTwo honest surprises on this store: consolidation is the "
          "big win (one\npooled flagship fleet, ~67% off the silo "
          "bill), while routing classes to\ncheaper tiers LOSES money "
          "at every reference rate — fragmenting the pool\nacross "
          "three models re-introduces the underutilization penalty "
          "that\nconsolidation just removed. Routing only wins on "
          "$/M-token at saturation,\nwhere every fragment is busy. "
          "The router also refuses, never prices, a\nclass whose "
          "token budget exceeds a tier's measured decode length "
          "(paper\n§6.4 discipline).")


if __name__ == "__main__":
    main()
