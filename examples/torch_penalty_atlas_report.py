"""Dense penalty-atlas report on the PyTorch port.

The paper's core claim is a *curve* — C_eff spans 2.5-36x driven by
offered load — but the 7-point ladder only samples it. The `paper_atlas`
plan densifies the load axis to a 25-point log-spaced continuum across
three hardware generations (450 cells). This example reads the committed
store through a copy under the examples' own root (running any missing
cells there through the fleet backend first) and prints, per (model,
hardware, quant), the dense penalty curve as sparkline-style buckets
plus the knee/half-cost loads the sparse ladders can only bracket.
`--hw h100-sxm` adds that entry as a fourth generation (its cells run
once, at the footprints of the generation nearest it in HBM).

    PYTHONPATH=src python examples/torch_penalty_atlas_report.py [--hw h100-sxm]
"""
import argparse
import math

from repro_torch.experiments import PlanRunner, get_plan
from repro_torch.experiments.analyze import penalty_atlas
from repro_torch.experiments.plans import on_hw
from repro_torch.experiments.store import example_store
from repro_torch.simulate import HW_BY_NAME

BARS = " .:-=+*#%@"


def _spark(vals, lo=1.0, hi=50.0):
    """Log-bucketed penalty sparkline: '@' is idle-edge pain, ' ' is the
    saturation floor."""
    out = []
    for v in vals:
        f = (math.log(max(v, lo)) - math.log(lo)) / \
            (math.log(hi) - math.log(lo))
        out.append(BARS[min(int(f * (len(BARS) - 1) + 0.5),
                            len(BARS) - 1)])
    return "".join(out)


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

    atlas = penalty_atlas(records)
    lams = atlas[0]["lams"]
    print(f"\n--- dense penalty curves: lambda continuum "
          f"{lams[0]:g}..{lams[-1]:g} req/s, {len(lams)} points "
          f"(idle '@' -> saturated ' ') ---\n")
    print(f"{'model':<24} {'hw':<9} {'quant':<5} curve"
          f"{'':<{max(len(lams) - 5, 1)}} {'knee':>7} {'half':>7} "
          f"{'spread':>7}")
    for row in atlas:
        print(f"{row['model']:<24} {row['hw']:<9} {row['quant']:<5} "
              f"[{_spark(row['penalty'])}] {row['knee_lambda']:>7.4g} "
              f"{row['half_cost_lambda']:>7.4g} {row['spread']:>6.1f}x")

    print("\n--- where 'substantial sustained load' begins (knee = first "
          "lambda within 25% of the cost floor) ---")
    by_hw = {}
    for row in atlas:
        by_hw.setdefault(row["hw"], []).append(row)
    for hw, rows in sorted(by_hw.items()):
        knees = [r["knee_lambda"] for r in rows]
        print(f"  {hw:<9} knees span {min(knees):g}..{max(knees):g} req/s "
              f"across {len(rows)} (model, quant) curves")
    print("\nBelow the knee the per-token price is dominated by idle "
          "hardware, not by the model — the paper's §7 warning, now "
          "locatable to a specific offered rate per deployment.")


if __name__ == "__main__":
    main()
