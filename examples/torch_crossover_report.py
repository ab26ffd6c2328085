"""Corrected crossover analysis (paper §5.6 + §6.3) on the PyTorch port:
where does self-hosting actually beat each API tier once utilization is
measured rather than assumed — and how asymmetric input/output pricing
moves the answer for different workload shapes.

Runs the `crossover_trio` plan (three (model, quant, TP) configs on
tpu-v5p, or on the book entry `--hw`) into a store under the examples'
own root; cells already there are read, not re-run.

    PYTHONPATH=src python examples/torch_crossover_report.py [--hw h100-sxm]
"""
import argparse

from repro_torch.core import c_naive, crossover_table
from repro_torch.core.pricing import API_TIERS
from repro_torch.experiments import PlanRunner, get_plan
from repro_torch.experiments.plans import on_hw
from repro_torch.experiments.store import example_store
from repro_torch.simulate import HW_BY_NAME


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default=None, choices=sorted(HW_BY_NAME),
                    help="run the plan on this entry instead of tpu-v5p")
    args = ap.parse_args(argv)
    plan = get_plan("crossover_trio")
    if args.hw:
        plan = on_hw(plan, args.hw)
    store = example_store(plan.name)
    cached = len(store.completed_ids(plan))
    print(f"crossover_trio: {cached}/{len(plan.cells)} cells in store "
          f"({store.dir})")
    records = PlanRunner(plan, store=store).run()
    by_group = {}
    for r in records:
        by_group.setdefault((r.model, r.quant, r.n_chips), []).append(r)

    for (arch, quant, chips), recs in by_group.items():
        price = recs[0].price_per_hr
        naive = c_naive(price, max(r.tps for r in recs))

        print(f"\n=== {arch} {quant} x{chips} on {recs[0].hw} "
              f"(${price:.2f}/hr) ===")
        print(f"  naive token-volume cost (assumes theta_max): "
              f"${naive:.3f}/MTok")
        print(f"  measured C_eff: ${recs[0].c_eff:.3f} at lam=1  ...  "
              f"${min(r.c_eff for r in recs):.3f} at saturation")
        for row in crossover_table(recs, accept_slo_mismatch=True):
            lam = row["lambda_star"]
            tag = ("always cheaper (<= lowest measured lam)"
                   if row["extrapolated"] else f"lam* = {lam:.2f} rps")
            print(f"    vs {row['tier']:<18} "
                  f"(${row['api_output_per_mtok']:>5.2f}/MTok out): {tag}")

    print("\n--- asymmetric API pricing by workload shape (paper §6.3) ---")
    print(f"{'tier':<18} {'chat 512:256':>13} {'RAG 4096:1024':>14} "
          f"{'codegen 100:500':>16}")
    for name, tier in API_TIERS.items():
        print(f"{name:<18} "
              f"{tier.blended(512, 256):>12.2f}$ "
              f"{tier.blended(4096, 1024):>13.2f}$ "
              f"{tier.blended(100, 500):>15.2f}$")
    print("self-hosting bills input and output tokens at the same "
          "GPU-time rate;\ngeneration-heavy shapes amplify its advantage.")


if __name__ == "__main__":
    main()
