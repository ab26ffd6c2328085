"""Quickstart on the PyTorch port: the concurrency-aware cost framework in
seconds.

Runs the `quickstart` experiment plan (the paper's dense reference config
on the simulated v5e tier, or on the book entry `--hw`, e.g. `h100-sxm`)
against a resumable store under the examples' own root (seeded from the
committed store, which is only read), then prints the C_eff(lambda)
curve, the underutilization penalty (the paper's headline 1/U factor),
and the API crossover table.

    PYTHONPATH=src python examples/torch_quickstart.py [--hw h100-sxm]
"""
import argparse

from repro_torch.core import crossover_table, slo_operating_point
from repro_torch.experiments import PlanRunner, get_plan
from repro_torch.experiments.plans import on_hw
from repro_torch.experiments.store import example_store
from repro_torch.simulate import HW_BY_NAME


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default=None, choices=sorted(HW_BY_NAME),
                    help="run the plan on this entry instead of tpu-v5e")
    args = ap.parse_args(argv)
    plan = get_plan("quickstart")
    if args.hw:
        plan = on_hw(plan, args.hw)
    hw = HW_BY_NAME[plan.cells[0].hw]
    store = example_store(plan.name)
    cached = len(store.completed_ids(plan))
    print(f"sweeping {plan.cells[0].arch} on {hw.name} "
          f"(${hw.price_per_chip_hr}/chip-hr) — "
          f"{cached}/{len(plan.cells)} cells already in {store.dir}")
    recs = PlanRunner(plan, store=store).run()

    print(f"\n{'lam':>5} {'tok/s':>9} {'$ / MTok':>9} {'penalty':>8} "
          f"{'TTFT p99':>10} {'in-flight':>9}")
    for r in recs:
        print(f"{r.lam:>5g} {r.tps:>9.0f} {r.c_eff:>9.3f} "
              f"{r.penalty:>7.1f}x {r.ttft_p99_ms:>8.0f}ms "
              f"{r.mean_inflight:>9.1f}")

    print("\nutilization is an OUTPUT: the idle-edge penalty above is the "
          "factor every\nfixed-utilization calculator is wrong by "
          "(paper: 2.5-24x at 1-10 rps).")

    print("\nAPI crossover (list output-token prices, no SLA attached):")
    for row in crossover_table(recs, accept_slo_mismatch=True):
        lam = row["lambda_star"]
        note = " (extrapolated)" if row["extrapolated"] else ""
        print(f"  {row['tier']:<18} ${row['api_output_per_mtok']:>5.2f}/MTok"
              f"  crossover at lam*={lam:.2f}{note}")

    slo = slo_operating_point(recs, ttft_p99_ms=300.0, tpot_p99_ms=50.0)
    print(f"\nSLA (TTFT p99<=300ms, TPOT p99<=50ms): feasible up to "
          f"lam={slo.lam_max}, ${slo.c_at_sla:.3f}/MTok "
          f"= {slo.premium:.2f}x the (SLA-infeasible: "
          f"{not slo.sat_feasible}) saturation floor ${slo.c_sat:.3f}")

    print(f"\nfull paper matrices: python -m repro_torch.experiments.run "
          f"--plan paper_a100 --resume --root examples_out/experiments")


if __name__ == "__main__":
    main()
