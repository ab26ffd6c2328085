"""Cross-hardware replication report (paper §5.9 / §7) on the PyTorch
port.

The paper's strongest claim-robustness argument: the load-driven C_eff
spread reproduces across hardware generations with compressed magnitude
on the cheaper part, which rules out single-hardware confounding. This
example derives the spread-compression table, the native-fp8-conditioned
FP8-inversion table and the active-params ordering survival from the
committed `paper_crosshw` store, read through a copy under the examples'
own root (cells missing there are run once and persisted there).
`--hw h100-sxm` adds that entry as another generation.

    PYTHONPATH=src python examples/torch_crosshw_report.py [--hw h100-sxm]
"""
import argparse

from repro_torch.experiments import PlanRunner, get_plan
from repro_torch.experiments.analyze import (crosshw_ordering, fp8_inversion,
                                             spread_compression)
from repro_torch.experiments.plans import on_hw
from repro_torch.experiments.store import example_store
from repro_torch.simulate import HW_BY_NAME


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default=None, choices=sorted(HW_BY_NAME),
                    help="add this entry as another hardware generation")
    args = ap.parse_args(argv)
    plan = get_plan("paper_crosshw")
    if args.hw:
        plan = on_hw(plan, args.hw, add=True)
    store = example_store(plan.name)
    cached = len(store.completed_ids(plan))
    print(f"paper_crosshw: {cached}/{len(plan.cells)} cells in store "
          f"({store.dir})")
    records = PlanRunner(plan, store=store).run()

    print("\n--- spread compression: same models, three hardware "
          "generations, one store ---")
    for row in spread_compression(records):
        print(f"\n{row['model']} [{row['quant']}]")
        for h in row["per_hw"]:
            print(f"  {h['hw']:<9} x{h['n_chips']}: "
                  f"C_eff ${h['c_min']:.3f} .. ${h['c_max']:.3f} "
                  f"-> spread {h['spread']:.1f}x")
        print(f"  compression {row['compression']:.2f}x "
              f"(widest on {row['widest_hw']}, narrowest on "
              f"{row['narrowest_hw']})")

    print("\n--- fp8 uplift, conditioned on native-fp8 hardware ---")
    for r in fp8_inversion(records):
        native = "native " if r["native_fp8"] else "emulated"
        tag = "INVERTED" if r["inverted"] else "gain"
        flag = "" if r["consistent"] else "  !! breaks the hw-conditional story"
        print(f"  {r['hw']:<9} [{native}] {r['model']:<24} "
              f"{r['tps_uplift']:.2f}x TPS, {r['cost_ratio']:.2f}x cost "
              f"-> {tag}{flag}")

    print("\n--- active-params saturation ordering across hardware ---")
    for row in crosshw_ordering(records):
        tag = ("survives on every generation" if row["survives_all_hw"]
               else f"holds on {', '.join(row['holds_on']) or 'none'}")
        print(f"  [{row['quant']}] {tag} ({', '.join(row['hws'])})")


if __name__ == "__main__":
    main()
