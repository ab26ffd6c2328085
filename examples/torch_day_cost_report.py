"""Pricing a day of traffic on the PyTorch port: static vs autoscaled
footprints.

Views of the same question — "what does my 24h lambda(t) profile
actually cost?":

1. The committed `paper_diurnal` store's exact day table (read, never
   written): every per-replica rate any trajectory visits is a MEASURED
   stationary cell, so the static-vs-autoscaled verdict needs no
   interpolation.
2. A live CostMeter walkthrough: one engine on the sim tier of tpu-v5e
   (or of the book entry `--hw`, priced at its rate) driven through a
   lambda(t) stream with a dead-of-night trough. The fleet-level day
   table prices the trough as an explicit infinite-cost idle window; on
   a single fast-forwarding engine the clock leaps the empty span, so
   the same billed-but-idle seconds surface as a cost SPIKE in the
   window where traffic reopens — two renderings of one fact: idle time
   is money.

    PYTHONPATH=src python examples/torch_day_cost_report.py [--hw h100-sxm]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.experiments.analyze import (diurnal_tables,
                                             load_store_records,
                                             render_diurnal)
from repro_torch.serving import (Engine, EngineConfig, RateProfile,
                                 SimExecutor, meter_day_report)
from repro_torch.simulate import HW_BY_NAME, V5E, StepTimeModel


def committed_day_table():
    print("=== 1. exact day table from the committed paper_diurnal store "
          "===")
    try:
        records = load_store_records("paper_diurnal")
    except OSError:
        records = []
    if not records:
        print("store absent — run: PYTHONPATH=src python -m "
              "repro_torch.experiments.run --plan paper_diurnal --backend "
              "vector --root examples_out/experiments")
        return
    print(render_diurnal(diurnal_tables(records)))


def live_meter_walkthrough(hw=V5E, price_per_hr=1.2):
    print("\n=== 2. live meter through a trough-heavy lambda(t) stream ===")
    prof = RateProfile.piecewise([(30.0, 4.0), (120.0, 0.0), (30.0, 4.0)])
    cfg = get_config("llama31-8b")
    eng = Engine(EngineConfig(max_batch=64, page_size=16, num_pages=8192,
                              max_pages_per_seq=64),
                 SimExecutor(cfg, StepTimeModel(cfg, hw)))
    rep = meter_day_report(eng, price_per_hr=price_per_hr, profile=prof,
                           n_requests=240, seed=0, window_s=30.0)
    summ = rep["summary"]
    print(f"completed {rep['completed']}/{rep['requests']} requests over "
          f"{summ['minutes']:.0f} meter windows")
    worst = max(rep["window_costs"])
    for i, c in enumerate(rep["window_costs"]):
        tag = ""
        if c == float("inf"):
            tag = "  <- idle: billed, zero goodput"
        elif c == worst and worst > 2 * min(rep["window_costs"]):
            tag = "  <- the trough's billed-idle seconds land here"
        print(f"  window {i}: $/MTok = {c:10.4f}{tag}")
    swing = "n/a (idle window)" if summ["swing"] is None \
        else f"{summ['swing']:.1f}x"
    print(f"best ${summ['best_minute']:.4f}  worst ${summ['worst_minute']:.4f} "
          f"(idle windows: {summ['idle_minutes']:.0f})  swing {swing}  "
          f"avg ${summ['time_weighted_avg']:.4f}")
    print("\nan idle trough is a COST, not a gap in the data — the day "
          "table prices it as an explicit inf window; the live meter "
          "bills those seconds into the reopening window (paper §6.6, "
          "time-resolved).")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default=None, choices=sorted(HW_BY_NAME),
                    help="run the live walkthrough on this entry instead "
                         "of tpu-v5e")
    args = ap.parse_args(argv)
    committed_day_table()
    if args.hw:
        hw = HW_BY_NAME[args.hw]
        live_meter_walkthrough(hw, hw.price_per_chip_hr)
    else:
        live_meter_walkthrough()


if __name__ == "__main__":
    main()
