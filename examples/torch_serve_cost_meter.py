"""The paper's six-phase live validation (§6.7) on the PyTorch port: a
server driven through six offered rates while the live cost meter scrapes
its Prometheus text, then the same six phases on the sim tier.

    PYTHONPATH=src python examples/torch_serve_cost_meter.py
    PYTHONPATH=src python examples/torch_serve_cost_meter.py --device cpu
    PYTHONPATH=src python examples/torch_serve_cost_meter.py --skip-real \
        --hw tpu-v5p

Real half (`RealExecutor`, wall clock), built by `launch.serve.build_engine`:
on the card (the default) the full-width llama31-8b in bf16 (32 layers,
d_model 4096, 32/8 heads; random weights from seed 0) on the card's engine
(8 slots, 385 pages of 16), priced at the card's hardware-book entry
(`launch.serve.real_tier_hw`: `h100-sxm`, $2.99/hr); with `--device cpu` a
reduced llama (vocab 1024: the engine draws prompt ids below 1000) on the
reference's CPU engine, priced at `cpu-node` ($1/hr), as the reference
prices its CPU run. Rates 0.5, 1, 2, 4, 2, 0.5 req/s, `--phase-s` seconds
each, chat requests (512 in : 256 out) times `--scale` (default 1.0 on
the card, 0.05 on the CPU, as the reference's CPU run). On an H100 80GB
HBM3 (700 W) the server peaked at 238-255 tokens/s with its 8 slots full
(`chip_smoke.py` phase 8 at `--scale 0.25`), so at `--scale 0.375`
(192 : 96) it serves at most ~2.7 req/s; measured there, the 4 req/s phase
queued (50 requests waiting at its peak, their TTFT p50 15.0 s) and the
backlog kept all 8 slots busy to the end of the run.

Sim half: the full llama31-8b on the step-time model of `--hw` (default
`h100-sxm`), the reference's engine and phases. `--hw tpu-v5p` prints what
the reference's example prints for its sim half.
"""
import argparse

from repro_torch.core import CostMeter, chip_hour_price
from repro_torch.launch.serve import build_engine, real_tier_hw
from repro_torch.serving import ArrivalSpec, synth_requests
from repro_torch.serving.executors import resolve_device
from repro_torch.simulate import HW_BY_NAME

REAL_PHASES = (0.5, 1, 2, 4, 2, 0.5)
SIM_PHASES = (1, 5, 15, 50, 15, 1)


def six_phase(eng, price, phases, phase_s, scale, label):
    meter = CostMeter(price, scrape=lambda: eng.metrics.render(),
                      minute_s=60.0)
    reqs, t0 = [], 0.0
    for i, lam in enumerate(phases):
        n = max(1, int(lam * phase_s))
        batch = synth_requests(ArrivalSpec(lam=lam, n_requests=n,
                                           seed=10 + i, scale=scale),
                               start=t0)
        t0 = max(r.arrival_time for r in batch)
        reqs += batch
    meter.tick()
    horizon = 0.0
    while any(r.finish_time is None for r in reqs):
        horizon += phase_s / 4
        eng.run(reqs, horizon=horizon)
        s = meter.tick()
        if s:
            print(f"  [{label} t={s.t:7.1f}s] tok/s={s.tps:9.1f} "
                  f"in-flight={s.inflight:4.0f}  $/MTok={s.c_eff:9.4f}",
                  flush=True)
        if horizon > 48 * 3600:
            break
    summ = meter.summary()
    done = [r for r in reqs if r.finish_time is not None]
    swing = "n/a (idle window)" if summ["swing"] is None \
        else f"{summ['swing']:.1f}x"
    print(f"  {label}: {len(done)}/{len(reqs)} ok | best-minute "
          f"${summ['best_minute']:.4f} worst ${summ['worst_minute']:.4f} "
          f"swing {swing} avg ${summ['time_weighted_avg']:.4f}", flush=True)
    return meter, reqs


def real_half(device="cuda", phase_s=20.0, scale=None):
    """The six phases on the real tier on `device`; returns (engine,
    meter, requests). `scale` defaults to 1.0 on the card and 0.05
    on the CPU."""
    device = resolve_device(device)
    on_cpu = device.type == "cpu"
    if scale is None:
        scale = 0.05 if on_cpu else 1.0
    hw = real_tier_hw(device)
    what = ("reduced llama on the CPU" if on_cpu
            else f"full llama31-8b bf16 on {device}")
    print(f"=== REAL tier: {what}, wall clock, priced at {hw} ===",
          flush=True)
    eng = build_engine("llama31-8b", device=device, seed=0, quant="bf16")
    meter, reqs = six_phase(eng, price=chip_hour_price(hw),
                            phases=REAL_PHASES, phase_s=phase_s, scale=scale,
                            label="real")
    return eng, meter, reqs


def sim_half(hw="h100-sxm"):
    """The six phases of the sim tier on the book entry `hw`; returns
    (engine, meter, requests)."""
    print(f"\n=== SIM tier: full llama31-8b on {hw} model clock ===")
    eng = build_engine("llama31-8b", tier="sim", hw=hw)
    meter, reqs = six_phase(eng, price=HW_BY_NAME[hw].price_per_chip_hr,
                            phases=SIM_PHASES, phase_s=120.0, scale=1.0,
                            label="sim")
    return eng, meter, reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-real", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the real half's device (cuda or cpu)")
    ap.add_argument("--phase-s", type=float, default=20.0,
                    help="seconds of arrivals in each real phase")
    ap.add_argument("--scale", type=float, default=None,
                    help="the real half's token-length scale (default 1.0 "
                         "on the card, 0.05 on the CPU)")
    ap.add_argument("--hw", default="h100-sxm", choices=sorted(HW_BY_NAME),
                    help="the sim half's hardware-book entry")
    args = ap.parse_args(argv)
    if not args.skip_real:
        real_half(args.device, args.phase_s, args.scale)
    sim_half(args.hw)
    print("\nany cost number quoted without a lambda attached is "
          "meaningless (paper §6.7).")


if __name__ == "__main__":
    main()
