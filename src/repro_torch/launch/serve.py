"""Serving entry point: engine + live cost meter under an offered-load schedule.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-30b-a3b \
        --quant int8 --lam 2 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --tier sim \
        --hw h100-sxm --lam 5 --requests 200

real tier (the default): the full configuration on the card, wall-clock
PyTorch execution through the hand-written kernels (attention; every
`linear` under `--quant int8`). `--quant` is one of `quant.BY_NAME`:
bf16, int8, fp8 (e4m3 weights dequantized to bf16, as the reference
emulates it) or fp8_native (the same arithmetic: the reference has no
native fp8 GEMM). `--device cpu` runs `reduced(arch, vocab=1024)` with
the kernels' plain versions instead. Every arch of `configs` is served by
name: llama31-8b, qwen3-30b-a3b, jamba-v0.1-52b, mixtral-8x7b,
xlstm-350m, phi3-medium-14b, codeqwen1.5-7b, nemotron-4-15b, granite-34b,
granite-moe-1b-a400m, qwen2-vl-7b (text only, M-RoPE over equal
positions, as the reference serves it) and llama4-maverick-400b-a17b
(text only, at a cut depth: `layers`); whisper-base, an
encoder-decoder, has no server, as in the reference (its path is
`models.prefill` and `models.decode_step`). On the card `check_card`
refuses what one card cannot serve (weights larger than its memory, such
as mixtral-8x7b or jamba-v0.1-52b in bf16, or llama4-maverick-400b-a17b
at its full 48 layers in any precision), and the card's peak
allocated memory is printed at the end. It prices at the hardware it runs
on: `cpu-node` on the CPU, and on the card the book entry of its name
(`CARD_HW`; a card without one raises).

sim tier: the full configuration on the calibrated step-time model of
`--hw` (default `h100-sxm`) over `--chips` chips, priced at that entry's
$/chip-hour; it needs no device. As in the reference, except that the
reference's default tier is `sim` on `tpu-v5e`.

The meter scrapes the engine's Prometheus text every 10 s of engine time
and prints the live $/M-tok.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import CostMeter, chip_hour_price
from repro_torch.models import init_params
from repro_torch.models.model import unit_size
from repro_torch.quant import BY_NAME
from repro_torch.serving import (ArrivalSpec, Engine, EngineConfig,
                                 RealExecutor, SimExecutor, synth_requests)
from repro_torch.serving.executors import resolve_device
from repro_torch.simulate import HW_BY_NAME, StepTimeModel

# On the card: room for 8 chat requests of 512 + 256 tokens at page 16
# (48 pages each), plus the trash page.
CARD_ENGINE = dict(max_batch=8, page_size=16, num_pages=8 * 48 + 1,
                   max_pages_per_seq=48)
CPU_ENGINE = dict(max_batch=8, page_size=16, num_pages=512,
                  max_pages_per_seq=32)
# the sim tier's engine, as the reference's
SIM_ENGINE = dict(max_batch=256, page_size=16, num_pages=65536,
                  max_pages_per_seq=64)
# card name (`torch.cuda.get_device_name`) -> its hardware-book entry
CARD_HW = {"NVIDIA H100 80GB HBM3": "h100-sxm"}


def card_hw(name: str) -> str:
    """The hardware-book entry the real tier prices a card at, by the
    card's name; a card without an entry raises rather than being priced
    at another's."""
    if name not in CARD_HW:
        raise ValueError(f"no hardware-book entry for the card {name!r}; "
                         f"known cards: {sorted(CARD_HW)}")
    return CARD_HW[name]


def real_tier_hw(device) -> str:
    """The entry the real tier on `device` prices at: `cpu-node` on the
    CPU, as the reference's real tier; on the card, `card_hw` of its
    name."""
    device = resolve_device(device)
    if device.type == "cpu":
        return "cpu-node"
    return card_hw(torch.cuda.get_device_name(device))


def check_card(cfg, quant: str, card_bytes: int):
    """Raise NotImplementedError for a model that one card of `card_bytes`
    cannot serve: weights larger than its memory (serving across cards
    is not ported; `cut_depth` serves the first layers). Every shape is taken: the int8 kernel takes any K and N
    (xlstm-350m's sLSTM projections, K or N 1365, among them)."""
    need = cfg.param_count() * BY_NAME[quant].weight_bytes
    if need > card_bytes:
        raise NotImplementedError(
            f"{cfg.name} in {quant}: {need / 1e9:.1f} GB of weights do not "
            f"fit one card of {card_bytes / 1e9:.1f} GB; serving across "
            "cards is not ported yet")


def cut_depth(cfg, layers: int):
    """`cfg` with only its first `layers` layers: every block kind of the
    stack kept, so `layers` must be a whole number of its repeating units
    (`models.model.unit_size`: jamba-v0.1-52b's 8, one attention layer and
    7 Mamba layers)."""
    unit = unit_size(cfg)
    if not 0 < layers <= cfg.num_layers or layers % unit:
        raise ValueError(f"{cfg.name}: {layers} layers is not a whole number "
                         f"of its {unit}-layer units (at most "
                         f"{cfg.num_layers})")
    return dataclasses.replace(cfg, num_layers=layers)


def build_engine(arch: str, *, tier: str = "real", hw: str = "h100-sxm",
                 n_chips: int = 1, device="cuda", seed: int = 0,
                 quant: str = "bf16", layers: Optional[int] = None
                 ) -> Engine:
    """The real-tier engine: the full `arch` on the card (refused by
    `check_card` where one card cannot serve it), or a reduced one with
    `device="cpu"`. Weights are random, drawn from `seed`, and quantized
    layer by layer to `quant` (a key of `quant.BY_NAME`). `layers`: on the
    card, only the first `layers` layers of the full stack, a whole number
    of its repeating units (`cut_depth`), at full width.

    `tier="sim"`: the full `arch` on the step-time model of the book
    entry `hw` over `n_chips` chips, as the reference builds it; `device`
    and `seed` are not read."""
    if tier == "sim":
        cfg = get_config(arch)
        stm = StepTimeModel(cfg, HW_BY_NAME[hw], n_chips=n_chips,
                            quant=quant)
        return Engine(EngineConfig(**SIM_ENGINE), SimExecutor(cfg, stm))
    if tier != "real":
        raise ValueError(f"unknown tier {tier!r}; expected 'real' or 'sim'")
    if quant not in BY_NAME:
        raise ValueError(f"unknown quant {quant!r}; known: {sorted(BY_NAME)}")
    device = resolve_device(device)
    if device.type == "cpu":
        # vocab 1024: the engine draws synthetic prompt ids from [0, 1000)
        cfg, ecfg = reduced(arch, vocab=1024), CPU_ENGINE
    else:
        cfg, ecfg = get_config(arch), CARD_ENGINE
        if layers is not None:
            cfg = cut_depth(cfg, layers)
        check_card(cfg, quant,
                   torch.cuda.get_device_properties(device).total_memory)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, device=device, generator=gen, quant=quant)
    ex = RealExecutor(cfg, params, num_pages=ecfg["num_pages"],
                      page_size=ecfg["page_size"],
                      max_batch=ecfg["max_batch"], qcfg=BY_NAME[quant],
                      device=device)
    return Engine(EngineConfig(**ecfg), ex)


def serve(eng: Engine, spec: ArrivalSpec, price_per_hr: float,
          tick_s: float = 10.0, log=print):
    """Drive `eng` over `spec`'s requests in `tick_s` slices of engine time,
    ticking the meter after each; returns (requests, meter)."""
    meter = CostMeter(price_per_hr, scrape=lambda: eng.metrics.render())
    reqs = synth_requests(spec)
    horizon = 0.0
    meter.tick()
    while any(r.finish_time is None and r.retries <= 2 for r in reqs):
        horizon += tick_s
        eng.run(reqs, horizon=horizon)
        s = meter.tick()
        if s:
            log(f"[meter t={s.t:8.1f}s] tps={s.tps:9.1f} "
                f"inflight={s.inflight:5.0f} $/MTok={s.c_eff:10.4f}")
        if horizon > 24 * 3600:
            break
    summ = meter.summary()
    log(f"\nmeter summary: best-minute=${summ['best_minute']:.4f} "
        f"worst-minute=${summ['worst_minute']:.4f} "
        f"avg=${summ['time_weighted_avg']:.4f}")
    done = [r for r in reqs if r.finish_time is not None]
    if done:
        log(f"completed {len(done)}/{len(reqs)}  "
            f"TTFT p50={1e3*float(np.median([r.ttft for r in done])):.1f}ms")
    return reqs, meter


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama31-8b")
    ap.add_argument("--tier", default="real", choices=["real", "sim"])
    ap.add_argument("--hw", default="h100-sxm", choices=sorted(HW_BY_NAME),
                    help="the sim tier's hardware-book entry (the real "
                         "tier prices at the hardware it runs on)")
    ap.add_argument("--chips", type=int, default=1,
                    help="the sim tier's chip count")
    ap.add_argument("--device", default="cuda",
                    help="the real tier's device")
    ap.add_argument("--quant", default="bf16", choices=sorted(BY_NAME))
    ap.add_argument("--lam", type=float, default=2.0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--io-shape", default="chat")
    ap.add_argument("--scale", type=float, default=None,
                    help="token-length scale (default 1.0, and 0.05 for "
                         "the real tier on the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-tier", default=None)
    ap.add_argument("--accept-slo-mismatch", action="store_true")
    args = ap.parse_args(argv)

    if args.tier == "sim":
        scale = 1.0
        eng = build_engine(args.arch, tier="sim", hw=args.hw,
                           n_chips=args.chips, quant=args.quant)
        price = chip_hour_price(args.hw, args.chips)
    else:
        device = resolve_device(args.device)
        scale = 0.05 if device.type == "cpu" else 1.0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        eng = build_engine(args.arch, device=device, seed=args.seed,
                           quant=args.quant)
        price = chip_hour_price(real_tier_hw(device))
    if args.scale is not None:
        scale = args.scale
    spec = ArrivalSpec(lam=args.lam, n_requests=args.requests,
                       io_shape=args.io_shape, scale=scale, seed=args.seed)
    _, meter = serve(eng, spec, price_per_hr=price)
    if args.tier == "real" and device.type == "cuda":
        print(f"peak memory: "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
              f"allocated on {torch.cuda.get_device_name(device)}")
    if args.compare_tier:
        print(meter.compare_api(
            args.compare_tier,
            accept_slo_mismatch=args.accept_slo_mismatch))


if __name__ == "__main__":
    main()
