#!/usr/bin/env python3
"""Run one cell of `BENCHMARK.json` once, on one H100, and print one JSON
line.

    python3 bench/run.py --workload mixtral-8x7b-int8.chat-batch \
        --seed 123 --seconds 35 --trace 0

The system under test is the port's served path, built as
`repro_torch.launch.serve.build_engine` builds it for the card (its
`CARD_ENGINE` and `check_card`; `RealExecutor` over `serving/runner.py`;
`serving.Engine.run`), except that the weights are this benchmark's:
made on the card from `--seed`, layer by layer, and handed to the
program's own `quant.quantize_tree`. Set-up builds the kernels (only in a
checkout's first run), makes the weights, warms up one prefill per 64-token
prompt bucket the mix can produce and a few decode steps, and clears the
state. The window then serves the mix's traffic for `--seconds` on the
wall clock (`bench/clock.py`). With `--trace 1` the run prints the
per-layer metrics instead of the end-to-end ones: those the wall clock
reads come from that same untraced window, and those the device reads
from a second window of at most `TRACE_S` seconds that follows it under
`torch.profiler`. After the windows the program is freed and its served
tokens are judged against the plain reference (`bench/correct.py`).

Exit codes: 0 with a result line; 2 without a card (or fewer than the cell
asks for); 3 if `jax`, `jaxlib`, `flax` or `repro` was loaded; 1 on any
other error. Nothing is printed as a result in those cases.
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KERNELS = ("flash_attention", "paged_attention", "int8_matmul")
# the traced window's most seconds
TRACE_S = 20.0


def forbidden_loaded():
    """Top-level names of loaded modules that the run may not hold,
    compared whole (`repro_torch` is not `repro`)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def lp_buckets(mix) -> list:
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    return sorted({-(-n // 64) * 64 for n in range(lo, hi + 1)})


def warm_up(ex, mix, vocab, ecfg, device):
    """One prefill at each prompt bucket of the mix and a few decode steps,
    all writing to the trash page; then the state is cleared."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    batch = ecfg["max_batch"]
    bt = np.zeros((batch, ecfg["max_pages_per_seq"]), np.int32)
    for lp in lp_buckets(mix):
        tokens = rng.integers(0, vocab, (batch, lp)).astype(np.int32)
        lens = np.full(batch, lp, np.int32)
        ex.prefill(tokens, lens, np.ones(batch, bool), bt)
    for _ in range(3):
        ex.decode(np.zeros(batch, np.int32), np.ones(batch, bool), bt)
    for pool in ex.pools:
        for t in pool.values():
            t.zero_()
    ex.seq_lens.zero_()
    ex.n_prefill_calls = ex.n_decode_steps = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_program(cfg, quant, seed, device, ecfg, mix, log=print):
    """The program's executor on this benchmark's weights, warmed up for
    `mix` and cleared: the kernels built (a checkout's first run only),
    `check_card` passed, and the card's peak memory counted from here."""
    import torch
    from bench import weights
    from repro_torch.launch.serve import check_card
    from repro_torch.quant import BY_NAME
    from repro_torch.serving import RealExecutor
    if device.type == "cuda":
        from repro_torch.kernels.build import build_all
        build_all(KERNELS)
        check_card(cfg, quant,
                   torch.cuda.get_device_properties(device).total_memory)
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    params = weights.program_params(cfg, quant, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"set-up: weights made and quantized in "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    ex = RealExecutor(cfg, params, num_pages=ecfg["num_pages"],
                      page_size=ecfg["page_size"],
                      max_batch=ecfg["max_batch"], qcfg=BY_NAME[quant],
                      device=device)
    warm_up(ex, mix, cfg.vocab_size, ecfg, device)
    log(f"set-up: warmed up in {time.perf_counter() - t:.3f} s")
    return ex


def percentile(values, q) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", manifest=None, configure=None, quant=None,
             fault=None, control=None, limits=None, mix=None,
             log=print, t_proc=None):
    """Serve one cell once; returns the printed line's dict, and under
    `"reference"` the statistics of the served tokens' gaps (`correct.
    gaps`: with `control`, the control's too, and the gaps themselves).

    `configure(cfg) -> cfg` and `device="cpu"` serve a smaller model on
    the kernels' plain versions (the CPU tests' rehearsal; never a
    measurement). `quant` serves another precision than the
    configuration's (the control of a bf16 cell: the program's own int8
    path), judged against the configuration's. `fault(kind, tokens,
    mask)` alters the tokens a call made (the tests' planted fault);
    `limits` and `mix` replace the cell's limits and traffic files."""
    import torch
    from bench import clock as clock_lib
    from bench import correct, manifest as mf, trace as trace_lib
    from bench import traffic
    from repro_torch.configs import get_config
    from repro_torch.core import CostMeter, chip_hour_price
    from repro_torch.launch.serve import CARD_ENGINE, real_tier_hw
    from repro_torch.serving import Engine, EngineConfig

    t_proc = T_PROC if t_proc is None else t_proc
    device = torch.device(device)
    manifest = manifest or mf.load_manifest()
    cell = mf.cell(manifest, workload)
    cfile = mf.load_config_file(manifest, cell["config"])
    mix = mix or mf.load_traffic(cell["traffic"])
    limits = limits or mf.load_limits(workload)
    cfg = mf.model_config(cfile, get_config(cfile["arch"]))
    if configure is not None:
        cfg = configure(cfg)
    stated = cfile["quant"]
    quant = quant or stated
    ecfg = dict(CARD_ENGINE)
    B = ecfg["max_batch"]

    log(f"set-up: imports done at {time.perf_counter() - t_proc:.3f} s")
    ex = build_program(cfg, quant, seed, device, ecfg, mix, log)
    eng = Engine(EngineConfig(**ecfg), ex)
    # a traced run serves a traced window after the measured one
    trace_s = min(seconds, TRACE_S) if trace else 0.0
    reqs = traffic.requests(mix, seconds + trace_s, seed, cfg.vocab_size)
    price = chip_hour_price(real_tier_hw(device))
    meter = CostMeter(price, scrape=eng.metrics.render)
    clock = clock_lib.WallClock(eng, fault)

    clock.start()
    if mix["warm_s"] > 0:
        eng.run(reqs, horizon=mix["warm_s"])
    w0 = eng.t
    setup_s = clock.t0 + w0 - t_proc
    meter.tick()
    eng.run(reqs, horizon=w0 + seconds)
    w1 = eng.t
    metered = meter.tick()
    w2, trace_data = w1, None
    if trace:
        # a traced window after the measured one: the profiler's own host
        # work slows the calls it records, so what the wall clock reads
        # comes from the window before it, and only what the device did
        # from this one
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        clock.range = torch.profiler.record_function
        t_traced = clock.now()
        eng.run(reqs, horizon=t_traced + trace_s)
        w2 = eng.t
        prof.__exit__(None, None, None)
        clock.range = None
    due = [r for r in reqs if w0 <= r.arrival_time < w2] \
        if mix["arrivals"]["process"] != "backlog" else []
    if due and mix["drain_s"] > 0:
        # the windows' requests only: later ones are never sent. The cap
        # runs on the wall clock, which a trace's processing has moved on
        eng.run([r for r in reqs if r.arrival_time < w2],
                horizon=clock.now() + mix["drain_s"])
    t_drained = eng.t
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    steps = clock_lib.contexts(clock.calls, B)
    in_window = [c for c in steps
                 if w0 - 1e-9 <= c.start and c.end <= w1 + 1e-9]
    n_tokens = sum(len(c.rids) for c in in_window)
    metrics, breakdown, dev_extra = {}, None, {}
    if not trace:
        for m in mf.metrics_of(manifest, workload, trace=False):
            v = _end_to_end(m["name"], reqs, due, clock, w0, w1, n_tokens,
                            setup_s, t_drained)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        traced = [c for c in steps
                  if t_traced <= c.start and c.end <= w2 + 1e-9]
        # the first traced call is left out: the profiler may still be
        # starting while it runs
        trace_data = trace_lib.read(prof, 1, len(traced) - 1)
        trace_data.steps = traced[1:]
        run = types.SimpleNamespace(cfg=cfg, quant=quant, batch=B,
                                    window=(w0, w1), steps=in_window,
                                    requests=reqs, stamps=clock.stamps,
                                    t_end=t_drained, trace=trace_data)
        for m in mf.metrics_of(manifest, workload, trace=True):
            v = mf.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
            else:
                log(f"trace: {m['name']} found nothing to read")
        for group in KERNELS:
            seen = collections.Counter(
                n for n, _ in trace_data.per_call(group) if n)
            log(f"trace: {group} launches a call: {dict(seen)}")
        breakdown = trace_data.breakdown()
        dev_extra = {"busy_s": trace_data.busy_s,
                     "window_s": trace_data.window_s}

    if mix["arrivals"]["process"] == "backlog":
        judged = [r for r in reqs if r.rid in clock.tokens]
        finished = [r for r in judged if r.finish_time is not None]
        lost = 0
    else:
        judged = due
        finished = [r for r in due if r.finish_time is not None]
        lost = len(due) - len(finished)
    short = correct.accounting(finished, clock)
    mrel = (correct.meter_rel(metered.c_eff, price, n_tokens, w1 - w0)
            if metered is not None and n_tokens else math.inf)
    log(f"engine: {len(finished)} finished, {ex.n_prefill_calls} prefill "
        f"calls, {ex.n_decode_steps} decode steps, "
        f"{eng.n_iterations} iterations; window {w0:.3f}-{w1:.3f} s, "
        f"{n_tokens} tokens; set-up {setup_s:.3f} s")
    log(f"meter: {metered.c_eff if metered else math.nan:.6f} $/M-tok at "
        f"${price}/hr over the window (C_eff, not a metric)")
    log("engine histograms (engine clock = wall clock; not metrics): " +
        " ".join(ln for ln in eng.metrics.render().splitlines()
                 if "_sum " in ln or "_count " in ln))

    # the program's state goes before the reference runs
    clock.detach()
    eng.ex = None
    del ex, eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # coupled rows: the replay judges every token served, finished or not
    chosen = (judged if correct.reference.coupled(cfg, stated)
              else correct.sample(finished, seed, clock.tokens,
                                  correct.slots_of(clock.calls)))
    g = (correct.gaps(cfg, cfile, seed, clock, chosen, ecfg, device,
                      stated, control)
         if chosen else {"n_tokens": 0})
    log(f"reference: {len(chosen)} requests, {g['n_tokens']} served tokens "
        f"compared; " + ", ".join(f"{k} {v!r}" for k, v in g.items()
                                  if k != "n_tokens" and k[0] != "_"))
    tokens = [k for k in limits if k in correct.TOKEN_STATS]
    checks = {k: {"value": g.get(k, math.inf), "limit": limits[k]}
              for k in tokens}
    checks.update({
        "tokens_short": {"value": short, "limit": 0},
        "lost": {"value": lost, "limit": 0},
        "meter_rel": {"value": mrel, "limit": limits["meter_rel"]},
    })
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    ctl = None
    if control is not None:
        # the control, put in the program's place, held to the same
        # limits: only its tokens differ, so only their numbers are its
        cchecks = {k: {"value": g.get("control_" + k, math.inf),
                       "limit": limits[k]} for k in tokens}
        ctl = {"correct": all(c["value"] <= c["limit"]
                              for c in cchecks.values()),
               "checks": cchecks}
    result = {
        "correct": bool(ok),
        "attempted": len(judged),
        "failed": lost + short,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak), **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["reference"] = g
    if ctl is not None:
        result["control"] = ctl
    result["checks"] = checks
    return result


def finite(x):
    """`x` with every non-finite float as None: the line stays JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _end_to_end(name, reqs, due, clock, w0, w1, n_tokens, setup_s,
                t_drained):
    import numpy as np
    if name == "setup_s":
        return setup_s
    if name == "output_tok_per_s":
        return n_tokens / (w1 - w0)
    if name == "ttft_p90_ms":
        # a request that never got a token waited at least until the end
        ttft = [(clock.stamps[r.rid][0] if r.rid in clock.stamps
                 else t_drained) - r.arrival_time for r in due]
        return 1e3 * percentile(ttft, 90) if ttft else math.inf
    if name == "itl_p99_ms":
        gaps = [np.diff(clock.stamps[r.rid]) for r in due
                if len(clock.stamps.get(r.rid, ())) > 1]
        return 1e3 * percentile(np.concatenate(gaps), 99) if gaps \
            else math.inf
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches()
    import torch
    from bench import manifest as mf
    manifest = mf.load_manifest()
    chips = mf.cell(manifest, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench/run.py: needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), manifest=manifest)
    bad = forbidden_loaded()
    if bad:
        print(f"bench/run.py: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()} (power limit beside every share)")
    del result["reference"]
    print(json.dumps(finite(result)))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
