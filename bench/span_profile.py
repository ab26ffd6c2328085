#!/usr/bin/env python3
"""Where a cell's time goes, by the program's own spans: one run of the
cell's program with the tracer (`repro_torch.tracing`) on under
`torch.profiler`, read by `bench/spans.py`. Not a benchmark run: it prints
no end-to-end metric and judges no tokens.

    python3 bench/span_profile.py --workload mixtral-8x7b-int8.chat-batch \
        --seed 7

Set-up is `bench/run.py`'s (the kernels, the seed's weights, the warm-up).
Then, with the profiler off, it times `COST_STEPS` decode steps of a full
batch with the tracer on and as many with it off, in turns: the step's
wall time and the host time of its dispatch (the step function's call),
and the cost of one span site. Then it serves the mix's warm-in,
`UNTRACED` seconds with the tracer off, and a traced window of `SECONDS`,
the tracer on inside the profiled window and a few anchors at each end. It prints one JSON line: the span metrics, the device time
by span, the idle time by span, the longest idle gaps named by span, how
much kernel time was put down through its launch, and how far the
executor's spans lie from the harness's call ranges; the whole report
goes to `chiprun_out/spans/<workload>.<seed>.json`.

Exit codes: 0 with a line; 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TOP = 10
ANCHORS = 5       # anchors taken at each end of the window
SECONDS = 20.0    # the traced window
UNTRACED = 15.0   # the window before it, tracer and profiler off
COST_STEPS = 100  # decode steps a mode in `step_cost`


def site_cost_ns(n: int = 200_000) -> dict:
    """ns a `with span(...)` site costs, off and on, over an empty loop."""
    from repro_torch import tracing

    def loop(body):
        t = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t) / n

    def empty():
        for _ in range(n):
            pass

    def sites():
        for _ in range(n):
            with tracing.span("layer.moe"):
                pass

    out = {}
    for mode in ("off", "on"):
        if mode == "on":
            tracing.enable()
        out[mode] = min(loop(sites) for _ in range(5)) - \
            min(loop(empty) for _ in range(5))
        tracing.disable()
        tracing.drain()
    return out


def step_cost(ex, ecfg, mix, steps: int) -> dict:
    """Decode steps of a full batch at the mix's longest prompt bucket,
    tracer off and on in turns (the order swapped every pair), the
    profiler off: the executor's wall ms each, and the host ms of the
    step function's call (its dispatch; the same timer in both modes, so
    it is not paced by the device where the step does not sync). The
    state is cleared after, as the warm-up leaves it."""
    import numpy as np
    import torch
    from bench import spans as sp
    from bench.run import lp_buckets
    from repro_torch import tracing
    B = ecfg["max_batch"]
    bt = np.zeros((B, ecfg["max_pages_per_seq"]), np.int32)
    lp = lp_buckets(mix)[-1]
    rng = np.random.default_rng(1)
    vocab = ex.cfg.vocab_size
    ex.prefill(rng.integers(0, vocab, (B, lp)).astype(np.int32),
               np.full(B, lp, np.int32), np.ones(B, bool), bt)
    tok, act = np.zeros(B, np.int32), np.ones(B, bool)
    ms = {"off": [], "on": []}
    host = {"off": [], "on": []}
    n_spans, self_ms = [], {}
    fn = ex.decode_fn

    def timed(*a):
        t = time.perf_counter_ns()
        r = fn(*a)
        host[mode].append((time.perf_counter_ns() - t) / 1e6)
        return r

    ex.decode_fn = timed
    try:
        for i in range(steps):
            for mode in (("off", "on") if i % 2 else ("on", "off")):
                if mode == "on":
                    tracing.enable()
                _, dt = ex.decode(tok, act, bt)
                if mode == "on":
                    tracing.disable()
                    spans = tracing.drain()
                    n_spans.append(len(spans))
                    for k, v in sp.self_ms(spans).items():
                        self_ms[k] = self_ms.get(k, 0.0) + v / steps
                ms[mode].append(1e3 * dt)
    finally:
        ex.decode_fn = fn
    for pool in ex.pools:
        for t in pool.values():
            t.zero_()
    ex.seq_lens.zero_()
    if ex.device.type == "cuda":
        torch.cuda.synchronize(ex.device)
    def cost(d):
        off, on = (statistics.median(d[m]) for m in ("off", "on"))
        return off, on, statistics.median(
            b - a for a, b in zip(d["off"], d["on"]))

    off, on, paired = cost(ms)
    d_off, d_on, d_paired = cost(host)
    return {"steps": steps, "off_ms": off, "on_ms": on,
            "on_cost_share": (on - off) / off,
            "paired_on_cost_ms": paired,
            "off_ms_iqr": _iqr(ms["off"]), "on_ms_iqr": _iqr(ms["on"]),
            "dispatch_off_ms": d_off, "dispatch_on_ms": d_on,
            "dispatch_on_cost_share": (d_on - d_off) / d_off,
            "paired_dispatch_on_cost_ms": d_paired,
            "dispatch_off_ms_iqr": _iqr(host["off"]),
            "dispatch_on_ms_iqr": _iqr(host["on"]),
            "spans_a_step": n_spans[-1],
            "host_self_ms_a_step": dict(sorted(
                self_ms.items(), key=lambda kv: -kv[1])),
            "off_ms_all": ms["off"], "on_ms_all": ms["on"],
            "dispatch_off_ms_all": host["off"],
            "dispatch_on_ms_all": host["on"]}


def _iqr(v) -> float:
    q = statistics.quantiles(v, n=4)
    return q[2] - q[0]


def profile_cell(workload: str, seed: int, seconds: float = SECONDS, *,
                 untraced: float = UNTRACED, cost_steps: int = COST_STEPS,
                 device="cuda", configure=None, mix=None,
                 log=print) -> dict:
    """One traced window of the cell's program, read by its spans (the
    module's docstring). The windows and `configure` and `mix` (as in
    `run.run_cell`) are the CPU rehearsal's to shorten."""
    import torch
    from bench import clock as clock_lib
    from bench import manifest as mf
    from bench import spans as sp
    from bench import trace as trace_lib
    from bench import traffic
    from bench.run import build_program
    from repro_torch import tracing
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CARD_ENGINE
    from repro_torch.serving import Engine, EngineConfig

    device = torch.device(device)
    manifest = mf.load_manifest()
    cell = mf.cell(manifest, workload)
    cfile = mf.load_config_file(manifest, cell["config"])
    mix = mix or mf.load_traffic(cell["traffic"])
    cfg = mf.model_config(cfile, get_config(cfile["arch"]))
    if configure is not None:
        cfg = configure(cfg)
    ecfg = dict(CARD_ENGINE)
    ex = build_program(cfg, cfile["quant"], seed, device, ecfg, mix, log)
    out = {"workload": workload, "seed": seed,
           "site_ns": site_cost_ns(),
           "step_cost": step_cost(ex, ecfg, mix, cost_steps)}
    log(f"spans: tracer cost {json.dumps(out['site_ns'])} ns a site; "
        f"a decode step off {out['step_cost']['off_ms']:.3f} ms, on "
        f"{out['step_cost']['on_ms']:.3f} ms")

    eng = Engine(EngineConfig(**ecfg), ex)
    reqs = traffic.requests(mix, mix["warm_s"] + untraced + seconds, seed,
                            cfg.vocab_size)
    clock = clock_lib.WallClock(eng)
    clock.start()
    if mix["warm_s"] > 0:
        eng.run(reqs, horizon=mix["warm_s"])
    w0 = eng.t
    if untraced > 0:
        eng.run(reqs, horizon=w0 + untraced)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    clock.range = torch.profiler.record_function
    a0 = [tracing.anchor() for _ in range(ANCHORS)]
    tracing.enable()
    t0 = eng.t
    eng.run(reqs, horizon=clock.now() + seconds)
    tracing.disable()
    a1 = [tracing.anchor() for _ in range(ANCHORS)]
    prof.__exit__(None, None, None)
    clock.range = None
    t1 = eng.t

    p = sp.read_profile(prof)
    n = ANCHORS
    spans = sp.Spans.mapped(tracing.drain(), sp.clock_map(
        list(zip(a0, p.anchors[:n])), list(zip(a1, p.anchors[-n:]))))
    # the window: the second call's start to the last call's end, as
    # `bench/trace.py` takes it (the profiler may still be starting)
    lo, hi = p.ranges[1][0], p.ranges[-1][1]
    p.kernels = [k for k in p.kernels if lo <= k[0] < hi]
    calls = sp.calls_in(spans, lo, hi)
    inside = [i for i in range(len(spans))
              if lo <= spans.start[i] and spans.end[i] <= hi]
    owner = sp.attribute(p, spans)
    tr = trace_lib.Trace([k[:3] for k in p.kernels],
                         [(s, e, trace_lib.LABELS[n]) for s, e, n
                          in p.ranges[1:]], lo, hi)
    n_dec = sum(1 for r in tr.ranges if r[2] == "decode call")
    window = hi - lo
    busy = tr.busy_s

    # ms in the window by (the call it lies in, innermost span): the
    # kernels' device time, and the spans' host self time
    dev_by_span, host_self = {}, {}
    for k, (i, _) in zip(p.kernels, owner):
        key = f"{spans.call(i)} / {spans.name[i] if i >= 0 else sp.OUTSIDE}"
        dev_by_span[key] = dev_by_span.get(key, 0.0) + 1e3 * (k[1] - k[0])
    child = [0.0] * len(spans)
    for i in inside:
        if spans.parent[i] >= 0:
            child[spans.parent[i]] += spans.end[i] - spans.start[i]
    for i in inside:
        key = f"{spans.call(i)} / {spans.name[i]}"
        host_self[key] = host_self.get(key, 0.0) + 1e3 * (
            spans.end[i] - spans.start[i] - child[i])
    gaps = sorted(sp.idle_gaps(p.kernels, spans, lo, hi, tr.label_at),
                  key=lambda g: -g[1])
    dispatch = sp.dispatch_ms(spans, calls)
    out.update({
        "card": _card(device),
        "window_s": window, "busy_s": busy,
        "engine_window": [t0, t1],
        "decode_calls": len(calls), "decode_ranges": n_dec,
        "metrics": {
            "moe_dequant_device_ms.batch": sp.device_ms_per_call(
                p, spans, owner, "moe.dequant", calls),
            "moe_route_device_ms.batch": sp.device_ms_per_call(
                p, spans, owner, "moe.route", calls),
            "decode_dispatch_ms.steady": (statistics.mean(dispatch)
                                          if dispatch else None),
            "idle_in_step_share.steady": 100.0 * sp.idle_inside(
                p.kernels, spans, "executor.step", lo, hi) / window,
            "queue_wait_p90_ms.steady": sp.queue_wait_p90_ms(
                reqs, t0, t1, eng.t),
        },
        "queue_wait_p90_ms_untraced": (sp.queue_wait_p90_ms(
            reqs, w0, t0, eng.t) if untraced > 0 else None),
        "elementwise_device_ms": (1e3 * tr.group_s("other", "decode call")
                                  / n_dec if n_dec else None),
        "device_idle_share": 100.0 * (1.0 - busy / window),
        "attributed": sp.attributed_shares(p, owner, trace_lib.group_of),
        "executor_in_ranges": sp.in_ranges(spans, p.ranges),
        "prefill_calls": len(sp.calls_in(spans, lo, hi,
                                         "executor.prefill")),
        "device_ms_by_span": dict(sorted(dev_by_span.items(),
                                         key=lambda kv: -kv[1])),
        "host_self_ms_by_span": dict(sorted(host_self.items(),
                                            key=lambda kv: -kv[1])),
        "idle_ms_by_span": {k: 1e3 * v for k, v in sorted(
            sp.idle_by_span(p.kernels, spans, lo, hi).items(),
            key=lambda kv: -kv[1])},
        "idle_gaps": [[n, 1e3 * d] for n, d in gaps[:TOP]],
        "dispatch_ms_quartiles": (
            statistics.quantiles(dispatch, n=4) if len(dispatch) > 1
            else dispatch),
    })
    return out


def _card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    from bench.run import power_limit
    return power_limit()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from bench.run import caches
    caches()
    import torch
    if not torch.cuda.is_available():
        print("bench/span_profile.py: needs a CUDA device", file=sys.stderr)
        return 2
    out = profile_cell(args.workload, args.seed)
    path = ROOT / "chiprun_out" / "spans" / \
        f"{args.workload}.{args.seed}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    brief = {k: v for k, v in out.items()
             if k not in ("host_self_ms_by_span",)}
    brief["step_cost"] = {k: v for k, v in out["step_cost"].items()
                          if not k.endswith("_all")}
    print(json.dumps(brief))
    return 0


if __name__ == "__main__":
    sys.exit(main())
