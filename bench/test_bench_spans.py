"""`bench/spans.py`, the reading of the program's spans beside a profile,
on synthetic traces; and its CPU rehearsals.

- Kernels are put down to the innermost span at their launch, found by
  correlation id, and at their device start where no launch is recorded.
- The anchors' map recovers a planted offset and drift.
- The idle time by span sums to the window's idle share, and idle gaps
  take the innermost span's name, or the fallback label outside spans.
- Each span metric reads as computed by hand.
- A traced CPU rehearsal of `nemotron-4-15b-bf16.coding-steady` reports
  `queue_wait_p90_ms.steady` through the benchmark, and the span profile
  reports `decode_dispatch_ms.steady` and the queue wait.
"""
import math
import types

import pytest

from bench import manifest as mf
from bench import rehearsal
from bench import spans as sp
from bench import trace as trace_lib
from repro_torch import tracing

W = "nemotron-4-15b-bf16.coding-steady"


def _tree():
    """Two decode calls, each h2d [0, 1], step [1, 8] (embed, a layer.moe
    with route [3, 4] and one dequant [4, 6], head), d2h [8, 10]; the
    second call offset by 10. Seconds."""
    name, start, end, parent = [], [], [], []

    def add(n, s, e, p):
        name.append(n), start.append(s), end.append(e), parent.append(p)
        return len(name) - 1

    for o in (0.0, 10.0):
        it = add("engine.iteration", o, o + 10.0, -1)
        c = add("executor.decode", o, o + 10.0, it)
        add("executor.h2d", o, o + 1.0, c)
        st = add("executor.step", o + 1.0, o + 8.0, c)
        add("step.embed", o + 1.0, o + 2.0, st)
        m = add("layer.moe", o + 2.0, o + 7.0, st)
        add("moe.route", o + 3.0, o + 4.0, m)
        ex = add("moe.experts", o + 4.0, o + 7.0, m)
        add("moe.dequant", o + 4.0, o + 6.0, ex)
        add("step.head", o + 7.0, o + 8.0, st)
        add("executor.d2h", o + 8.0, o + 10.0, c)
    return sp.Spans(name, start, end, parent)


def _profile(kernels, launches=None):
    return sp.Profile(0, kernels, launches or {}, [], [])


def test_kernels_go_to_the_span_of_their_launch():
    spans = _tree()
    # launched in moe.route (3.5) but run in d2h's time (8.5): by launch;
    # one with no launch event, by its device start (4.5: dequant)
    prof = _profile([(8.5, 8.6, "k_route", 7), (4.5, 4.7, "k_deq", 99),
                     (12.0, 12.5, "k_embed", 8)],
                    {7: 3.5, 8: 11.5})
    owner = sp.attribute(prof, spans)
    assert [spans.name[i] for i, _ in owner] == ["moe.route", "moe.dequant",
                                                 "step.embed"]
    assert [b for _, b in owner] == [True, False, True]
    shares = sp.attributed_shares(prof, owner, trace_lib.group_of)
    assert shares["all"]["in_span"] == 1.0
    assert shares["all"]["by_launch"] == pytest.approx(0.6 / 0.8)


def test_innermost_walks_up_to_the_open_parent():
    spans = _tree()
    assert spans.name[spans.innermost(3.5)] == "moe.route"
    assert spans.name[spans.innermost(6.5)] == "moe.experts"
    assert spans.name[spans.innermost(7.5)] == "step.head"
    assert spans.name[spans.innermost(9.0)] == "executor.d2h"
    assert spans.innermost(-1.0) == -1 and spans.innermost(21.0) == -1
    assert spans.call(spans.innermost(4.5)) == "executor.decode"
    assert spans.call(-1) == sp.OUTSIDE


def test_anchor_map_recovers_offset_and_drift():
    # the profiler's clock = 1.75e9 s + (1 + 2e-5) x the tracer's, here
    # in seconds from a base; two anchors 30 s apart, each a 40 us range
    offset, drift = 12.345678, 1 + 2e-5

    def prof_s(ns):
        return offset + drift * ns / 1e9

    a0 = (5_000_000_000, 5_000_080_000)
    a1 = (35_000_000_000, 35_000_060_000)
    r0 = (prof_s(a0[0] + 20_000), prof_s(a0[0] + 60_000))
    r1 = (prof_s(a1[0] + 10_000), prof_s(a1[0] + 50_000))
    # a loose anchor at the start (the profile's first range is slow)
    loose = ((a0[0] - 400_000, a0[1] + 300_000), r0)
    f = sp.clock_map([loose, (a0, r0)], [(a1, r1)])
    for ns in (a0[0], 17_000_000_000, a1[1], 40_000_000_000):
        assert abs(f(ns) - prof_s(ns)) < 1e-6
    mapped = sp.Spans.mapped(
        [tracing.Span("a", 6_000_000_000, 7_000_000_000, -1),
         tracing.Span("open", 7_500_000_000, None, -1),
         tracing.Span("lost", 7_600_000_000, 7_700_000_000, 1)], f)
    assert mapped.name == ["a"] and mapped.parent == [-1]
    assert mapped.start[0] == pytest.approx(prof_s(6e9), abs=1e-6)


def test_idle_by_span_sums_to_the_idle_share():
    spans = _tree()
    kernels = [(0.5, 1.5, "a"), (1.2, 2.5, "b"), (4.5, 5.0, "c"),
               (9.0, 12.0, "d"), (13.5, 14.0, "e")]
    lo, hi = 0.0, 21.0
    tr = trace_lib.Trace(list(kernels), [], lo, hi)
    by = sp.idle_by_span(kernels, spans, lo, hi)
    assert sum(by.values()) == pytest.approx(hi - lo - tr.busy_s)
    assert 100 * sum(by.values()) / (hi - lo) == pytest.approx(
        100 * (1 - tr.busy_s / tr.window_s))
    # idle 2.5-4.5: layer.moe self 2.5-3 and 4-... route 3-4, dequant 4-4.5
    assert by["moe.route"] == pytest.approx(1.0 + 0.5)
    assert by[sp.OUTSIDE] == pytest.approx(1.0)         # 20 to 21
    gaps = sp.idle_gaps(kernels, spans, lo, hi, lambda t: "fallback")
    assert gaps[0] == ("executor.h2d", 0.5)
    assert gaps[-1] == ("step.head", pytest.approx(7.0))  # 14-21, mid 17.5
    assert sum(d for _, d in gaps) == pytest.approx(sum(by.values()))
    # a gap whose midpoint no span holds takes the fallback's label
    gaps = sp.idle_gaps(kernels, spans, lo, 30.0, lambda t: "fallback")
    assert gaps[-1] == ("fallback", pytest.approx(16.0))


def test_span_metrics_read_as_computed_by_hand():
    spans = _tree()
    calls = sp.calls_in(spans, 0.0, 20.0)
    assert len(calls) == 2
    # dequant kernels 0.2 + 0.3 s, route 0.1 s, and a dequant kernel
    # launched outside any decode call (not counted)
    prof = _profile([(4.1, 4.3, "x", 1), (14.1, 14.4, "y", 2),
                     (3.2, 3.3, "z", 3), (25.0, 25.5, "w", 4)],
                    {1: 4.05, 2: 14.05, 3: 3.1, 4: 24.0})
    owner = sp.attribute(prof, spans)
    assert sp.device_ms_per_call(prof, spans, owner, "moe.dequant",
                                 calls) == pytest.approx(1e3 * 0.5 / 2)
    assert sp.device_ms_per_call(prof, spans, owner, "moe.route",
                                 calls) == pytest.approx(1e3 * 0.1 / 2)
    assert sp.device_ms_per_call(prof, spans, owner, "moe.route",
                                 []) is None
    assert sp.dispatch_ms(spans, calls) == [pytest.approx(7e3)] * 2
    # idle inside executor.step (1-8 and 11-18): the kernels cover
    # 4.1-4.3, 3.2-3.3 and 14.1-14.4, so 7 - 0.3 + 7 - 0.3 s idle
    kernels = [k[:3] for k in prof.kernels]
    assert sp.idle_inside(kernels, spans, "executor.step", 0.0, 20.0) \
        == pytest.approx(14.0 - 0.6)


def test_host_self_time_leaves_out_the_children():
    got = sp.self_ms([tracing.Span("a", 0, 10_000_000, -1),
                      tracing.Span("b", 1_000_000, 4_000_000, 0),
                      tracing.Span("b", 5_000_000, 6_000_000, 0),
                      tracing.Span("c", 2_000_000, 3_000_000, 1)])
    assert got == {"a": 6.0, "b": 3.0, "c": 1.0}


def test_executor_spans_against_the_harness_ranges():
    spans = _tree()
    ranges = [(-20e-6, 10.0 + 20e-6, "bench.decode"),
              (10.0 + 80e-6, 20.0, "bench.decode")]
    got = sp.in_ranges(spans, ranges)
    assert got["n"] == 2 and got["share"] == 0.5
    assert got["worst_s"] == pytest.approx(80e-6)
    assert sp.in_ranges(spans, ranges[:1])["share"] == 0.0


def test_queue_wait_reads_admitted_time():
    reqs = [types.SimpleNamespace(arrival_time=float(i), admitted_time=i
                                  + 0.1 * i) for i in range(10)]
    reqs.append(types.SimpleNamespace(arrival_time=9.5, admitted_time=None))
    run = types.SimpleNamespace(requests=reqs, window=(0.0, 10.0),
                                t_end=12.0)
    want = [0.1 * i for i in range(10)] + [2.5]
    import numpy as np
    v = mf.reader("queue_wait_p90_ms.steady")(run)
    assert v == pytest.approx(1e3 * np.percentile(want, 90))
    # a program that records no admission time: nothing to read
    run.requests = [types.SimpleNamespace(arrival_time=1.0)]
    assert mf.reader("queue_wait_p90_ms.steady")(run) is None


def test_read_profile_finds_anchors_and_ranges():
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        a0 = tracing.anchor()
        with torch.profiler.record_function("bench.decode"):
            torch.ones(4).sum()
        a1 = tracing.anchor()
    p = sp.read_profile(prof)
    assert len(p.anchors) == 2 and p.anchors[0][0] == 0.0
    assert [r[2] for r in p.ranges] == ["bench.decode"]
    f = sp.clock_map([(a0, p.anchors[0])], [(a1, p.anchors[-1])])
    # the range lies between the anchors on both clocks
    assert f(a0[0]) <= p.ranges[0][0] + 1e-4
    assert p.ranges[0][1] <= f(a1[1]) + 1e-4


def test_traced_rehearsal_reports_queue_wait():
    from bench import run as run_lib
    r = run_lib.run_cell(W, 2 ** 31 + 17, 3.0, True, device="cpu",
                         configure=rehearsal.narrow(),
                         mix=rehearsal.short(W), log=lambda *a: None)
    m = r["metrics"]
    assert m["queue_wait_p90_ms.steady"]["value"] >= 0
    assert m["queue_wait_p90_ms.steady"]["value"] <= \
        m["ttft_p90_ms.steady"]["value"]


def test_span_profile_rehearsal_reports_dispatch_and_queue_wait():
    import torch
    from bench import span_profile
    torch.set_num_threads(2)
    out = span_profile.profile_cell(
        W, 2 ** 31 + 23, 3.0, untraced=0.0, cost_steps=3, device="cpu",
        configure=rehearsal.narrow(), mix=rehearsal.short(W),
        log=lambda *a: None)
    m = out["metrics"]
    assert m["decode_dispatch_ms.steady"] > 0
    assert m["queue_wait_p90_ms.steady"] >= 0
    assert out["site_ns"]["off"] < out["site_ns"]["on"]
    # executor.decode; h2d, step, d2h; embed, head; 2 layers x (attn, ffn)
    assert out["step_cost"]["spans_a_step"] == 1 + 3 + 2 + 2 * 2
    assert out["step_cost"]["host_self_ms_a_step"]["layer.attn"] > 0
    assert len(out["step_cost"]["dispatch_off_ms_all"]) == 3
    assert 0 < out["step_cost"]["dispatch_on_ms"] < out["step_cost"]["on_ms"]
    assert out["executor_in_ranges"]["share"] == 1.0
    assert all(math.isfinite(v) for v in out["idle_ms_by_span"].values())
    assert tracing.span("x") is tracing.span("y")      # left off
