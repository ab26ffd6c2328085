"""The port's tracer (`repro_torch.tracing`) and its spans in the served
path, on the CPU.

- Off, `span` records nothing and never opens a profiler range.
- On, a reduced mixtral-8x7b in int8 served by `RealExecutor` yields the
  span tree of `PERF.md` §3: one `executor.step` a call, one `layer.*`
  pair a block, `moe.route` and three `moe.dequant` a MoE layer.
- The tokens are the same with the tracer on and off.
- `Request.admitted_time` lies between arrival and first token, in both
  scheduler paths.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import reduced
from repro_torch.models import init_params
from repro_torch.quant import BY_NAME
from repro_torch.serving import (ArrivalSpec, Engine, EngineConfig,
                                 RealExecutor, synth_requests)

ECFG = dict(max_batch=4, page_size=8, num_pages=128, max_pages_per_seq=16)
ENGINE = ("engine.iteration", "engine.admit", "engine.bookkeep")


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test starts and ends with the tracer off and nothing kept."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _mixtral():
    cfg = reduced("mixtral-8x7b", vocab=1024, layers=2)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=8, top_k=2, group_size=4))
    gen = torch.Generator().manual_seed(5)
    params = init_params(cfg, device="cpu", generator=gen, quant="int8")
    return cfg, params


def _serve(cfg, params, fast_forward=True, n=5):
    torch.set_num_threads(2)
    ex = RealExecutor(cfg, params, qcfg=BY_NAME["int8"], device="cpu",
                      **{k: ECFG[k] for k in ("num_pages", "page_size",
                                              "max_batch")})
    eng = Engine(EngineConfig(fast_forward=fast_forward, **ECFG), ex)
    reqs = synth_requests(ArrivalSpec(lam=40.0, n_requests=n, scale=0.05,
                                      seed=3))
    for r in reqs:
        r.prompt_len = min(r.prompt_len, 40)
        r.max_new_tokens = min(r.max_new_tokens, 6)
    tokens = collections.defaultdict(list)
    decode, prefill = ex.decode, ex.prefill

    def log(call, dt):
        """The call's tokens, logged, at a fixed duration: the schedule,
        and so every batch the MoE routes, depends on no wall clock."""
        def wrapped(*a):
            out, _ = call(*a)
            for s in np.flatnonzero(a[-2]):
                tokens[eng.slot_req[int(s)].rid].append(int(out[s]))
            return out, dt
        return wrapped

    ex.decode, ex.prefill = log(decode, 0.01), log(prefill, 0.05)
    eng.run(reqs)
    assert all(r.finish_time is not None for r in reqs)
    return dict(tokens), reqs


def test_off_records_nothing_and_opens_no_profiler_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with the tracer off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    a, b = tracing.span("x"), tracing.span("y")
    assert a is b
    with a:
        with b:
            pass
    cfg, params = _mixtral()
    _serve(cfg, params, n=2)
    assert tracing.drain() == []


def test_spans_nest_and_drain_once():
    tracing.enable()
    with tracing.span("a"):
        with tracing.span("b"):
            pass
        with tracing.span("c"):
            pass
    tracing.disable()
    with tracing.span("off"):
        pass
    spans = tracing.drain()
    assert [(s.name, s.parent) for s in spans] == [("a", -1), ("b", 0),
                                                   ("c", 0)]
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert spans[0].start_ns <= spans[1].start_ns <= spans[1].end_ns \
        <= spans[2].start_ns <= spans[2].end_ns <= spans[0].end_ns
    assert tracing.drain() == []


def test_anchor_opens_one_profiler_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0, t1 = tracing.anchor()
    assert t0 <= t1
    names = [e.name for e in prof.events()]
    assert names.count(tracing.ANCHOR) == 1


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def test_served_mixtral_int8_yields_the_span_tree():
    cfg, params = _mixtral()
    tracing.enable()
    _serve(cfg, params)
    tracing.disable()
    spans = tracing.drain()
    names = collections.Counter(s.name for s in spans)
    assert names["executor.decode"] > 0 and names["executor.prefill"] > 0
    assert all(s.end_ns is not None for s in spans)
    layers = cfg.num_layers
    for i, s in enumerate(spans):
        if s.name in ("executor.decode", "executor.prefill"):
            assert spans[s.parent].name == "engine.iteration"
            assert _children(spans, i) == ["executor.h2d", "executor.step",
                                           "executor.d2h"]
        elif s.name == "executor.step":
            kids = _children(spans, i)
            assert kids == (["step.embed"]
                            + ["layer.attn", "layer.moe"] * layers
                            + ["step.head"])
        elif s.name == "layer.moe":
            assert _children(spans, i) == ["moe.route", "moe.experts"]
        elif s.name == "moe.experts":
            assert _children(spans, i) == ["moe.dequant"] * 3
        elif s.name in ENGINE[1:]:
            assert spans[s.parent].name == "engine.iteration"
        elif s.name == "engine.iteration":
            assert s.parent == -1
    n_calls = names["executor.decode"] + names["executor.prefill"]
    assert names["executor.step"] == n_calls
    assert names["moe.dequant"] == 3 * layers * n_calls
    # a child lies inside its parent
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_tokens_identical_with_the_tracer_on_and_off():
    cfg, params = _mixtral()
    off, _ = _serve(cfg, params)
    tracing.enable()
    on, _ = _serve(cfg, params)
    tracing.disable()
    assert len(tracing.drain()) > 0
    assert on == off


@pytest.mark.parametrize("fast_forward", [True, False])
def test_admitted_time_between_arrival_and_first_token(fast_forward):
    cfg, params = _mixtral()
    _, reqs = _serve(cfg, params, fast_forward=fast_forward)
    for r in reqs:
        assert r.admitted_time is not None
        assert r.arrival_time <= r.admitted_time <= r.first_token_time
