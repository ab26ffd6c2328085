"""Spans on the host's clock, inside the served path; off by default.

    from repro_torch import tracing
    tracing.enable()
    ...                                   # serve
    tracing.disable()
    spans = tracing.drain()               # [Span(name, start_ns, end_ns,
                                          #       parent), ...]

`span(name)` is a context manager at a layer boundary (the tree of names
is in `PERF.md` §3). Off, it returns one shared no-op context: no
allocation, no `torch.profiler.record_function`, no device operation and
no host-device synchronisation. On, it appends the span to an in-memory
list, timed by `time.perf_counter_ns`, with the index of the span that
was open around it (`parent`, -1 at the top). The list is handed over
once, by `drain()`. Spans time the host: a span around a kernel launch
ends when the launch returns, not when the kernel does.

`anchor()` ties the tracer's clock to `torch.profiler`'s: it opens one
empty `record_function(ANCHOR)` range and returns the `perf_counter_ns`
read on either side of it. Taken at the start and at the end of a
profiled window (a few at each end: a profile's first range can take a
hundred times as long as the next, and the tightest pair fixes the clock
best), the anchors and their ranges in the profile give a linear map
from one clock onto the other, so every span can be laid beside the
kernels without a profiler range per span (`bench/spans.py`).

The recording is one list for the process, written by the thread that
serves (the engine runs in one thread).
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

ANCHOR = "repro.clock"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]        # None while the span is still open
    parent: int                  # index of the enclosing span, -1 at the top


class _Off:
    """The shared context of every span while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recording:
    __slots__ = ("spans", "open")

    def __init__(self):
        self.spans: List[list] = []      # [name, start_ns, end_ns, parent]
        self.open: List[int] = []        # indices of the spans now open


class _On:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: _Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.i = len(rec.spans)
        rec.spans.append([self.name, time.perf_counter_ns(), None,
                          rec.open[-1] if rec.open else -1])
        rec.open.append(self.i)
        return None

    def __exit__(self, *exc):
        rec = self.rec
        rec.spans[self.i][2] = time.perf_counter_ns()
        rec.open.pop()
        return False


_on: Optional[_Recording] = None       # the recording while the tracer is on
_kept: Optional[_Recording] = None     # the last one, until drained


def span(name: str):
    """A span named `name` around the `with` block, while the tracer is
    on; otherwise a shared context that does nothing."""
    if _on is None:
        return _OFF
    return _On(_on, name)


def enable():
    """Start recording (into the recording not yet drained, if any)."""
    global _on, _kept
    if _on is None:
        _on, _kept = (_kept or _Recording()), None


def disable():
    """Stop recording; what was recorded waits for `drain()`."""
    global _on, _kept
    if _on is not None:
        _on, _kept = None, _on


def drain() -> List[Span]:
    """The spans recorded since the last drain, in the order they opened,
    and an empty recording from here on."""
    global _on, _kept
    rec = _on or _kept
    if rec is None:
        return []
    out = [Span(*s) for s in rec.spans]
    if _on is not None:
        _on = _Recording()
    else:
        _kept = None
    return out


def anchor() -> Tuple[int, int]:
    """(`perf_counter_ns` before, after) one empty `record_function`
    range named `ANCHOR`: under `torch.profiler`, the range's place on the
    profiler's clock lies between the two."""
    from torch.profiler import record_function
    t0 = time.perf_counter_ns()
    with record_function(ANCHOR):
        pass
    return t0, time.perf_counter_ns()
