"""Reading the program's spans (`repro_torch.tracing`) beside a
`torch.profiler` trace of the same window.

The tracer times the host with `perf_counter_ns`; the profiler has a clock
of its own. An anchor (`tracing.anchor()`) is a `perf_counter_ns` pair
around one empty `repro.clock` range in the profile. A few are taken at
each end of the profiled window; the midpoints of the tightest at each end
give a linear map from the tracer's clock onto the profiler's
(`clock_map`). Every time
below is in seconds on the profiler's clock, counted from `Profile.base`.

A kernel is put down to the innermost span open on the host when it was
launched: its launch event (`cudaLaunchKernel`, `cuLaunchKernel`,
`cudaLaunchKernelExC`, `cudaMemcpyAsync`, ...) shares the kernel's
correlation id. A kernel with no launch event in the profile falls back
to its device start time. An idle stretch of the device is put down, piece
by piece, to the innermost span open on the host through it.

`bench/trace.py` reads the same profile for the accepted metrics and is
not changed by any of this.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from bench.trace import Trace

ANCHOR = "repro.clock"          # `repro_torch.tracing.ANCHOR`
LABELS = ("bench.prefill", "bench.decode")
OUTSIDE = "(no span)"
CALLS = ("executor.prefill", "executor.decode")


@dataclasses.dataclass
class Profile:
    """What `read_profile` takes from a finished profile: kernels
    `(start, end, name, correlation id)` on the device, launch times by
    correlation id and the harness's call ranges `(start, end, label)` on
    the host, and the anchors' ranges; seconds from `base` (ns)."""
    base: int
    kernels: List[Tuple[float, float, str, int]]
    launches: Dict[int, float]
    ranges: List[Tuple[float, float, str]]
    anchors: List[Tuple[float, float]]


def read_profile(prof) -> Profile:
    """The events of a finished `torch.profiler.profile` that this module
    reads. User annotations (the ranges, shown on the device's timeline
    too) are not kernels; a launch is a host event of a CUDA API call
    (its name starts with `cu`), whose correlation id is CUPTI's, as its
    kernel's is."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    evs = []
    for ev in prof.profiler.kineto_results.events():
        evs.append((ev.name(), ev.device_type() == cuda,
                    ev.is_user_annotation(), ev.correlation_id(),
                    ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    anchors = sorted((s, e) for n, dev, _, _, s, e in evs
                     if n == ANCHOR and not dev)
    base = anchors[0][0] if anchors else min(e[4] for e in evs)

    def sec(ns):
        return (ns - base) / 1e9

    kernels, launches, ranges = [], {}, []
    for name, dev, ann, corr, s, e in evs:
        if dev and not ann and name not in LABELS:
            kernels.append((sec(s), sec(e), name, corr))
        elif not dev and name in LABELS:
            ranges.append((sec(s), sec(e), name))
        elif not dev and name.startswith("cu"):
            launches[corr] = sec(s)
    return Profile(base, sorted(kernels), launches, sorted(ranges),
                   [(sec(s), sec(e)) for s, e in anchors])


Pair = Tuple[Tuple[int, int], Tuple[float, float]]


def tightest(pairs: Sequence[Pair]) -> Pair:
    """Of anchors taken one after another, the one whose `perf_counter_ns`
    pair brackets its range most closely (the first range of a profile
    can take a hundred times as long as the next)."""
    return min(pairs, key=lambda p: p[0][1] - p[0][0])


def clock_map(start: Sequence[Pair], end: Sequence[Pair]):
    """`f(ns) -> s`: the line through two anchors' midpoints, the tightest
    of those taken at the window's start and of those at its end; each
    pair is the tracer's `(before, after)` in ns and its range `(start,
    end)` in seconds on the profiler's clock."""
    (a0, r0), (a1, r1) = tightest(start), tightest(end)
    x0 = (a0[0] + a0[1]) // 2
    y0, y1 = (r0[0] + r0[1]) / 2, (r1[0] + r1[1]) / 2
    dx = ((a1[0] + a1[1]) // 2 - x0) / 1e9
    slope = (y1 - y0) / dx if dx > 0 else 1.0
    return lambda ns: y0 + slope * (ns - x0) / 1e9


@dataclasses.dataclass
class Spans:
    """Spans on the profiler's clock, in the order they opened: names,
    starts, ends and each one's parent index (-1 at the top)."""
    name: List[str]
    start: List[float]
    end: List[float]
    parent: List[int]

    @classmethod
    def mapped(cls, spans, f) -> "Spans":
        """`tracing.Span`s through the clock map `f`; a span left open
        is dropped with everything under it."""
        keep, index = [], {}
        for i, s in enumerate(spans):
            if s.end_ns is not None and (s.parent < 0 or s.parent in index):
                index[i] = len(keep)
                keep.append(s)
        return cls([s.name for s in keep], [f(s.start_ns) for s in keep],
                   [f(s.end_ns) for s in keep],
                   [index[s.parent] if s.parent >= 0 else -1
                    for s in keep])

    def __len__(self):
        return len(self.name)

    def innermost(self, t: float) -> int:
        """The index of the innermost span open at `t`, or -1. Spans nest:
        of those open at `t`, the one that opened last is the innermost."""
        i = bisect.bisect_right(self.start, t) - 1
        while i >= 0 and self.end[i] < t:
            i = self.parent[i]
        return i

    def call(self, i: int) -> str:
        """The `executor.*` span that span `i` lies in, or the name of its
        outermost span (`OUTSIDE` for -1)."""
        top = OUTSIDE
        while i >= 0:
            top = self.name[i]
            if top in CALLS:
                return top
            i = self.parent[i]
        return top

    def of(self, name: str, parent: Optional[str] = None) -> List[int]:
        return [i for i, n in enumerate(self.name) if n == name and (
            parent is None or (self.parent[i] >= 0
                               and self.name[self.parent[i]] == parent))]


def self_ms(spans) -> Dict[str, float]:
    """Host self ms by span name (a span's time less its children's) of
    `tracing.Span`s as drained, on the tracer's own clock."""
    child = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child[s.parent] += s.end_ns - s.start_ns
    out: Dict[str, float] = {}
    for s, c in zip(spans, child):
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns - c) / 1e6
    return out


def attribute(prof: Profile, spans: Spans) -> List[Tuple[int, bool]]:
    """For each kernel of `prof`: the innermost span at its launch (or,
    with no launch event, at its device start), and whether it was put
    down through its launch."""
    out = []
    for s, _, _, corr in prof.kernels:
        t = prof.launches.get(corr)
        out.append((spans.innermost(s if t is None else t), t is not None))
    return out


def idle(kernels, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which no kernel ran."""
    busy = Trace([k[:3] for k in kernels], [], lo, hi).merged()
    gaps, t = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    return gaps


def idle_by_span(kernels, spans: Spans, lo: float, hi: float
                 ) -> Dict[str, float]:
    """Idle seconds of [lo, hi] by the innermost span open on the host
    through them (`OUTSIDE` where none is): each idle stretch is cut at
    every span edge inside it. The values sum to the window's idle
    seconds."""
    edges = sorted(set(spans.start) | set(spans.end))
    out: Dict[str, float] = {}
    for s, e in idle(kernels, lo, hi):
        cut = [s] + edges[bisect.bisect_right(edges, s):
                          bisect.bisect_left(edges, e)] + [e]
        for a, b in zip(cut, cut[1:]):
            i = spans.innermost((a + b) / 2)
            key = spans.name[i] if i >= 0 else OUTSIDE
            out[key] = out.get(key, 0.0) + (b - a)
    return out


def idle_gaps(kernels, spans: Spans, lo: float, hi: float, fallback=None
              ) -> List[Tuple[str, float]]:
    """Each idle stretch, named by the innermost span open at its
    midpoint, or by `fallback(t)` (`bench/trace.py`'s labels) where none
    is."""
    out = []
    for s, e in idle(kernels, lo, hi):
        i = spans.innermost((s + e) / 2)
        name = (spans.name[i] if i >= 0 else
                fallback((s + e) / 2) if fallback else OUTSIDE)
        out.append((name, e - s))
    return out


def idle_inside(kernels, spans: Spans, name: str, lo: float, hi: float
                ) -> float:
    """Seconds of [lo, hi] in which no kernel ran and the host was inside
    a span named `name` (its children included)."""
    tot = 0.0
    gaps = idle(kernels, lo, hi)
    starts = [g[0] for g in gaps]
    for i in spans.of(name):
        a, b = max(spans.start[i], lo), min(spans.end[i], hi)
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        while j < len(gaps) and gaps[j][0] < b:
            tot += max(0.0, min(b, gaps[j][1]) - max(a, gaps[j][0]))
            j += 1
    return tot


def calls_in(spans: Spans, lo: float, hi: float,
             call: str = "executor.decode") -> List[int]:
    """The `call` spans that lie in [lo, hi]."""
    return [i for i in spans.of(call)
            if lo <= spans.start[i] and spans.end[i] <= hi]


def device_ms_per_call(prof: Profile, spans: Spans, owner, name: str,
                       calls: List[int]) -> Optional[float]:
    """Device ms per call of `calls` (span indices) of the kernels put
    down (`owner`, from `attribute`) to a span named `name` inside one of
    them; None without a call."""
    if not calls:
        return None
    of = set(calls)

    def in_call(i):
        while i >= 0 and i not in of:
            i = spans.parent[i]
        return i >= 0

    dev = sum(k[1] - k[0] for k, (i, _) in zip(prof.kernels, owner)
              if i >= 0 and spans.name[i] == name and in_call(i))
    return 1e3 * dev / len(calls)


def dispatch_ms(spans: Spans, calls: List[int]) -> List[float]:
    """Host ms of the `executor.step` span of each call of `calls`."""
    of = set(calls)
    return [1e3 * (spans.end[i] - spans.start[i])
            for i in spans.of("executor.step") if spans.parent[i] in of]


def in_ranges(spans: Spans, ranges, tol: float = 50e-6) -> dict:
    """The `executor.*` call spans against the harness's `bench.*` ranges
    (the n-th call span of a kind beside the n-th range of that kind):
    the share that lies inside its range to within `tol` s, the largest
    excursion outside it, and the quartiles of the margin (s; negative
    outside) by which each lies inside."""
    margin = []
    for call, label in zip(CALLS, LABELS):
        rs = [r for r in ranges if r[2] == label]
        ss = spans.of(call)
        if len(rs) != len(ss):
            return {"share": 0.0, "worst_s": math.inf, "n": len(ss),
                    "ranges": len(rs)}
        margin += [min(spans.start[i] - a, b - spans.end[i])
                   for i, (a, b, _) in zip(ss, rs)]
    if not margin:
        return {"share": 0.0, "worst_s": math.inf, "n": 0}
    return {"share": sum(m >= -tol for m in margin) / len(margin),
            "worst_s": max(0.0, -min(margin)), "n": len(margin),
            "margin_quartiles_s": (statistics.quantiles(margin, n=4)
                                   if len(margin) > 1 else margin)}


def attributed_shares(prof: Profile, owner, group_of) -> dict:
    """Per kernel group, and in all: the device seconds, the share put
    down to some span and the share put down through a launch event."""
    acc: Dict[str, List[float]] = {}
    for k, (i, by_launch) in zip(prof.kernels, owner):
        d = k[1] - k[0]
        for g in (group_of(k[2]), "all"):
            a = acc.setdefault(g, [0.0, 0.0, 0.0])
            a[0] += d
            a[1] += d if i >= 0 else 0.0
            a[2] += d if by_launch else 0.0
    return {g: {"device_s": a[0], "in_span": a[1] / a[0] if a[0] else 0.0,
                "by_launch": a[2] / a[0] if a[0] else 0.0}
            for g, a in acc.items()}


def queue_wait_p90_ms(requests, lo: float, hi: float, t_end: float
                      ) -> Optional[float]:
    """The 90th percentile of `admitted_time - arrival_time` over the
    requests due in [lo, hi); one never admitted counts until `t_end`.
    None where the program records no `admitted_time`."""
    import numpy as np
    due = [r for r in requests if lo <= r.arrival_time < hi]
    if not due or not all(hasattr(r, "admitted_time") for r in due):
        return None
    w = [(t_end if r.admitted_time is None else r.admitted_time)
         - r.arrival_time for r in due]
    return 1e3 * float(np.percentile(w, 90))
