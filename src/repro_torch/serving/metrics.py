"""Prometheus-style metrics registry with text exposition.

The live cost meter (repro.core.meter) consumes the *rendered text*, not
engine internals — reproducing the paper's design point that the meter
scrapes a /metrics endpoint any vLLM-compatible dashboard could also read.
Metric names mirror vLLM's (vllm:generation_tokens_total etc.) so the meter
is engine-agnostic.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Tuple

_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
            1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 120.0, math.inf)


class Histogram:
    """Bucketed histogram with amortized bookkeeping: observe() is an O(1)
    append; bucket counts and the sorted view are folded lazily on first
    read (render/percentile), which the engine hot loop never hits."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.total = 0.0
        self.n = 0
        self.samples: List[float] = []
        self._counts: List[int] = [0] * len(_BUCKETS)
        self._folded = 0                             # samples already bucketed
        self._sorted: Optional[List[float]] = None   # amortized-sort cache

    def observe(self, v: float):
        self.total += v
        self.n += 1
        self.samples.append(v)
        self._sorted = None

    @property
    def counts(self) -> List[int]:
        for v in self.samples[self._folded:]:
            self._counts[bisect.bisect_left(_BUCKETS, v)] += 1
        self._folded = len(self.samples)
        return self._counts

    def percentile(self, q: float) -> float:
        if not self.samples:
            return float("nan")
        if self._sorted is None:
            self._sorted = sorted(self.samples)
        s = self._sorted
        idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[idx]


class MetricsRegistry:
    """Counters, gauges and histograms; render() emits Prometheus text."""

    def __init__(self, labels: Optional[Dict[str, str]] = None):
        self.labels = labels or {}
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}

    def inc(self, name: str, v: float = 1.0):
        self.counters[name] = self.counters.get(name, 0.0) + v

    def set(self, name: str, v: float):
        self.gauges[name] = v

    def observe(self, name: str, v: float):
        self.hist(name).observe(v)

    def hist(self, name: str) -> Histogram:
        """Get-or-create a histogram; callers on hot paths may keep the
        returned object (reset() clears contents in place, so bound
        references stay live)."""
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        return h

    def reset(self):
        """Drop all recorded state (counters, gauges, histograms) — the
        warmup/measurement boundary in sweep protocols. Unlike clearing
        `counters`/`hists` piecemeal, this also flushes gauges so no
        stale time/running-request readings leak into the window.
        Histograms are cleared in place so pre-bound references survive."""
        self.counters.clear()
        self.gauges.clear()
        for h in self.hists.values():
            h.clear()

    def get(self, name: str) -> float:
        if name in self.counters:
            return self.counters[name]
        return self.gauges.get(name, 0.0)

    def percentile(self, name: str, q: float) -> float:
        h = self.hists.get(name)
        return h.percentile(q) if h else float("nan")

    def _label_str(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(self.labels.items()))
        return "{" + inner + "}"

    def render(self) -> str:
        """Prometheus text exposition format."""
        ls = self._label_str()
        out = []
        for name, v in sorted(self.counters.items()):
            out.append(f"# TYPE {name} counter")
            out.append(f"{name}{ls} {v}")
        for name, v in sorted(self.gauges.items()):
            out.append(f"# TYPE {name} gauge")
            out.append(f"{name}{ls} {v}")
        for name, h in sorted(self.hists.items()):
            out.append(f"# TYPE {name} histogram")
            cum = 0
            for b, c in zip(_BUCKETS, h.counts):
                cum += c
                le = "+Inf" if math.isinf(b) else repr(b)
                sep = "," if self.labels else ""
                lbl = self._label_str()[:-1] + sep + f'le="{le}"}}' if ls \
                    else f'{{le="{le}"}}'
                out.append(f"{name}_bucket{lbl} {cum}")
            out.append(f"{name}_sum{ls} {h.total}")
            out.append(f"{name}_count{ls} {h.n}")
        return "\n".join(out) + "\n"


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal scraper: plain counter/gauge samples (labels stripped)."""
    vals: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            key, v = line.rsplit(" ", 1)
            name = key.split("{")[0]
            vals[name] = float(v)
        except ValueError:
            continue
    return vals
