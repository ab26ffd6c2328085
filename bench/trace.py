"""Reading a `torch.profiler` trace of the window.

`group_of` is a frozen copy of `scripts/torch_serve_profile.py::group_of`
(commit 81c71db): the device kernels by group. The harness marks each
executor call with a `record_function` range (`bench.prefill`,
`bench.decode`); the time outside them is the engine's own host work.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

LABELS = {"bench.prefill": "prefill call", "bench.decode": "decode call"}


def group_of(name: str) -> str:
    n = name.lower()
    if "paged_attention" in n:
        return "paged_attention"
    if "flash_attention" in n:
        return "flash_attention"
    if "int8_matmul" in n:
        return "int8_matmul"
    if "ssm_scan" in n:
        return "ssm_scan"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                            "splitk")):
        return "matmul"
    return "other"


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[float, float, str]]     # (start s, end s, name)
    ranges: List[Tuple[float, float, str]]      # (start s, end s, label)
    start: float
    end: float
    # the traced window's executor calls (`clock.Call`), in order
    steps: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.ranges.sort()
        self._starts = [r[0] for r in self.ranges]

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def merged(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for s, e, _ in sorted(self.kernels):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged())

    def group_s(self, group: str, label: str = None) -> float:
        """Device seconds of a kernel group, optionally only of kernels
        that start inside ranges of `label`."""
        ks = [k for k in self.kernels if group_of(k[2]) == group]
        if label is not None:
            ks = [k for k in ks if self.label_at(k[0]) == label]
        return sum(e - s for s, e, _ in ks)

    def count(self, group: str) -> int:
        return sum(1 for k in self.kernels if group_of(k[2]) == group)

    def per_call(self, group: str) -> List[Tuple[int, float]]:
        """(launches, device seconds) of a kernel group in each call's
        range, in the order of `ranges` (and of `steps`)."""
        out = [[0, 0.0] for _ in self.ranges]
        for s, e, name in self.kernels:
            if group_of(name) != group:
                continue
            i = bisect.bisect_right(self._starts, s) - 1
            if i >= 0 and s <= self.ranges[i][1]:
                out[i][0] += 1
                out[i][1] += e - s
        return [(n, t) for n, t in out]

    def label_at(self, t: float) -> str:
        """What the host was doing at `t`: the call whose range holds it,
        or the engine's own work between calls."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self.ranges[i][0] <= t <= self.ranges[i][1]:
            return self.ranges[i][2]
        return "engine"

    def idle_gaps(self) -> List[Tuple[str, float]]:
        gaps, t = [], self.start
        for s, e in self.merged() + [(self.end, self.end)]:
            if s > t:
                gaps.append((self.label_at((s + t) / 2), s - t))
            t = max(t, e)
        return gaps

    def breakdown(self, n: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for s, e, name in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:n]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _events(prof):
    res = prof.profiler.kineto_results
    for ev in res.events():
        if hasattr(ev, "start_ns"):
            s, d = ev.start_ns() / 1e9, ev.duration_ns() / 1e9
        else:
            s, d = ev.start_us() / 1e6, ev.duration_us() / 1e6
        yield ev.name(), ev.device_type(), s, s + d


def read(prof, first: int, last: int) -> Trace:
    """The window's kernels and call ranges from a finished profile. The
    profile holds the executor calls in order, one range each; the window
    runs from the start of call `first` to the end of call `last`."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ranges = [], []
    for name, dev, s, e in _events(prof):
        if name in LABELS:
            # the ranges show on the device's timeline too, as
            # annotations: they are not kernels
            if dev != cuda:
                ranges.append((s, e, LABELS[name]))
        elif dev == cuda:
            kernels.append((s, e, name))
    ranges.sort()
    if len(ranges) <= last:
        raise RuntimeError(f"the trace holds {len(ranges)} executor calls, "
                           f"not {last + 1}")
    start, end = ranges[first][0], ranges[last][1]
    return Trace([k for k in kernels if start <= k[0] < end],
                 ranges[first:last + 1], start, end)
