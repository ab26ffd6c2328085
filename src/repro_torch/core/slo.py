"""SLO-conditioned operating points (paper §5.5, Table 4).

A fixed SLA (TTFT p99 <= a, TPOT p99 <= b) caps the feasible offered load;
the cost at that lambda_max is what an SLA-bound operator actually pays.
The premium is C(sla) / C_sat over the (typically SLA-infeasible)
unconstrained saturation floor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.records import RunRecord

# The paper's running example SLA (§6.4).
DEFAULT_TTFT_P99_MS = 300.0
DEFAULT_TPOT_P99_MS = 50.0


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """A latency target as upper bounds on RunRecord percentile fields
    (ms); unset bounds are unconstrained. `slo_operating_point` keeps its
    historical p99-pair signature; the capacity planner (the reference's
    `repro.planner`) checks interpolated operating points against any
    subset of bounds."""
    ttft_p50_ms: Optional[float] = None
    ttft_p90_ms: Optional[float] = None
    ttft_p99_ms: Optional[float] = None
    tpot_p50_ms: Optional[float] = None
    tpot_p99_ms: Optional[float] = None

    def bounds(self) -> List[tuple]:
        """The set (metric_name, bound_ms) pairs actually constrained."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]

    def ok(self, metrics) -> bool:
        """True iff every constrained metric is present, finite and within
        its bound. `metrics` maps RunRecord field names to values; a
        missing or non-finite value fails the bound (a load we cannot
        price against the SLA is not demonstrably feasible)."""
        for name, bound in self.bounds():
            v = metrics.get(name)
            if v is None or not math.isfinite(v) or v > bound:
                return False
        return True

    def describe(self) -> str:
        return ", ".join(f"{n} <= {b:g}ms" for n, b in self.bounds()) \
            or "unconstrained"


@dataclasses.dataclass
class SLOResult:
    config: str
    ttft_bound_ms: float
    tpot_bound_ms: float
    lam_max: Optional[float]        # highest SLA-feasible ladder point
    c_at_sla: float
    c_sat: float
    sat_lam: float
    sat_ttft_p99_ms: float
    premium: float                  # c_at_sla / c_sat
    sat_feasible: bool              # is the saturation floor SLA-feasible?


def slo_operating_point(records: Sequence[RunRecord],
                        ttft_p99_ms: float = DEFAULT_TTFT_P99_MS,
                        tpot_p99_ms: float = DEFAULT_TPOT_P99_MS
                        ) -> SLOResult:
    recs = sorted(records, key=lambda r: r.lam)
    sat = min(recs, key=lambda r: r.c_eff)
    feasible = [r for r in recs
                if r.ttft_p99_ms <= ttft_p99_ms
                and r.tpot_p99_ms <= tpot_p99_ms]
    best = min(feasible, key=lambda r: r.c_eff) if feasible else None
    return SLOResult(
        config=recs[0].config,
        ttft_bound_ms=ttft_p99_ms, tpot_bound_ms=tpot_p99_ms,
        lam_max=best.lam if best else None,
        c_at_sla=best.c_eff if best else math.inf,
        c_sat=sat.c_eff, sat_lam=sat.lam,
        sat_ttft_p99_ms=sat.ttft_p99_ms,
        premium=(best.c_eff / sat.c_eff) if best else math.inf,
        sat_feasible=(sat.ttft_p99_ms <= ttft_p99_ms and
                      sat.tpot_p99_ms <= tpot_p99_ms))
