"""Self-host vs API crossover analysis (paper §3.4, §5.6).

The crossover is not a point but a surface: lambda* solves
C_eff(lambda*) = C_API(tier). We log-interpolate the measured C_eff(lambda)
curve (the paper's Fig. 5 method) and report per-tier thresholds, flagging
extrapolation below the measured ladder exactly as the paper does.

`interp_loglog` is the one interpolation primitive of the repo:
`interp_c_eff`, the planner's fitted deployment curves and the crossover
solver all route through it. It is hardened against the edges merged or
overlapping stores produce:

* duplicate-x points (the same lambda measured in two stores) are
  aggregated up front — geometric mean, i.e. the arithmetic mean in the
  log space the interpolation lives in; exact when the duplicates agree —
  so no verdict silently keys off whichever duplicate sorted first, and
  no zero-width log segment can divide by zero;
* flat segments short-circuit exactly: a curve that is 5.0 on both knots
  returns 5.0, not exp(log(5.0)) = 4.999999999999999;
* queries at a knot return the knot value exactly.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.pricing import API_TIERS, APITier
from repro_torch.core.records import RunRecord


def aggregate_points(pairs: Sequence[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    """Sorted (x, y) knots with duplicate-x values collapsed to one knot.

    Duplicates aggregate by geometric mean (the mean of the log-space the
    interpolation works in); identical duplicates collapse exactly
    (no log/exp round-trip), which also keeps inf/0 values intact.
    """
    by_x: Dict[float, List[float]] = {}
    for x, y in pairs:
        by_x.setdefault(x, []).append(y)
    out = []
    for x in sorted(by_x):
        ys = by_x[x]
        if all(y == ys[0] for y in ys):
            out.append((x, ys[0]))
        elif any(y <= 0 for y in ys):
            # a non-positive duplicate has no log; propagate the floor
            # instead of crashing every later query on this curve
            out.append((x, min(ys)))
        elif any(math.isinf(y) for y in ys):
            out.append((x, math.inf))
        else:
            out.append((x, math.exp(sum(math.log(y) for y in ys) / len(ys))))
    return out


def interp_loglog(pairs: Sequence[Tuple[float, float]], x: float) -> float:
    """Log-log interpolation of (x, y) knots at `x`; clamps outside the
    measured range. Duplicate-x knots are aggregated first; knot hits and
    flat segments return the knot value exactly."""
    return interp_aggregated(aggregate_points(pairs), x)


def interp_aggregated(pts: Sequence[Tuple[float, float]], x: float) -> float:
    """`interp_loglog` over knots already sorted and duplicate-free (the
    planner pre-aggregates at fit time; its query paths skip the
    per-call aggregation)."""
    if not pts:
        return math.nan
    if x <= pts[0][0]:
        return pts[0][1]
    if x >= pts[-1][0]:
        return pts[-1][1]
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        if x0 <= x <= x1:
            if x == x0 or y0 == y1:
                return y0
            if x == x1:
                return y1
            t = (math.log(x) - math.log(x0)) / (math.log(x1) - math.log(x0))
            if not (0 < y0 < math.inf and 0 < y1 < math.inf):
                # a segment with an unloggable endpoint (0 or inf knot)
                # cannot be log-interpolated: clamp to the nearer knot
                return y0 if t < 0.5 else y1
            return math.exp(math.log(y0) * (1 - t) + math.log(y1) * t)
    return pts[-1][1]


def interp_c_eff(records: Sequence[RunRecord], lam: float) -> float:
    """Log-log interpolation of the measured curve at offered rate lam."""
    return interp_loglog([(r.lam, r.c_eff) for r in records], lam)


def crossover_lambda(records: Sequence[RunRecord],
                     api_price: float) -> Optional[Tuple[float, bool]]:
    """(lambda*, extrapolated?) where C_eff crosses below api_price.

    None if self-hosting never crosses below the tier on (or beyond) the
    measured curve. extrapolated=True marks a crossover below the lowest
    measured lambda (paper: 'modeled continuation, not a directly observed
    operating point').
    """
    pts = aggregate_points((r.lam, r.c_eff) for r in records)
    if not pts:
        return None
    if pts[0][1] <= api_price:
        return pts[0][0], True      # cheaper already at the lowest point
    for (l0, c0), (l1, c1) in zip(pts, pts[1:]):
        if c0 > api_price >= c1:
            # c0 > api_price >= c1 implies c0 > c1, so the log segment
            # has width; equal-lambda knots were aggregated above
            t = (math.log(api_price) - math.log(c0)) / \
                (math.log(c1) - math.log(c0))
            lam = math.exp(math.log(l0) * (1 - t) + math.log(l1) * t)
            return lam, False
    return None


def crossover_table(records: Sequence[RunRecord],
                    tiers: Optional[Dict[str, APITier]] = None,
                    accept_slo_mismatch: bool = False) -> List[dict]:
    """Per-tier crossover report. Refuses (paper §6.4) unless the caller
    explicitly accepts that serverless tiers carry no latency SLA."""
    if not accept_slo_mismatch:
        raise ValueError(
            "API comparison gated: serverless list prices carry no latency "
            "SLA; pass accept_slo_mismatch=True to acknowledge (paper §6.4)")
    tiers = tiers or API_TIERS
    out = []
    for name, tier in tiers.items():
        res = crossover_lambda(records, tier.output_per_mtok)
        out.append({
            "tier": name,
            "api_output_per_mtok": tier.output_per_mtok,
            "lambda_star": res[0] if res else math.inf,
            "extrapolated": res[1] if res else False,
            "self_host_always_cheaper": bool(res and res[1]),
        })
    return out
