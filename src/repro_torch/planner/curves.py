"""Fitted deployment curves: a store's ladder groups as continuous
lambda -> operating-point functions.

A `DeploymentCurve` wraps one (model, hw, quant, n_chips, io_shape)
ladder group of consolidated RunRecords and exposes every planning-
relevant metric — C_eff, achieved TPS, utilization, in-flight
concurrency and the TTFT/TPOT percentiles — as a function of offered
rate, via `core.crossover.interp_loglog` (the repo's one interpolation
primitive: duplicate-lambda knots aggregate,
flat segments and knot hits are exact). On the sim tier the curves are
monotone in lambda by construction (C_eff falls, utilization and latency
rise); `monotone_c_eff` records whether the measured knots actually obey
that, so noisy real-tier stores are flagged instead of silently trusted.

Dense lambda-continuum stores (`paper_atlas`, 25 knots) give the planner
a real curve; sparse 7-point ladders are accepted too — queries between
knots are still interpolation, but `dense` is False and anything outside
the measured span reports `extrapolated(lam) == True` (the paper's
'modeled continuation' caveat, §5.6).

Monte-Carlo ensemble stores (`paper_ensemble`: the same ladder
replicated at >= ENSEMBLE_MIN_SEEDS independent arrival seeds) carry
bootstrap confidence `bands` beside the knots: per metric, the
central-95% band of the geometric mean at each lambda, queryable via
`DeploymentCurve.band`. Single-seed stores fit exactly as before with
empty bands.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.crossover import aggregate_points, interp_aggregated
from repro_torch.core.records import RunRecord

# a curve is "dense" from this many distinct offered rates on — matches
# analyze.penalty_atlas's min_points, so the same stores qualify
DENSE_MIN_POINTS = 10

# Monte-Carlo ensemble bands: a ladder group whose lambdas
# carry at least this many seed replicates (`paper_ensemble` runs 16)
# gets bootstrap confidence bands beside its aggregated knots; below it
# a "band" would just be resampling noise on 1-2 points.
ENSEMBLE_MIN_SEEDS = 3
BOOTSTRAP_RESAMPLES = 200
BAND_QUANTILES = (2.5, 97.5)     # central 95% band
# knot metrics that get bands (penalty bands derive from these two in
# analyze.ensemble_bands; latency percentiles stay point estimates)
BAND_METRICS = ("c_eff", "util", "tps")

# RunRecord fields fitted as lambda -> value interpolators
CURVE_METRICS = ("c_eff", "tps", "util", "mean_inflight",
                 "ttft_p50_ms", "ttft_p90_ms", "ttft_p99_ms",
                 "tpot_p50_ms", "tpot_p99_ms")

# sampling noise near the saturation floor wiggles committed sim-tier
# curves by up to ~1% step-to-step; the monotone flag is for *structural*
# violations (a real-tier store with a genuinely non-monotone curve)
MONOTONE_RTOL = 0.02


@dataclasses.dataclass(frozen=True)
class DeploymentCurve:
    """One deployable footprint's measured lambda continuum."""
    model: str
    hw: str
    quant: str
    n_chips: int
    io_shape: str
    price_per_hr: float         # $/hr for ONE replica of this footprint
    theta_max: float            # saturation output tokens/s (§4.4)
    records: Tuple[RunRecord, ...]      # ladder-ordered source records
    knots: Dict[str, Tuple[Tuple[float, float], ...]]   # metric -> (lam, v)
    # Monte-Carlo confidence bands: metric -> ((lam, lo, hi),
    # ...) — the central-95% bootstrap band around each aggregated knot.
    # Empty for single-seed stores; populated when the group carries
    # >= ENSEMBLE_MIN_SEEDS replicates per lambda (`paper_ensemble`).
    bands: Dict[str, Tuple[Tuple[float, float, float], ...]] = \
        dataclasses.field(default_factory=dict)

    @property
    def key(self) -> Tuple:
        return (self.model, self.hw, self.quant, self.n_chips,
                self.io_shape)

    @property
    def label(self) -> str:
        return f"{self.model}/{self.hw}/{self.quant} x{self.n_chips}"

    @property
    def lam_min(self) -> float:
        """Low edge of the demonstrated span: the first *finite-cost*
        knot — a cell that priced to inf (nothing completed) demonstrates
        nothing, so it cannot anchor the span."""
        pts = self.knots.get("c_eff")
        return pts[0][0] if pts else self.records[0].lam

    @property
    def lam_max(self) -> float:
        """The highest offered rate this footprint has *demonstrated* it
        sustains — the last finite-cost knot, so a ladder whose top cell
        collapsed (c_eff = inf, dropped at fit time) caps feasibility at
        the last load that actually served, instead of silently clamping
        prices to it; the planner refuses to promise anything beyond."""
        pts = self.knots.get("c_eff")
        return pts[-1][0] if pts else self.records[-1].lam

    @property
    def n_points(self) -> int:
        return len({r.lam for r in self.records})

    @property
    def dense(self) -> bool:
        return self.n_points >= DENSE_MIN_POINTS

    @property
    def monotone_c_eff(self) -> bool:
        """C_eff non-increasing across the *fitted* knots (the §5 shape)
        within MONOTONE_RTOL per step; False flags a structurally
        non-monotone curve whose interpolants are less trustworthy.
        Judged on the aggregated finite knots the planner actually
        queries — dropped inf-cost cells and duplicate-lambda records
        cannot flip the flag."""
        ceffs = [y for _, y in self.knots.get("c_eff", ())]
        return all(b <= a * (1 + MONOTONE_RTOL)
                   for a, b in zip(ceffs, ceffs[1:]))

    def extrapolated(self, lam: float) -> bool:
        """Outside the measured span: values clamp to the nearest edge and
        are a modeled continuation, not an observed operating point."""
        return lam < self.lam_min or lam > self.lam_max

    def interp(self, metric: str, lam: float) -> float:
        pts = self.knots.get(metric, ())
        if not pts:
            return math.nan
        return interp_aggregated(pts, lam)       # pre-aggregated at fit

    # -- planning metrics ------------------------------------------------
    def c_eff(self, lam: float) -> float:
        """$/M output tokens at offered rate lam (== the committed
        store's `interp_c_eff` on this group, knot-exact)."""
        return self.interp("c_eff", lam)

    def tps(self, lam: float) -> float:
        return self.interp("tps", lam)

    def util(self, lam: float) -> float:
        return self.interp("util", lam)

    def penalty(self, lam: float) -> float:
        return penalty_from_util(self.util(lam))

    def operating_point(self, lam: float) -> Dict[str, float]:
        """Every fitted metric interpolated at `lam` (SLO-check input)."""
        return {m: self.interp(m, lam) for m in CURVE_METRICS}

    def band(self, metric: str, lam: float) -> Tuple[float, float]:
        """(lo, hi) of the central-95% bootstrap band at `lam`, each edge
        interpolated through the same log-log primitive as the knots.
        (nan, nan) when this curve carries no ensemble replicates."""
        pts = self.bands.get(metric, ())
        if not pts:
            return (math.nan, math.nan)
        lo = interp_aggregated(tuple((x, l) for x, l, _ in pts), lam)
        hi = interp_aggregated(tuple((x, h) for x, _, h in pts), lam)
        return (lo, hi)


def penalty_from_util(u: float) -> float:
    """1/U with the zero/nan guard — the one underutilization-penalty
    expression both curve queries and option pricing share."""
    return math.inf if not u or not math.isfinite(u) else 1.0 / u


def _metric_value(rec: RunRecord, metric: str) -> float:
    return getattr(rec, metric)


def bootstrap_band(values: Sequence[float], rng: np.random.Generator,
                   n_boot: int = BOOTSTRAP_RESAMPLES,
                   quantiles: Tuple[float, float] = BAND_QUANTILES
                   ) -> Tuple[float, float, float]:
    """(point, lo, hi): the geometric mean of `values` with its
    percentile-bootstrap band — the one band primitive both the planner
    curves and `analyze.ensemble_bands` share. The statistic is the
    geometric mean, matching `aggregate_points`' duplicate-lambda
    policy, so a band always brackets the knot the planner actually
    interpolates. Deterministic given `rng` (callers derive it from the
    group key via CRC32, never from global state)."""
    logv = np.log(np.asarray(values, dtype=float))
    point = float(np.exp(logv.mean()))
    if logv.size == 1:
        return point, point, point      # degenerate but finite
    idx = rng.integers(0, logv.size, size=(n_boot, logv.size))
    means = logv[idx].mean(axis=1)
    lo, hi = np.percentile(means, quantiles)
    return point, float(np.exp(lo)), float(np.exp(hi))


def _band_rng(key: Tuple, metric: str) -> np.random.Generator:
    """Deterministic per-(group, metric) bootstrap stream: same store ->
    same bands, independent of dict order or PYTHONHASHSEED."""
    return np.random.default_rng(
        zlib.crc32(f"{key}|{metric}".encode()))


def fit_bands(key: Tuple, group: Sequence[RunRecord],
              metrics: Sequence[str] = BAND_METRICS,
              min_seeds: int = ENSEMBLE_MIN_SEEDS
              ) -> Dict[str, Tuple[Tuple[float, float, float], ...]]:
    """Bootstrap bands for one ladder group, keyed like `knots`. Only
    lambdas with >= `min_seeds` finite-positive replicate values get a
    band knot (a single-seed lambda inside an ensemble store carries no
    spread information); groups with no such lambda return {}."""
    by_lam: Dict[float, List[RunRecord]] = {}
    for r in group:
        by_lam.setdefault(r.lam, []).append(r)
    if max(len(v) for v in by_lam.values()) < min_seeds:
        return {}
    bands = {}
    for metric in metrics:
        rng = _band_rng(key, metric)
        pts = []
        for lam in sorted(by_lam):
            vals = [_metric_value(r, metric) for r in by_lam[lam]]
            vals = [v for v in vals if math.isfinite(v) and v > 0]
            if len(vals) >= min_seeds:
                _, lo, hi = bootstrap_band(vals, rng)
                pts.append((lam, lo, hi))
        if pts:
            bands[metric] = tuple(pts)
    return bands


def fit_curves(records: Sequence[RunRecord],
               io_shape: Optional[str] = None,
               model: Optional[str] = None) -> List[DeploymentCurve]:
    """Group consolidated records per (model, hw, quant, n_chips,
    io_shape) and fit one DeploymentCurve per group. Non-finite or
    non-positive knot values (e.g. C_eff = inf where nothing completed)
    carry no information in log space and are dropped per metric."""
    groups: Dict[Tuple, List[RunRecord]] = {}
    for r in records:
        if r.mttf > 0.0 or r.retry_max > 0:
            # resilient records measure degraded operation at
            # the same coordinates as their failure-free siblings; the
            # planner's curves price healthy replicas (failure cost
            # enters through the availability/spares model instead)
            continue
        if r.config.startswith("profile:"):
            # non-stationary lambda(t) records: `lam` is the
            # profile's nominal mean, not a stationary ladder knot
            continue
        if io_shape is not None and r.io_shape != io_shape:
            continue
        if model is not None and r.model != model:
            continue
        key = (r.model, r.hw, r.quant, r.n_chips, r.io_shape)
        groups.setdefault(key, []).append(r)
    out = []
    for key, group in sorted(groups.items()):
        group.sort(key=lambda r: r.lam)
        knots = {}
        for metric in CURVE_METRICS:
            pts = [(r.lam, _metric_value(r, metric)) for r in group
                   if math.isfinite(_metric_value(r, metric))
                   and _metric_value(r, metric) > 0]
            if pts:
                # aggregate once here (merged stores may duplicate lams);
                # every query then rides the no-aggregation fast path
                knots[metric] = tuple(aggregate_points(pts))
        out.append(DeploymentCurve(
            model=key[0], hw=key[1], quant=key[2], n_chips=key[3],
            io_shape=key[4], price_per_hr=group[0].price_per_hr,
            theta_max=group[0].theta_max, records=tuple(group),
            knots=knots, bands=fit_bands(key, group)))
    return out


def curves_by_model(curves: Sequence[DeploymentCurve]
                    ) -> Dict[str, List[DeploymentCurve]]:
    out: Dict[str, List[DeploymentCurve]] = {}
    for c in curves:
        out.setdefault(c.model, []).append(c)
    return out
