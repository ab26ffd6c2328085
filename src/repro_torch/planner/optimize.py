"""Invert the cost atlas into deployment decisions.

The paper's thesis is that the operator's offered rate lambda — not a
utilization preset — drives the self-host decision (C_eff = f(H, M, Q,
lambda, L)). The analysis layer *reports* that surface; this module
*inverts* it: given lambda, an io shape and an optional SLO, enumerate
every deployment the store has measured and rank what the operator
should actually buy.

Three decision axes:

* **Footprint** — every (hw, quant, n_chips) the store has curves for.
* **Replica count R** — each replica serves lambda/R. By Little's law the
  per-replica concurrency falls with R, so utilization falls and the
  underutilization penalty rises: a replica split is never cheaper per
  token on a monotone curve (the fleet's $/M-tok at lambda equals one
  replica's C_eff at lambda/R >= C_eff(lambda)), but it is how an
  SLO-infeasible load becomes feasible — the planner prices that
  tradeoff instead of hiding it.
* **Heterogeneous mix** — a Mélange-style (Griggs et al.) greedy pass
  across hardware generations: repeatedly hand the largest
  SLO-feasible slice of the remaining load to the footprint that serves
  it at the lowest $/M-token, so a premium part carries the bulk while a
  cheap part mops up the remainder.

Loads nothing here can demonstrably serve (lambda/R beyond every
measured curve, or no operating point within the SLO) are **rejected
with a reason, never silently priced** — the paper's §6.4 discipline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.crossover import crossover_table
from repro_torch.core.slo import SLOTarget
from repro_torch.planner.curves import DeploymentCurve, penalty_from_util

DEFAULT_MAX_REPLICAS = 8
# bisection iterations for the SLO-feasible rate cap (log-space; 60
# halvings pin the cap far below any meaningful resolution)
_CAP_ITERS = 60
# give up past this many spares: a replica_availability low enough to
# need more is not a deployable story, it is a broken fleet
_MAX_SPARES = 64


@dataclasses.dataclass(frozen=True)
class AvailabilityTarget:
    """Fleet availability requirement: with each replica
    independently up with probability `replica_availability` (its
    steady-state MTTF/(MTTF+MTTR)), the probability that at least the R
    *active* replicas are up must reach `availability`. The planner buys
    N+1-style spares until it does and prices them as pure utilization
    loss: spares burn $/hr without adding delivered tokens."""
    availability: float = 0.999
    replica_availability: float = 0.99

    def __post_init__(self):
        # a target of 1.0+ can never be met by
        # finitely many spares (the binomial tail is < 1 for any p < 1),
        # and a replica availability outside (0, 1] turns the exact
        # binomial into nonsense (negative "probabilities") — both used
        # to loop through all _MAX_SPARES and return garbage quietly.
        if not 0.0 < self.availability < 1.0:
            raise ValueError(
                f"availability must be in (0, 1), got "
                f"{self.availability!r}: a fleet of finitely many "
                f"imperfect replicas can never certify availability "
                f">= 1.0, and <= 0 is not a target")
        if not 0.0 < self.replica_availability <= 1.0:
            raise ValueError(
                f"replica_availability must be in (0, 1], got "
                f"{self.replica_availability!r} (the steady-state "
                f"MTTF/(MTTF+MTTR) of one replica)")

    def describe(self) -> str:
        return (f"availability >= {self.availability:g} "
                f"(replica availability {self.replica_availability:g})")


def _p_at_least(total: int, k: int, p: float) -> float:
    """P(Binomial(total, p) >= k), exact (totals here are tiny)."""
    if k <= 0:
        return 1.0
    return sum(math.comb(total, j) * p ** j * (1.0 - p) ** (total - j)
               for j in range(k, total + 1))


def spares_needed(active: int, target: AvailabilityTarget) -> Optional[int]:
    """Smallest spare count s such that a (active + s)-replica fleet has
    >= active replicas up with probability >= the target; None when even
    `_MAX_SPARES` spares cannot reach it."""
    p = target.replica_availability
    for s in range(_MAX_SPARES + 1):
        if _p_at_least(active + s, active, p) >= target.availability:
            return s
    return None


@dataclasses.dataclass(frozen=True)
class DeploymentOption:
    """One priced deployment: R replicas of a footprint at offered lambda."""
    model: str
    hw: str
    quant: str
    n_chips: int
    replicas: int
    lam: float                  # total offered rate
    lam_per_replica: float
    c_eff: float                # $/M output tokens for the whole fleet
    fleet_price_per_hr: float   # R x the footprint's hourly price
    util: float
    penalty: float
    mean_inflight: float        # per-replica concurrency (Little's law)
    ttft_p90_ms: float
    ttft_p99_ms: float
    tpot_p99_ms: float
    slo_ok: bool
    extrapolated: bool          # lam/R outside the measured span
    dense: bool                 # fitted from a lambda-continuum store
    feasible: bool
    why_infeasible: str = ""
    # availability-aware pricing: spares idle behind the R
    # active replicas; c_eff above is already scaled by (R + spares) / R
    spares: int = 0
    availability: float = 1.0   # achieved P(>= R replicas up)

    @property
    def label(self) -> str:
        tag = f"{self.model}/{self.hw}/{self.quant} x{self.n_chips}"
        return tag if self.replicas == 1 else f"{tag} R={self.replicas}"


@dataclasses.dataclass(frozen=True)
class MixAllocation:
    hw: str
    quant: str
    n_chips: int
    lam: float                  # slice of the offered load on this replica
    c_eff: float
    util: float
    price_per_hr: float
    extrapolated: bool


@dataclasses.dataclass(frozen=True)
class HeterogeneousMix:
    """A Mélange-style multi-generation fleet serving one model."""
    model: str
    lam: float
    allocations: Tuple[MixAllocation, ...]
    c_eff: float                # blended $/M output tokens
    fleet_price_per_hr: float
    slo_ok: bool

    @property
    def label(self) -> str:
        groups: List[List[MixAllocation]] = []
        for a in self.allocations:
            tag = (a.hw, a.quant, a.n_chips, f"{a.lam:.3g}")
            if groups and groups[-1][0] == tag:
                groups[-1][1].append(a)
            else:
                groups.append([tag, [a]])
        return " + ".join(
            f"{len(allocs)}x {hw}/{quant} x{chips}@{lam}rps"
            if len(allocs) > 1 else f"{hw}/{quant} x{chips}@{lam}rps"
            for (hw, quant, chips, lam), allocs in groups)


@dataclasses.dataclass
class CapacityPlan:
    """The planner's answer for one model at one offered rate."""
    model: str
    lam: float
    io_shape: str
    slo: Optional[SLOTarget]
    ranked: List[DeploymentOption]      # feasible, cheapest first
    rejected: List[DeploymentOption]    # priced-but-refused, with reasons
    mix: Optional[HeterogeneousMix]
    crossover: List[dict]               # per-API-tier verdict (best curve)
    avail: Optional[AvailabilityTarget] = None

    @property
    def best(self) -> Optional[DeploymentOption]:
        return self.ranked[0] if self.ranked else None

    @property
    def feasible(self) -> bool:
        return bool(self.ranked)


def _option(curve: DeploymentCurve, lam: float, replicas: int,
            slo: Optional[SLOTarget],
            avail: Optional[AvailabilityTarget] = None) -> DeploymentOption:
    lam_per = lam / replicas
    op = curve.operating_point(lam_per)
    # the fleet's $/M-token equals one replica's C_eff at lambda/R:
    # R x price over R x tps(lambda/R) cancels
    cost = op["c_eff"]
    util = op["util"]
    beyond = lam_per > curve.lam_max
    priceable = math.isfinite(cost)
    slo_ok = slo.ok(op) if slo is not None else True
    spares, achieved, avail_ok = 0, 1.0, True
    if avail is not None:
        s = spares_needed(replicas, avail)
        if s is None:
            avail_ok = False
            achieved = _p_at_least(replicas + _MAX_SPARES, replicas,
                                   avail.replica_availability)
        else:
            spares = s
            achieved = _p_at_least(replicas + s, replicas,
                                   avail.replica_availability)
            # spares are pure utilization loss: tokens still come from
            # the R active replicas while (R + s) replicas burn $/hr
            cost = cost * (replicas + s) / replicas
    feasible = not beyond and priceable and slo_ok and avail_ok
    why = ""
    if beyond:
        why = (f"lambda/R = {lam_per:g} beyond the measured range "
               f"(<= {curve.lam_max:g} rps demonstrated)")
    elif not priceable:
        why = "no finite-cost operating point measured on this curve"
    elif not slo_ok:
        why = f"violates SLO ({slo.describe()})"
    elif not avail_ok:
        why = (f"cannot reach {avail.describe()} with <= {_MAX_SPARES} "
               "spares")
    return DeploymentOption(
        model=curve.model, hw=curve.hw, quant=curve.quant,
        n_chips=curve.n_chips, replicas=replicas, lam=lam,
        lam_per_replica=lam_per, c_eff=cost,
        fleet_price_per_hr=(replicas + spares) * curve.price_per_hr,
        util=util, penalty=penalty_from_util(util),
        mean_inflight=op["mean_inflight"],
        ttft_p90_ms=op["ttft_p90_ms"], ttft_p99_ms=op["ttft_p99_ms"],
        tpot_p99_ms=op["tpot_p99_ms"],
        slo_ok=slo_ok, extrapolated=curve.extrapolated(lam_per),
        dense=curve.dense, feasible=feasible, why_infeasible=why,
        spares=spares, availability=achieved)


def enumerate_options(curves: Sequence[DeploymentCurve], lam: float,
                      slo: Optional[SLOTarget] = None,
                      max_replicas: int = DEFAULT_MAX_REPLICAS,
                      avail: Optional[AvailabilityTarget] = None
                      ) -> List[DeploymentOption]:
    """Every (footprint, R) candidate for one model at offered rate lam,
    priced; feasibility and reasons attached, no ranking applied. With an
    `avail` target each option carries its spare count and its c_eff is
    the per-*delivered*-token cost including the idle spares."""
    out = []
    for curve in curves:
        for replicas in range(1, max_replicas + 1):
            out.append(_option(curve, lam, replicas, slo, avail))
            if lam / replicas <= curve.lam_min:
                # further splits only push deeper into the idle edge:
                # same clamped metrics, strictly more hardware
                break
    return out


def rank_options(options: Sequence[DeploymentOption]
                 ) -> Tuple[List[DeploymentOption], List[DeploymentOption]]:
    """(feasible cheapest-first, rejected). Ties break toward fewer
    replicas, then lower fleet price, then the stable label order."""
    feasible = sorted(
        (o for o in options if o.feasible),
        key=lambda o: (o.c_eff, o.replicas, o.fleet_price_per_hr, o.label))
    rejected = [o for o in options if not o.feasible]
    return feasible, rejected


def require_one_model(curves: Sequence[DeploymentCurve]
                      ) -> Tuple[str, str]:
    """Validate that `curves` all describe one (model, io_shape) — the
    homogeneity every single-workload allocator here assumes (a replica
    serves one model; operating points measured under different workload
    shapes never blend). Returns the (model, io_shape) pair. A mixed
    list used to be silently labeled with ``curves[0].model``; now it
    raises, and the portfolio entry points
    (`planner.allocate`, `planner.portfolio`) reuse the same gate."""
    if not curves:
        raise ValueError("empty curve group: nothing to allocate")
    pairs = {(c.model, c.io_shape) for c in curves}
    if len(pairs) > 1:
        raise ValueError(
            "heterogeneous curve group: one allocation serves one "
            f"(model, io_shape), got {sorted(pairs)} — split per model "
            "with repro_torch.planner.portfolio instead")
    return next(iter(pairs))


def _slo_ok_at(curve: DeploymentCurve, slo: SLOTarget, lam: float) -> bool:
    """SLO check interpolating only the constrained metrics (the bisection
    hot path probes this ~60x per curve)."""
    return slo.ok({name: curve.interp(name, lam)
                   for name, _ in slo.bounds()})


def slo_feasible_cap(curve: DeploymentCurve,
                     slo: Optional[SLOTarget]) -> float:
    """The highest offered rate one replica of `curve` demonstrably serves
    within the SLO: lam_max when unconstrained, else a log-space bisection
    over the fitted operating points; 0.0 when even the idle edge violates
    the target (this footprint cannot serve this SLA at any load)."""
    if slo is None or _slo_ok_at(curve, slo, curve.lam_max):
        return curve.lam_max
    if not _slo_ok_at(curve, slo, curve.lam_min):
        return 0.0
    lo, hi = math.log(curve.lam_min), math.log(curve.lam_max)
    for _ in range(_CAP_ITERS):
        mid = (lo + hi) / 2
        if _slo_ok_at(curve, slo, math.exp(mid)):
            lo = mid
        else:
            hi = mid
    return math.exp(lo)


def greedy_mix(curves: Sequence[DeploymentCurve], lam: float,
               slo: Optional[SLOTarget] = None,
               max_allocations: int = 16) -> Optional[HeterogeneousMix]:
    """Mélange-style greedy heterogeneous allocation for one model.

    Repeatedly assign the remaining load's largest SLO-feasible slice to
    a fresh replica of whichever footprint serves *that slice* at the
    lowest $/M-token. With a full load remaining that picks the cheapest
    saturated part (the bulk carrier); for the tail remainder it picks
    whichever part prices the scraps cheapest — heterogeneity emerges
    exactly when the tail is cheaper on a smaller generation. Returns
    None when no footprint can take any load within the SLO, or when the
    load cannot be exhausted within `max_allocations` replicas.
    """
    model, _ = require_one_model(curves)
    caps = {c.key: slo_feasible_cap(c, slo) for c in curves}
    usable = [c for c in curves if caps[c.key] > 0]
    if not usable:
        return None
    assigned: List[Tuple[DeploymentCurve, float]] = []
    remaining = lam
    for _ in range(max_allocations):
        if remaining <= 0:
            break
        best_curve, best_serve, best_cost = None, 0.0, math.inf
        for c in usable:
            serve = min(remaining, caps[c.key])
            cost = c.c_eff(serve)
            if cost < best_cost:
                best_curve, best_serve, best_cost = c, serve, cost
        if best_curve is None:
            return None                 # nothing prices finitely
        assigned.append((best_curve, best_serve))
        remaining -= best_serve
    if remaining > 1e-9 * lam:
        return None                     # could not exhaust the load
    allocations = tuple(MixAllocation(
        hw=c.hw, quant=c.quant, n_chips=c.n_chips, lam=serve,
        c_eff=c.c_eff(serve), util=c.util(serve),
        price_per_hr=c.price_per_hr, extrapolated=c.extrapolated(serve))
        for c, serve in assigned)
    total_price = sum(c.price_per_hr for c, _ in assigned)
    total_tps = sum(c.tps(serve) for c, serve in assigned)
    blended = math.inf if total_tps <= 0 else \
        total_price * 1e6 / (3600.0 * total_tps)
    return HeterogeneousMix(
        model=model, lam=lam, allocations=allocations,
        c_eff=blended, fleet_price_per_hr=total_price, slo_ok=True)


def _finite_or_inf(v: float) -> float:
    return v if math.isfinite(v) else math.inf


def plan_capacity(curves: Sequence[DeploymentCurve], lam: float,
                  slo: Optional[SLOTarget] = None,
                  max_replicas: int = DEFAULT_MAX_REPLICAS,
                  avail: Optional[AvailabilityTarget] = None
                  ) -> List[CapacityPlan]:
    """One CapacityPlan per (model, io_shape) present in `curves`, in
    that order — operating points measured under different workload
    shapes never compete inside one ranking."""
    by_group: Dict[Tuple[str, str], List[DeploymentCurve]] = {}
    for c in curves:
        by_group.setdefault((c.model, c.io_shape), []).append(c)
    plans = []
    for (model, io_shape), group in sorted(by_group.items()):
        options = enumerate_options(group, lam, slo,
                                    max_replicas=max_replicas,
                                    avail=avail)
        ranked, rejected = rank_options(options)
        # the greedy mix is not availability-aware (it has no replica
        # structure to buy spares against) — suppressing it under an
        # availability target keeps the ranking honest
        mix = greedy_mix(group, lam, slo) \
            if len(group) > 1 and avail is None else None
        # the API verdict belongs to the curve the operator would deploy
        if ranked:
            key = (model, ranked[0].hw, ranked[0].quant,
                   ranked[0].n_chips, io_shape)
            best_curve = next(c for c in group if c.key == key)
        else:
            best_curve = min(
                group, key=lambda c: _finite_or_inf(c.c_eff(c.lam_max)))
        crossover = crossover_table(best_curve.records,
                                    accept_slo_mismatch=True)
        plans.append(CapacityPlan(
            model=model, lam=lam, io_shape=io_shape, slo=slo,
            ranked=ranked, rejected=rejected, mix=mix,
            crossover=crossover, avail=avail))
    return plans
