"""Token-budget-aware model-tier routing.

Production fleets put a router in front of a model portfolio: each
request class declares what it *needs* (a decode token budget, a
workload shape, a list of model tiers capable enough to serve it,
flagship first) and the router decides which tier the class should even
hit — Token-Budget-Aware Pool Routing (PAPERS.md) applied to the
planner's fitted curves instead of a live pool.

Two gates, both loud (§6.4 discipline — refuse, never silently price):

* **budget gate** — a class whose declared decode budget exceeds the
  measured decode length of its io_shape cannot be priced off these
  curves at all: no committed cell demonstrates that workload.
* **capability/feasibility gate** — a tier with no fitted curves for
  the class's io_shape, or whose curves cannot serve the class's rate
  within the SLO (per `greedy_mix`), is quoted as infeasible with the
  reason attached.

Among the surviving tiers the router picks the cheapest blended
$/M-token quote (ties break toward the more capable tier, i.e. earlier
in the class's list). Every decision also carries the paired
"route everything to the flagship" baseline arm — tiers[0] — so the
portfolio verdict can split its saving into a routing part and a
consolidation part.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.slo import SLOTarget
from repro_torch.planner.curves import DeploymentCurve
from repro_torch.planner.optimize import greedy_mix
from repro_torch.serving.arrivals import IO_SHAPES


@dataclasses.dataclass(frozen=True)
class TierQuote:
    """One eligible model tier priced for one class (standalone)."""
    model: str
    flagship: bool
    feasible: bool
    c_eff: float                # blended $/M-tok for the class alone
    fleet_price_per_hr: float
    n_replicas: int
    why_infeasible: str = ""


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Where one workload class goes, and why."""
    name: str
    lam: float
    io_shape: str
    budget_tokens: int
    flagship: str               # tiers[0] — the baseline arm's target
    quotes: Tuple[TierQuote, ...]
    routed: Optional[str]       # cheapest feasible tier; None = nowhere
    feasible: bool
    why_infeasible: str = ""

    @property
    def routed_off_flagship(self) -> bool:
        return self.feasible and self.routed != self.flagship

    @property
    def routed_quote(self) -> Optional[TierQuote]:
        return next((q for q in self.quotes if q.model == self.routed),
                    None) if self.routed else None

    @property
    def flagship_quote(self) -> Optional[TierQuote]:
        return next((q for q in self.quotes
                     if q.model == self.flagship), None)


@dataclasses.dataclass(frozen=True)
class RoutingResult:
    decisions: Tuple[RouteDecision, ...]

    @property
    def feasible(self) -> bool:
        return all(d.feasible for d in self.decisions)

    @property
    def infeasible_classes(self) -> List[RouteDecision]:
        return [d for d in self.decisions if not d.feasible]

    @property
    def n_routed_off_flagship(self) -> int:
        return sum(1 for d in self.decisions if d.routed_off_flagship)

    def pools(self, arm: str = "routed"
              ) -> Dict[Tuple[str, str], List[RouteDecision]]:
        """Feasible classes grouped by the (model, io_shape) pool they
        share under `arm` ('routed' or 'flagship') — the consolidation
        unit the exact allocator prices as one blended rate."""
        if arm not in ("routed", "flagship"):
            raise ValueError(f"unknown routing arm {arm!r}")
        out: Dict[Tuple[str, str], List[RouteDecision]] = {}
        for d in self.decisions:
            if not d.feasible:
                continue
            model = d.routed if arm == "routed" else d.flagship
            out.setdefault((model, d.io_shape), []).append(d)
        return out


def _quote(tier_curves: Sequence[DeploymentCurve], model: str,
           flagship: bool, lam: float, slo: Optional[SLOTarget],
           max_allocations: int) -> TierQuote:
    if not tier_curves:
        return TierQuote(
            model=model, flagship=flagship, feasible=False,
            c_eff=math.inf, fleet_price_per_hr=math.inf, n_replicas=0,
            why_infeasible="no fitted curves for this (model, io_shape) "
                           "in the store")
    mix = greedy_mix(tier_curves, lam, slo,
                     max_allocations=max_allocations)
    if mix is None or not math.isfinite(mix.c_eff):
        why = (f"no SLO-feasible allocation demonstrably serves "
               f"lam={lam:g}" + (f" within {slo.describe()}" if slo
                                 else " on the measured curves"))
        return TierQuote(model=model, flagship=flagship, feasible=False,
                        c_eff=math.inf, fleet_price_per_hr=math.inf,
                        n_replicas=0, why_infeasible=why)
    return TierQuote(model=model, flagship=flagship, feasible=True,
                     c_eff=mix.c_eff,
                     fleet_price_per_hr=mix.fleet_price_per_hr,
                     n_replicas=len(mix.allocations))


def route_class(cls, curves: Sequence[DeploymentCurve],
                slo: Optional[SLOTarget] = None,
                max_allocations: int = 16) -> RouteDecision:
    """Route one workload class (any object with name/lam/io_shape/
    budget_tokens/tiers attributes — `portfolio.WorkloadClass` in
    practice) across its eligible tiers."""
    flagship = cls.tiers[0]
    measured = IO_SHAPES.get(cls.io_shape)
    if measured is not None and cls.budget_tokens > measured[1]:
        # the budget gate: these curves were measured at io_shape's
        # decode length; a class needing more is NOT demonstrated
        why = (f"token budget {cls.budget_tokens} exceeds the measured "
               f"decode length {measured[1]} of io_shape "
               f"{cls.io_shape!r} — no committed cell demonstrates "
               f"this class")
        return RouteDecision(
            name=cls.name, lam=cls.lam, io_shape=cls.io_shape,
            budget_tokens=cls.budget_tokens, flagship=flagship,
            quotes=(), routed=None, feasible=False, why_infeasible=why)
    by_model: Dict[str, List[DeploymentCurve]] = {}
    for c in curves:
        if c.io_shape == cls.io_shape:
            by_model.setdefault(c.model, []).append(c)
    quotes = tuple(
        _quote(by_model.get(tier, []), tier, tier == flagship, cls.lam,
               slo, max_allocations)
        for tier in cls.tiers)
    # cheapest feasible tier; ties break toward the earlier (more
    # capable) tier because min() keeps the first minimum
    feasible = [q for q in quotes if q.feasible]
    chosen = min(feasible, key=lambda q: q.c_eff) if feasible else None
    why = "" if chosen else (
        "no eligible tier can serve this class: "
        + "; ".join(f"{q.model}: {q.why_infeasible}" for q in quotes))
    return RouteDecision(
        name=cls.name, lam=cls.lam, io_shape=cls.io_shape,
        budget_tokens=cls.budget_tokens, flagship=flagship,
        quotes=quotes, routed=chosen.model if chosen else None,
        feasible=chosen is not None, why_infeasible=why)


def route_workload(workload, curves: Sequence[DeploymentCurve],
                   slo: Optional[SLOTarget] = None,
                   max_allocations: int = 16) -> RoutingResult:
    """Route every class of a `portfolio.Workload` over the fitted
    curves of one store. Pure and deterministic; infeasible classes are
    carried with reasons, never dropped."""
    return RoutingResult(decisions=tuple(
        route_class(cls, curves, slo, max_allocations)
        for cls in workload.classes))
