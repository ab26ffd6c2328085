"""Workload portfolios: many request classes, one fleet.

The paper prices one model per deployment; the operator question it
motivates is a portfolio question. A `Workload` describes blended
traffic as frozen request classes — each with its own rate, decode
token budget, io_shape, and an ordered list of model tiers capable
enough to serve it (flagship first). `plan_portfolio` then prices that
workload three ways on one store's fitted curves:

* **silo** — the status quo: every class runs dedicated replicas of its
  flagship model. Utilization penalties compound per class.
* **flagship_pool** — consolidation only: classes sharing a flagship
  pool into one blended rate per (model, io_shape) before allocation.
* **routed_pool** — consolidation + routing: the token-budget router
  (`repro_torch.planner.routing`) first moves each class to its cheapest
  capable tier, then pools per (model, io_shape).

Every pool is allocated by `greedy_mix` and certified against the
exact branch-and-bound optimum (`repro_torch.planner.allocate`), so each
`PoolAllocation` carries its optimality gap. The verdict decomposes
the saving into a consolidation part (silo -> flagship_pool) and a
routing part (flagship_pool -> routed_pool), both on the operator's
actual bill ($/hr for the whole fleet).

Infeasible classes (budget gate, missing curves, SLO) are carried with
reasons and poison the affected arm's totals to None — the plan never
prices a workload the store cannot demonstrate (§6.4 discipline).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.slo import SLOTarget
from repro_torch.planner.allocate import Certificate, certify
from repro_torch.planner.curves import DeploymentCurve
from repro_torch.planner.optimize import HeterogeneousMix, greedy_mix
from repro_torch.serving.arrivals import IO_SHAPES

ARMS = ("silo", "flagship_pool", "routed_pool")


@dataclasses.dataclass(frozen=True)
class WorkloadClass:
    """One request class of a blended workload.

    ``tiers`` is the capability ladder, flagship first: every listed
    model is assumed *able* to serve the class; the router decides
    which one is worth paying for. ``budget_tokens`` is the class's
    decode budget — it must be within the measured decode length of
    ``io_shape`` or the planner refuses to price the class.
    """
    name: str
    lam: float                       # offered rate, req/s
    tiers: Tuple[str, ...]           # eligible models, flagship first
    io_shape: str = "chat"
    budget_tokens: int = 0           # 0 = io_shape's measured decode len

    def __post_init__(self):
        if not self.name:
            raise ValueError("workload class needs a name")
        if not (math.isfinite(self.lam) and self.lam > 0):
            raise ValueError(
                f"class {self.name!r}: lam must be finite and > 0, "
                f"got {self.lam!r}")
        if not self.tiers:
            raise ValueError(
                f"class {self.name!r}: needs at least one eligible "
                "model tier (flagship first)")
        if len(set(self.tiers)) != len(self.tiers):
            raise ValueError(
                f"class {self.name!r}: duplicate tiers {self.tiers}")
        object.__setattr__(self, "tiers", tuple(self.tiers))
        if self.budget_tokens == 0:
            measured = IO_SHAPES.get(self.io_shape)
            if measured is None:
                raise ValueError(
                    f"class {self.name!r}: io_shape {self.io_shape!r} "
                    f"is not a measured shape {sorted(IO_SHAPES)} and "
                    "no explicit budget_tokens was given")
            object.__setattr__(self, "budget_tokens", measured[1])
        if self.budget_tokens < 0:
            raise ValueError(
                f"class {self.name!r}: budget_tokens must be >= 0, "
                f"got {self.budget_tokens}")

    @property
    def flagship(self) -> str:
        return self.tiers[0]

    def scaled(self, factor: float) -> "WorkloadClass":
        return dataclasses.replace(self, lam=self.lam * factor)

    def to_dict(self) -> dict:
        return {"name": self.name, "lam": self.lam,
                "tiers": list(self.tiers), "io_shape": self.io_shape,
                "budget_tokens": self.budget_tokens}


@dataclasses.dataclass(frozen=True)
class Workload:
    """A named bundle of request classes — the portfolio spec."""
    name: str
    classes: Tuple[WorkloadClass, ...]

    def __post_init__(self):
        if not self.classes:
            raise ValueError(f"workload {self.name!r} has no classes")
        object.__setattr__(self, "classes", tuple(self.classes))
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(
                f"workload {self.name!r}: duplicate class names "
                f"{sorted(n for n in names if names.count(n) > 1)}")

    @property
    def lam_total(self) -> float:
        return sum(c.lam for c in self.classes)

    @property
    def models(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for c in self.classes:
            for t in c.tiers:
                if t not in seen:
                    seen.append(t)
        return tuple(seen)

    def scaled(self, lam_total: float) -> "Workload":
        """The same class mix rescaled so rates sum to `lam_total`."""
        if not (math.isfinite(lam_total) and lam_total > 0):
            raise ValueError(
                f"lam_total must be finite and > 0, got {lam_total!r}")
        factor = lam_total / self.lam_total
        return Workload(name=self.name,
                        classes=tuple(c.scaled(factor)
                                      for c in self.classes))

    def to_dict(self) -> dict:
        return {"name": self.name,
                "classes": [c.to_dict() for c in self.classes]}

    @classmethod
    def from_dict(cls, d: dict) -> "Workload":
        if "classes" not in d:
            raise ValueError(
                "workload spec needs a 'classes' list; got keys "
                f"{sorted(d)}")
        return cls(
            name=d.get("name", "workload"),
            classes=tuple(
                WorkloadClass(
                    name=c["name"], lam=float(c["lam"]),
                    tiers=tuple(c["tiers"]),
                    io_shape=c.get("io_shape", "chat"),
                    budget_tokens=int(c.get("budget_tokens", 0)))
                for c in d["classes"]))

    @classmethod
    def from_json(cls, path: str) -> "Workload":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# The headline 3-class blend (shares sum to 1 req/s; use .scaled()).
# Tier ladders follow model capability: mixtral-8x7b is the flagship,
# qwen3-30b-a3b the mid tier, llama31-8b the small tier. All classes
# ride the measured "chat" shape; they differ in decode budget and in
# how far down the ladder they may be routed.
BLENDED_3CLASS = Workload(name="blended_3class", classes=(
    WorkloadClass(name="reasoning", lam=0.2, budget_tokens=256,
                  tiers=("mixtral-8x7b",)),
    WorkloadClass(name="chat", lam=0.5, budget_tokens=192,
                  tiers=("mixtral-8x7b", "qwen3-30b-a3b")),
    WorkloadClass(name="autocomplete", lam=0.3, budget_tokens=64,
                  tiers=("mixtral-8x7b", "qwen3-30b-a3b",
                         "llama31-8b")),
))

WORKLOADS: Dict[str, Workload] = {BLENDED_3CLASS.name: BLENDED_3CLASS}


@dataclasses.dataclass(frozen=True)
class PoolAllocation:
    """One (model, io_shape) pool of one arm, priced and certified."""
    model: str
    io_shape: str
    lam: float
    class_names: Tuple[str, ...]
    feasible: bool
    mix: Optional[HeterogeneousMix]
    certificate: Optional[Certificate]
    why_infeasible: str = ""

    @property
    def fleet_price_per_hr(self) -> float:
        return self.mix.fleet_price_per_hr if self.mix else math.inf

    @property
    def c_eff(self) -> float:
        return self.mix.c_eff if self.mix else math.inf

    @property
    def n_replicas(self) -> int:
        return len(self.mix.allocations) if self.mix else 0

    @property
    def n_chips(self) -> int:
        return (sum(a.n_chips for a in self.mix.allocations)
                if self.mix else 0)


@dataclasses.dataclass(frozen=True)
class ArmPlan:
    """One way of running the whole portfolio (see module docstring)."""
    arm: str                          # 'silo' | 'flagship_pool' | 'routed_pool'
    pools: Tuple[PoolAllocation, ...]
    infeasible_classes: Tuple[str, ...]   # class names this arm cannot price

    @property
    def feasible(self) -> bool:
        return (not self.infeasible_classes
                and all(p.feasible for p in self.pools))

    @property
    def fleet_price_per_hr(self) -> Optional[float]:
        if not self.feasible:
            return None
        return sum(p.fleet_price_per_hr for p in self.pools)

    @property
    def n_chips(self) -> Optional[int]:
        if not self.feasible:
            return None
        return sum(p.n_chips for p in self.pools)

    @property
    def n_replicas(self) -> Optional[int]:
        if not self.feasible:
            return None
        return sum(p.n_replicas for p in self.pools)

    @property
    def c_eff(self) -> Optional[float]:
        """Blended $/M output tokens across the whole arm."""
        if not self.feasible:
            return None
        # HeterogeneousMix does not expose total tps; recover it from
        # the identity c_eff = price * 1e6 / (3600 * tps) per pool
        total_tps = sum(
            p.fleet_price_per_hr * 1e6 / (3600.0 * p.c_eff)
            for p in self.pools if math.isfinite(p.c_eff) and p.c_eff > 0)
        if total_tps <= 0:
            return None
        return self.fleet_price_per_hr * 1e6 / (3600.0 * total_tps)

    @property
    def greedy_beaten_pools(self) -> Tuple[PoolAllocation, ...]:
        return tuple(p for p in self.pools
                     if p.certificate and p.certificate.greedy_beaten)

    @property
    def max_gap(self) -> float:
        gaps = [p.certificate.gap for p in self.pools if p.certificate]
        return max(gaps) if gaps else 0.0


@dataclasses.dataclass(frozen=True)
class PortfolioPlan:
    """The full portfolio verdict for one workload on one store."""
    workload: Workload
    arms: Dict[str, ArmPlan]
    routing: "object"                 # RoutingResult (import cycle)
    chip_budget: Optional[int] = None

    @property
    def feasible(self) -> bool:
        return all(a.feasible for a in self.arms.values())

    @property
    def within_chip_budget(self) -> Optional[bool]:
        """Whether the cheapest arm fits the chip budget (None when no
        budget was set or the plan is infeasible)."""
        if self.chip_budget is None:
            return None
        chips = self.arms["routed_pool"].n_chips
        return None if chips is None else chips <= self.chip_budget

    def savings(self) -> Dict[str, Optional[float]]:
        """Fractional $/hr savings: consolidation (silo ->
        flagship_pool), routing (flagship_pool -> routed_pool), and
        total (silo -> routed_pool). None where either arm is
        infeasible — a saving vs. an unpriceable baseline is not a
        number."""
        def frac(a: str, b: str) -> Optional[float]:
            pa = self.arms[a].fleet_price_per_hr
            pb = self.arms[b].fleet_price_per_hr
            if pa is None or pb is None or pa <= 0:
                return None
            return 1.0 - pb / pa
        return {"consolidation": frac("silo", "flagship_pool"),
                "routing": frac("flagship_pool", "routed_pool"),
                "total": frac("silo", "routed_pool")}


def _price_pool(curves_by: Dict[Tuple[str, str],
                                List[DeploymentCurve]],
                model: str, io_shape: str, lam: float,
                class_names: Tuple[str, ...], slo: Optional[SLOTarget],
                max_allocations: int) -> PoolAllocation:
    group = curves_by.get((model, io_shape), [])
    if not group:
        return PoolAllocation(
            model=model, io_shape=io_shape, lam=lam,
            class_names=class_names, feasible=False, mix=None,
            certificate=None,
            why_infeasible=f"no fitted curves for ({model}, {io_shape}) "
                           "in this store")
    mix = greedy_mix(group, lam, slo, max_allocations=max_allocations)
    cert = certify(group, lam, slo, max_allocations=max_allocations,
                   greedy=mix)
    if mix is None or not math.isfinite(mix.c_eff):
        return PoolAllocation(
            model=model, io_shape=io_shape, lam=lam,
            class_names=class_names, feasible=False, mix=None,
            certificate=cert,
            why_infeasible=f"no SLO-feasible allocation serves "
                           f"lam={lam:g} on the measured curves")
    return PoolAllocation(model=model, io_shape=io_shape, lam=lam,
                          class_names=class_names, feasible=True,
                          mix=mix, certificate=cert)


def plan_portfolio(curves: Sequence[DeploymentCurve],
                   workload: Workload,
                   slo: Optional[SLOTarget] = None,
                   max_allocations: int = 16,
                   chip_budget: Optional[int] = None) -> PortfolioPlan:
    """Price `workload` on one store's fitted curves across the three
    arms and certify every pool allocation. Pure and deterministic."""
    from repro_torch.planner.routing import route_workload

    routing = route_workload(workload, curves, slo=slo,
                             max_allocations=max_allocations)
    curves_by: Dict[Tuple[str, str], List[DeploymentCurve]] = {}
    for c in curves:
        curves_by.setdefault((c.model, c.io_shape), []).append(c)

    bad = tuple(d.name for d in routing.infeasible_classes)

    def price(model: str, io_shape: str, lam: float,
              names: Tuple[str, ...]) -> PoolAllocation:
        return _price_pool(curves_by, model, io_shape, lam, names, slo,
                           max_allocations)

    # silo: one dedicated flagship fleet per class, no pooling at all
    silo_pools = tuple(
        price(cls.flagship, cls.io_shape, cls.lam, (cls.name,))
        for cls in workload.classes if cls.name not in bad)

    # flagship_pool / routed_pool: classes blended per (model, io_shape)
    def arm_pools(arm: str) -> Tuple[PoolAllocation, ...]:
        pools = routing.pools(arm)
        return tuple(
            price(model, io_shape,
                  sum(d.lam for d in decisions),
                  tuple(d.name for d in decisions))
            for (model, io_shape), decisions in sorted(pools.items()))

    arms = {
        "silo": ArmPlan(arm="silo", pools=silo_pools,
                        infeasible_classes=bad),
        "flagship_pool": ArmPlan(arm="flagship_pool",
                                 pools=arm_pools("flagship"),
                                 infeasible_classes=bad),
        "routed_pool": ArmPlan(arm="routed_pool",
                               pools=arm_pools("routed"),
                               infeasible_classes=bad),
    }
    return PortfolioPlan(workload=workload, arms=arms, routing=routing,
                         chip_budget=chip_budget)
