"""Exact replica allocation: a branch-and-bound search that certifies
`greedy_mix`.

`greedy_mix` is the Mélange-style heuristic: repeatedly hand the
largest SLO-feasible slice of the remaining load to whichever footprint
prices it cheapest. Mélange (Griggs et al., PAPERS.md) observes that at
realistic fleet sizes the underlying allocation problem is a small
integer program that can be solved *exactly* — so instead of trusting
the greedy pass, this module searches its entire decision space and
reports the optimality gap.

The decision space (identical to greedy's closure): a fleet serving one
(model, io_shape) at offered rate lambda is a multiset of *full*
replicas — each loaded to its SLO-feasible cap — plus at most one
*tail* replica carrying the remainder (every greedy step serves
``min(remaining, cap)``, so a partial replica always ends the
sequence). The objective is the same blended $/M-token both arms
evaluate identically::

    c_eff = total_price_per_hr * 1e6 / (3600 * sum_i tps_i(load_i))

Because greedy's solutions are a subset of this space and both sides
share one evaluation function, the certified gap is nonnegative by
construction; a negative gap is a search bug and raises instead of
being clamped away.

The search is a depth-first branch-and-bound over footprint counts,
ordered deterministically by curve key. The prune is the mediant bound:
every replica added from a node onward costs at least
``u_min = min_f price_f / tps_f(cap_f)`` dollars per token (tps is
non-decreasing in load, so a replica is never cheaper per token below
its cap), and ``(P + dP) / (T + dT) >= min(P/T, dP/dT)`` — so once
``min(P/T, u_min)`` cannot beat the incumbent, the whole subtree is
dead. Store-scale instances (<= ~8 footprints, <= 16 replicas) explore
a few hundred nodes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.slo import SLOTarget
from repro_torch.planner.curves import DeploymentCurve
from repro_torch.planner.optimize import (HeterogeneousMix, MixAllocation,
                                    greedy_mix, require_one_model,
                                    slo_feasible_cap)

# a greedy-vs-exact ratio within this relative tolerance is float noise
# (the two sides sum the same terms in different orders), reported as a
# clean 0.0 gap; anything beyond it is a real greedy loss
GAP_RTOL = 1e-9
# replica budget shared with greedy_mix so the certificate compares
# like against like
DEFAULT_MAX_ALLOCATIONS = 16
# $/M-tok from a $/hr-over-tokens/s ratio
_MTOK_PER_HR = 1e6 / 3600.0


@dataclasses.dataclass(frozen=True)
class ExactMix:
    """The provably cheapest replica multiset for one (model, io_shape)
    at one offered rate — same shape as `HeterogeneousMix`, plus the
    search observability fields."""
    model: str
    io_shape: str
    lam: float
    allocations: Tuple[MixAllocation, ...]
    c_eff: float                # blended $/M output tokens
    fleet_price_per_hr: float
    total_tps: float
    n_nodes: int                # branch-and-bound nodes explored

    @property
    def n_replicas(self) -> int:
        return len(self.allocations)

    @property
    def n_chips(self) -> int:
        return sum(a.n_chips for a in self.allocations)

    @property
    def label(self) -> str:
        groups: List[list] = []
        for a in self.allocations:
            tag = (a.hw, a.quant, a.n_chips, f"{a.lam:.3g}")
            if groups and groups[-1][0] == tag:
                groups[-1][1] += 1
            else:
                groups.append([tag, 1])
        return " + ".join(
            (f"{n}x " if n > 1 else "") + f"{hw}/{quant} x{chips}@{lam}rps"
            for (hw, quant, chips, lam), n in groups)


@dataclasses.dataclass(frozen=True)
class Certificate:
    """greedy_mix judged against the exact optimum on one instance.
    ``gap`` is greedy's relative cost excess (0.0 = certified optimal,
    inf = greedy found nothing where exact did); ``greedy_beaten`` is
    the loud flag every table row must surface, never hide."""
    model: str
    io_shape: str
    lam: float
    greedy_c_eff: float         # inf when greedy returned None
    exact_c_eff: float
    greedy_label: str
    exact_label: str
    gap: float
    greedy_beaten: bool
    n_nodes: int

    def describe(self) -> str:
        if math.isinf(self.gap):
            return (f"greedy found NO allocation at lam={self.lam:g}; "
                    f"exact serves it at ${self.exact_c_eff:.4f}/M-tok "
                    f"({self.exact_label})")
        if self.greedy_beaten:
            return (f"greedy BEATEN by {100 * self.gap:.2f}% at "
                    f"lam={self.lam:g}: {self.greedy_label} -> "
                    f"{self.exact_label}")
        return f"greedy optimal at lam={self.lam:g} (gap 0)"


def _mix_allocation(curve: DeploymentCurve, load: float) -> MixAllocation:
    return MixAllocation(
        hw=curve.hw, quant=curve.quant, n_chips=curve.n_chips, lam=load,
        c_eff=curve.c_eff(load), util=curve.util(load),
        price_per_hr=curve.price_per_hr,
        extrapolated=curve.extrapolated(load))


def exact_mix(curves: Sequence[DeploymentCurve], lam: float,
              slo: Optional[SLOTarget] = None,
              max_allocations: int = DEFAULT_MAX_ALLOCATIONS
              ) -> Optional[ExactMix]:
    """The cheapest blended-$/M-token replica multiset serving `lam`
    within the SLO, found by exhaustive branch-and-bound over full-cap
    footprint counts + one tail. None when no multiset of at most
    `max_allocations` SLO-feasible replicas covers the load (the same
    refusal greedy_mix makes, proven rather than heuristic)."""
    model, io_shape = require_one_model(curves)
    fleet = []
    for c in sorted(curves, key=lambda c: c.key):
        cap = slo_feasible_cap(c, slo)
        if cap <= 0:
            continue
        tps_cap = c.tps(cap)
        if math.isfinite(tps_cap) and tps_cap > 0 \
                and math.isfinite(c.price_per_hr):
            fleet.append((c, cap, tps_cap))
    if not fleet:
        return None
    eps = 1e-9 * lam
    # mediant-bound density: no replica anywhere prices below this $/tok
    u_min = min(c.price_per_hr / tps_cap for c, _, tps_cap in fleet)
    best_ratio = math.inf          # $/hr per token/s (c_eff / _MTOK_PER_HR)
    best: Optional[Tuple[Tuple[int, float], ...]] = None
    n_nodes = 0

    def close(stack: Tuple[Tuple[int, float], ...], price: float,
              tps: float, remaining: float, used: int) -> None:
        """Try every way of finishing the current full-replica multiset:
        done already, or one tail replica carrying the remainder."""
        nonlocal best_ratio, best
        if remaining <= eps:
            if tps > 0 and price / tps < best_ratio:
                best_ratio, best = price / tps, stack
            return
        if used >= max_allocations:
            return
        for idx, (c, cap, _) in enumerate(fleet):
            if cap + eps < remaining:
                continue                   # cannot be a tail, only a full
            tail_tps = c.tps(remaining)
            total = tps + tail_tps
            if total > 0 and (price + c.price_per_hr) / total < best_ratio:
                best_ratio = (price + c.price_per_hr) / total
                best = stack + ((idx, remaining),)

    def dfs(start: int, stack: Tuple[Tuple[int, float], ...],
            price: float, tps: float, remaining: float, used: int) -> None:
        nonlocal n_nodes
        n_nodes += 1
        close(stack, price, tps, remaining, used)
        if used >= max_allocations:
            return
        # mediant prune: every further replica costs >= u_min per token,
        # so no descendant can price below min(current ratio, u_min)
        floor = u_min if tps <= 0 else min(price / tps, u_min)
        if floor >= best_ratio:
            return
        for idx in range(start, len(fleet)):
            c, cap, tps_cap = fleet[idx]
            if cap < remaining - eps:      # room for a full replica
                dfs(idx, stack + ((idx, cap),), price + c.price_per_hr,
                    tps + tps_cap, remaining - cap, used + 1)

    dfs(0, (), 0.0, 0.0, lam, 0)
    if best is None:
        return None
    allocations = tuple(_mix_allocation(fleet[idx][0], load)
                        for idx, load in best)
    price = sum(fleet[idx][0].price_per_hr for idx, _ in best)
    total_tps = sum(fleet[idx][0].tps(load) for idx, load in best)
    return ExactMix(
        model=model, io_shape=io_shape, lam=lam, allocations=allocations,
        c_eff=price * _MTOK_PER_HR / total_tps,
        fleet_price_per_hr=price, total_tps=total_tps, n_nodes=n_nodes)


def certify(curves: Sequence[DeploymentCurve], lam: float,
            slo: Optional[SLOTarget] = None,
            max_allocations: int = DEFAULT_MAX_ALLOCATIONS,
            greedy: Optional[HeterogeneousMix] = None
            ) -> Optional[Certificate]:
    """Run greedy_mix and exact_mix on one instance and report the
    optimality gap. None when the instance is infeasible for both (the
    exact search space contains greedy's, so exact-None implies
    greedy-None; the reverse — greedy blind, exact feasible — is a real
    finding and reports gap = inf). Pass `greedy` to certify an
    already-computed mix without re-running the heuristic."""
    if greedy is None:
        greedy = greedy_mix(curves, lam, slo,
                            max_allocations=max_allocations)
    exact = exact_mix(curves, lam, slo, max_allocations=max_allocations)
    if exact is None:
        if greedy is not None:
            raise RuntimeError(
                "exact allocator found nothing where greedy_mix "
                f"did (lam={lam:g}) — the search space must contain "
                "every greedy solution; this is a bug")
        return None
    greedy_c = greedy.c_eff if greedy is not None else math.inf
    gap = greedy_c / exact.c_eff - 1.0
    if gap < -GAP_RTOL:
        raise RuntimeError(
            f"greedy_mix ({greedy_c:.6g}) undercut the 'exact' optimum "
            f"({exact.c_eff:.6g}) at lam={lam:g} — the branch-and-bound "
            "missed part of its own space; this is a bug")
    if abs(gap) <= GAP_RTOL:
        gap = 0.0
    return Certificate(
        model=exact.model, io_shape=exact.io_shape, lam=lam,
        greedy_c_eff=greedy_c, exact_c_eff=exact.c_eff,
        greedy_label=greedy.label if greedy is not None else "-",
        exact_label=exact.label, gap=gap,
        greedy_beaten=gap > GAP_RTOL, n_nodes=exact.n_nodes)
