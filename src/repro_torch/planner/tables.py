"""Serializable planner artifacts + the text rendering the CLI prints.

`planner_tables(records)` is a pure function of consolidated store
records (same discipline as `analyze.crosshw_tables`, which embeds it in
`analysis.json`): the fitted per-(model, hw, quant, n_chips) curves — the
per-hardware penalty/cost knots a figure would plot — plus the planner's
recommendation at the paper's reference loads. Non-finite floats are
serialized as None so the artifact stays strict-JSON round-trippable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.records import RunRecord
from repro_torch.core.slo import SLOTarget
from repro_torch.planner.allocate import certify
from repro_torch.planner.curves import DeploymentCurve, fit_curves
from repro_torch.planner.optimize import (DEFAULT_MAX_REPLICAS, CapacityPlan,
                                    plan_capacity)
from repro_torch.planner.portfolio import (ARMS, BLENDED_3CLASS, PortfolioPlan,
                                     Workload, plan_portfolio)

# the paper's idle / knee-region / saturation reference loads (§5)
REFERENCE_LAMS = (1.0, 10.0, 200.0)
# total portfolio rates the blended-workload verdict is evaluated at
PORTFOLIO_LAMS = REFERENCE_LAMS


def _clean(obj):
    """Recursively replace non-finite floats with None (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    return obj


def curve_rows(curves: Sequence[DeploymentCurve]) -> List[dict]:
    """The fitted curves as plottable knot tables (per-hw figure input).
    Ensemble-fitted curves additionally carry `bands`: per
    metric the lambda-aligned central-95% bootstrap band, ready to plot
    as a ribbon around the knots."""
    rows = []
    for c in curves:
        rows.append(_clean({
            "model": c.model, "hw": c.hw, "quant": c.quant,
            "n_chips": c.n_chips, "io_shape": c.io_shape,
            "price_per_hr": c.price_per_hr, "theta_max": c.theta_max,
            "dense": c.dense, "monotone_c_eff": c.monotone_c_eff,
            "lam_min": c.lam_min, "lam_max": c.lam_max,
            "lams": [r.lam for r in c.records],
            "c_eff": [r.c_eff for r in c.records],
            "util": [r.util for r in c.records],
            "ttft_p90_ms": [r.ttft_p90_ms for r in c.records],
            "tpot_p99_ms": [r.tpot_p99_ms for r in c.records],
            "bands": {metric: {"lams": [p[0] for p in pts],
                               "lo": [p[1] for p in pts],
                               "hi": [p[2] for p in pts]}
                      for metric, pts in sorted(c.bands.items())},
        }))
    return rows


def plan_row(plan: CapacityPlan) -> dict:
    best = plan.best
    return _clean({
        "model": plan.model, "lam": plan.lam, "io_shape": plan.io_shape,
        "slo": plan.slo.describe() if plan.slo else None,
        "availability": plan.avail.describe() if plan.avail else None,
        "feasible": plan.feasible,
        "n_feasible": len(plan.ranked),
        "n_rejected": len(plan.rejected),
        "best": dataclasses.asdict(best) if best else None,
        "ranked": [dataclasses.asdict(o) for o in plan.ranked],
        "mix": dataclasses.asdict(plan.mix) if plan.mix else None,
        "crossover": plan.crossover,
    })


def certification_rows(curves: Sequence[DeploymentCurve],
                       lams: Sequence[float] = REFERENCE_LAMS,
                       slo: Optional[SLOTarget] = None) -> List[dict]:
    """greedy_mix judged against the exact branch-and-bound optimum for
    every (model, io_shape) group at every reference load. A row with
    ``greedy_beaten`` true is the loud signal the heuristic left money
    on the table — it is always emitted, never filtered."""
    groups: dict = {}
    for c in curves:
        groups.setdefault((c.model, c.io_shape), []).append(c)
    rows = []
    for (model, io_shape), group in sorted(groups.items()):
        for lam in lams:
            cert = certify(group, lam, slo)
            if cert is None:
                rows.append(_clean({
                    "model": model, "io_shape": io_shape, "lam": lam,
                    "feasible": False, "gap": None,
                    "greedy_beaten": False}))
                continue
            rows.append(_clean({
                "model": model, "io_shape": io_shape, "lam": lam,
                "feasible": True,
                "greedy_c_eff": cert.greedy_c_eff,
                "exact_c_eff": cert.exact_c_eff,
                "greedy_label": cert.greedy_label,
                "exact_label": cert.exact_label,
                "gap": cert.gap, "greedy_beaten": cert.greedy_beaten,
                "n_nodes": cert.n_nodes,
                "verdict": cert.describe()}))
    return rows


def _pool_row(pool) -> dict:
    return _clean({
        "model": pool.model, "io_shape": pool.io_shape, "lam": pool.lam,
        "classes": list(pool.class_names), "feasible": pool.feasible,
        "why_infeasible": pool.why_infeasible or None,
        "c_eff": pool.c_eff,
        "fleet_price_per_hr": pool.fleet_price_per_hr,
        "n_replicas": pool.n_replicas, "n_chips": pool.n_chips,
        "label": pool.mix.label if pool.mix else None,
        "gap": pool.certificate.gap if pool.certificate else None,
        "greedy_beaten": bool(pool.certificate.greedy_beaten)
        if pool.certificate else False,
    })


def portfolio_row(plan: PortfolioPlan) -> dict:
    """One portfolio verdict (one workload scale) as strict JSON."""
    arms = {}
    for name in ARMS:
        arm = plan.arms[name]
        arms[name] = {
            "feasible": arm.feasible,
            "fleet_price_per_hr": arm.fleet_price_per_hr,
            "c_eff": arm.c_eff,
            "n_replicas": arm.n_replicas, "n_chips": arm.n_chips,
            "max_gap": arm.max_gap,
            "greedy_beaten_pools": [p.model
                                    for p in arm.greedy_beaten_pools],
            "pools": [_pool_row(p) for p in arm.pools],
            "infeasible_classes": list(arm.infeasible_classes),
        }
    routing = [{
        "class": d.name, "lam": d.lam, "io_shape": d.io_shape,
        "budget_tokens": d.budget_tokens, "flagship": d.flagship,
        "routed": d.routed, "feasible": d.feasible,
        "why_infeasible": d.why_infeasible or None,
        "quotes": [{"model": q.model, "feasible": q.feasible,
                    "c_eff": q.c_eff,
                    "why_infeasible": q.why_infeasible or None}
                   for q in d.quotes],
    } for d in plan.routing.decisions]
    return _clean({
        "workload": plan.workload.name,
        "lam_total": plan.workload.lam_total,
        "classes": [c.to_dict() for c in plan.workload.classes],
        "feasible": plan.feasible,
        "chip_budget": plan.chip_budget,
        "within_chip_budget": plan.within_chip_budget,
        "routing": routing,
        "arms": arms,
        "savings": plan.savings(),
    })


def portfolio_rows(curves: Sequence[DeploymentCurve],
                   workload: Workload = BLENDED_3CLASS,
                   lams: Sequence[float] = PORTFOLIO_LAMS,
                   slo: Optional[SLOTarget] = None,
                   chip_budget: Optional[int] = None) -> List[dict]:
    """The blended-workload verdict at each total rate in `lams`."""
    return [portfolio_row(plan_portfolio(
        curves, workload.scaled(lam), slo=slo, chip_budget=chip_budget))
        for lam in lams]


def planner_tables(records: Sequence[RunRecord],
                   lams: Sequence[float] = REFERENCE_LAMS,
                   slo: Optional[SLOTarget] = None,
                   max_replicas: int = DEFAULT_MAX_REPLICAS,
                   workload: Workload = BLENDED_3CLASS) -> dict:
    """The planner payload `analyze.crosshw_tables` embeds in
    analysis.json: fitted curves + recommendations at reference loads,
    plus the greedy-vs-exact certification table and the portfolio
    verdict for the blended workload."""
    curves = fit_curves(records)
    recommendations = []
    for lam in lams:
        for plan in plan_capacity(curves, lam, slo,
                                  max_replicas=max_replicas):
            recommendations.append(plan_row(plan))
    return {
        "reference_lams": list(lams),
        "curves": curve_rows(curves),
        "recommendations": recommendations,
        "certification": certification_rows(curves, lams, slo),
        "portfolio": portfolio_rows(curves, workload, lams, slo),
    }


# ---------------------------------------------------------------------------
# text rendering (CLI + example)
# ---------------------------------------------------------------------------


def _ms(v: float) -> str:
    return "-" if not math.isfinite(v) else f"{v:.0f}ms"


def _flags(o) -> str:
    out = []
    if o.spares:
        out.append(f"+{o.spares} spare(s) @ {o.availability:.4g} avail")
    if o.extrapolated:
        out.append("extrapolated")
    if not o.dense:
        out.append("sparse-ladder")
    return ",".join(out)


def render_plan(plan: CapacityPlan, top: int = 6) -> str:
    lines = [f"-- {plan.model} @ lambda={plan.lam:g} rps "
             f"({plan.io_shape}) --"]
    if not plan.feasible:
        lines.append("  INFEASIBLE: no measured deployment serves this "
                     "load" + (f" within the SLO ({plan.slo.describe()})"
                               if plan.slo else ""))
        reasons = sorted({o.why_infeasible for o in plan.rejected})
        for why in reasons[:4]:
            lines.append(f"    - {why}")
    else:
        lines.append(
            f"  {'rank':<4} {'deployment':<34} {'R':>2} {'lam/R':>7} "
            f"{'util':>5} {'pen':>6} {'$/hr':>7} {'$/M-tok':>8} "
            f"{'TTFT p90':>9}  flags")
        for i, o in enumerate(plan.ranked[:top], 1):
            dep = f"{o.hw}/{o.quant} x{o.n_chips}"
            lines.append(
                f"  {i:<4} {dep:<34} {o.replicas:>2} "
                f"{o.lam_per_replica:>7.3g} {o.util:>5.2f} "
                f"{o.penalty:>5.1f}x {o.fleet_price_per_hr:>7.2f} "
                f"{o.c_eff:>8.3f} {_ms(o.ttft_p90_ms):>9}  {_flags(o)}")
        if len(plan.ranked) > top:
            lines.append(f"  ... {len(plan.ranked) - top} more feasible "
                         f"option(s)")
        if plan.rejected:
            lines.append(f"  rejected {len(plan.rejected)} option(s): "
                         + "; ".join(sorted(
                             {o.why_infeasible for o in plan.rejected}))[:160])
    if plan.mix is not None and len(plan.mix.allocations) > 1:
        best = plan.best
        verdict = ("beats the best homogeneous fleet"
                   if best and plan.mix.c_eff < best.c_eff else
                   "no cheaper than the best homogeneous fleet")
        lines.append(f"  mix ({verdict}): {plan.mix.label} -> "
                     f"${plan.mix.c_eff:.3f}/M-tok at "
                     f"${plan.mix.fleet_price_per_hr:.2f}/hr")
    lines.append("  vs API tiers (list price, no SLA — §6.4 gate "
                 "acknowledged):")
    best = plan.best
    for tier in plan.crossover:
        lam_star = tier["lambda_star"]
        if best is not None:
            cheaper = best.c_eff <= tier["api_output_per_mtok"]
            now = "self-host CHEAPER" if cheaper else "API cheaper"
        else:
            now = "no feasible self-host point"
        if tier["self_host_always_cheaper"]:
            star = "always cheaper on the measured curve"
        elif math.isinf(lam_star):
            star = "never crosses on the measured curve"
        else:
            star = f"crossover at lam*={lam_star:.2f} rps"
        lines.append(f"    {tier['tier']:<18} "
                     f"(${tier['api_output_per_mtok']:>5.2f}/M-tok): "
                     f"{now} at lam={plan.lam:g}; {star}")
    return "\n".join(lines)


def render_plans(plans: Sequence[CapacityPlan], title: str = "") -> str:
    lines = []
    if title:
        lines.append(f"=== capacity plan: {title} ===")
    if plans and plans[0].slo is not None:
        lines.append(f"SLO target: {plans[0].slo.describe()}")
    if plans and plans[0].avail is not None:
        lines.append(f"availability target: {plans[0].avail.describe()} "
                     "— spares priced as utilization loss")
    for plan in plans:
        lines.append("")
        lines.append(render_plan(plan))
    return "\n".join(lines)


def _money(v: Optional[float]) -> str:
    return "-" if v is None or not math.isfinite(v) else f"{v:.2f}"


def render_portfolio(plan: PortfolioPlan) -> str:
    """The portfolio verdict as the CLI prints it: routing decisions,
    the three arms side by side, certification flags, and the savings
    decomposition."""
    w = plan.workload
    lines = [f"== portfolio: {w.name} @ {w.lam_total:g} rps total =="]
    for d in plan.routing.decisions:
        if not d.feasible:
            lines.append(f"  {d.name:<14} lam={d.lam:<7.3g} "
                         f"INFEASIBLE: {d.why_infeasible}")
            continue
        arrow = (f"{d.flagship} -> {d.routed}" if d.routed_off_flagship
                 else f"stays on {d.flagship}")
        q = d.routed_quote
        lines.append(f"  {d.name:<14} lam={d.lam:<7.3g} "
                     f"budget={d.budget_tokens:<5d} {arrow} "
                     f"(${q.c_eff:.3f}/M-tok standalone)")
    lines.append("")
    lines.append(f"  {'arm':<14} {'$/hr':>8} {'$/M-tok':>8} "
                 f"{'chips':>5} {'repl':>4}  allocation")
    for name in ARMS:
        arm = plan.arms[name]
        if not arm.feasible:
            why = "; ".join(
                [f"{p.model}: {p.why_infeasible}" for p in arm.pools
                 if not p.feasible]
                + [f"{c}: unroutable" for c in arm.infeasible_classes])
            lines.append(f"  {name:<14} INFEASIBLE: {why[:120]}")
            continue
        label = " | ".join(f"{p.model}: {p.mix.label}"
                           for p in arm.pools)
        lines.append(f"  {name:<14} {_money(arm.fleet_price_per_hr):>8} "
                     f"{_money(arm.c_eff):>8} {arm.n_chips:>5} "
                     f"{arm.n_replicas:>4}  {label}")
        for p in arm.greedy_beaten_pools:
            lines.append(f"      !! greedy BEATEN on {p.model}: "
                         f"{p.certificate.describe()}")
    sav = plan.savings()

    def pct(v: Optional[float]) -> str:
        return "n/a" if v is None else f"{100 * v:+.1f}%"
    lines.append(f"  savings on the bill vs silo: "
                 f"consolidation {pct(sav['consolidation'])}, "
                 f"routing {pct(sav['routing'])}, "
                 f"total {pct(sav['total'])}")
    if plan.chip_budget is not None:
        fit = plan.within_chip_budget
        lines.append(f"  chip budget {plan.chip_budget}: "
                     + ("n/a" if fit is None else
                        "routed arm FITS" if fit else
                        "routed arm EXCEEDS budget"))
    return "\n".join(lines)


def render_certification(rows: Sequence[dict]) -> str:
    """The greedy-vs-exact table. Beaten rows shout; optimal rows are
    one quiet line each."""
    lines = ["== greedy_mix vs exact allocator =="]
    beaten = [r for r in rows if r.get("greedy_beaten")]
    for r in rows:
        if not r.get("feasible"):
            lines.append(f"  {r['model']:<16} lam={r['lam']:<7g} "
                         "infeasible for both arms")
            continue
        mark = "!! BEATEN" if r["greedy_beaten"] else "ok"
        gap = r.get("gap")
        lines.append(f"  {r['model']:<16} lam={r['lam']:<7g} "
                     f"gap={gap if gap is not None else float('nan'):.2e} "
                     f"{mark}  greedy={r['greedy_label']}")
    lines.append(f"  {len(beaten)}/{len(rows)} instances beat greedy"
                 if beaten else
                 f"  greedy certified optimal on all {len(rows)} "
                 "instances")
    return "\n".join(lines)
