"""Time-aware planning: price a 24h lambda(t) profile from fitted curves.

`analyze.diurnal_tables` prices the committed day scenarios from their
dedicated stores (exact stationary measurements at every per-replica
rate a trajectory visits). This module is the planner-side counterpart:
it prices a `DayScenario`'s profile against ANY store's fitted
`DeploymentCurve`s — interpolating per-replica throughput from whatever
ladder the store measured — so an operator can ask "what does my day of
traffic cost on each footprint, static vs autoscaled?" from e.g. the
dense `paper_atlas` store without running new cells.

Interpolated prices inherit the curves' caveats: queries outside a
curve's demonstrated span are clamped to its edge knots and the result
is flagged `interpolated_beyond_span` (the §5.6 'modeled continuation'
caveat, time-resolved). The exact-store path in `analyze` has no such
caveat — its ladder measures every visited rate by construction.

    PYTHONPATH=src python -m repro_torch.planner --plan paper_atlas \\
        --day paper_day
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

from repro_torch.planner.curves import DeploymentCurve
from repro_torch.planner.tables import _clean
from repro_torch.serving.arrivals import IO_SHAPES
from repro_torch.serving.autoscale import (DayScenario, SLOAutoscalePolicy,
                                     price_day)

# tokens a completed request delivers, per io_shape — converts a curve's
# saturation throughput (tok/s) into a per-replica request capacity
OUT_TOKENS = {shape: float(out) for shape, (_, out) in IO_SHAPES.items()}


def curve_lam_cap(curve: DeploymentCurve) -> float:
    """Demonstrated per-replica request capacity: saturation tokens/s
    over tokens per request. Falls back to the demonstrated lam span's
    top for io_shapes without a fixed output length."""
    out_tok = OUT_TOKENS.get(curve.io_shape)
    if out_tok:
        return curve.theta_max / out_tok
    return curve.lam_max


def day_price_for_curve(curve: DeploymentCurve, scenario: DayScenario,
                        slo_policy: SLOAutoscalePolicy = None) -> Dict:
    """Price the scenario's day on one footprint: static fleet sized for
    the peak vs every scenario policy, per-replica throughput
    interpolated from the curve (clamped to its demonstrated span).

    With `slo_policy` an SLO-aware trajectory is
    added head-to-head: it scales on the curve's fitted TTFT p90 at the
    previous window's realized per-replica rate, and every policy row
    gains `slo_violation_minutes` scored against the same fitted p90 —
    so the table shows both what each controller costs AND how long it
    leaves the day out of SLO."""
    lam_cap = curve_lam_cap(curve)

    def clamp(lam_per: float) -> float:
        return min(max(lam_per, curve.lam_min), curve.lam_max)

    def tps_at(lam_per: float) -> float:
        return curve.tps(clamp(lam_per))

    def ttft_p90_at(lam_per: float) -> float:
        return curve.interp("ttft_p90_ms", clamp(lam_per))

    from repro_torch.serving.autoscale import (simulate_policy,
                                         simulate_slo_policy,
                                         slo_violation_minutes,
                                         static_size, static_windows)
    replicas = static_size(scenario.peak_lam, lam_cap, scenario.util_sla)
    trajs = {"static": static_windows(replicas, scenario.window_rates,
                                      scenario.window_s)}
    for pol in scenario.policies:
        trajs[pol.name] = simulate_policy(pol, scenario.window_rates,
                                          scenario.window_s, lam_cap)
    if slo_policy is not None:
        trajs[slo_policy.name] = simulate_slo_policy(
            slo_policy, scenario.window_rates, scenario.window_s,
            ttft_p90_at)

    beyond = set()
    policies = []
    for pname, traj in trajs.items():
        for fw in traj:
            if fw.lam > 0 and fw.serving > 0 \
                    and curve.extrapolated(fw.lam / fw.serving):
                beyond.add(pname)
        priced = price_day(traj, price_per_hr=curve.price_per_hr,
                           tps_at=tps_at, lam_cap=lam_cap)
        if slo_policy is not None:
            priced["slo_violation_minutes"] = slo_violation_minutes(
                traj, ttft_p90_at, slo_policy.ttft_p90_slo_ms)
        policies.append({"policy": pname, **priced})
    finite = [p for p in policies if math.isfinite(p["day_c_eff"])]
    winner = min(finite, key=lambda p: p["day_c_eff"]) if finite else None
    static = next(p for p in policies if p["policy"] == "static")
    saving = None
    if winner is not None and math.isfinite(static["day_c_eff"]) \
            and static["day_c_eff"] > 0:
        saving = 1.0 - winner["day_c_eff"] / static["day_c_eff"]
    slo_extra = {}
    if slo_policy is not None:
        tightest = min(policies, key=lambda p: (
            p["slo_violation_minutes"], p["day_c_eff"] or math.inf))
        slo_extra = {"ttft_p90_slo_ms": slo_policy.ttft_p90_slo_ms,
                     "tightest_slo_policy": tightest["policy"]}
    return _clean({
        "scenario": scenario.name,
        "deployment": curve.label,
        "model": curve.model, "hw": curve.hw, "quant": curve.quant,
        "n_chips": curve.n_chips, "io_shape": curve.io_shape,
        "price_per_hr": curve.price_per_hr, "lam_cap": lam_cap,
        "static_replicas": replicas,
        "window_s": scenario.window_s,
        "n_windows": len(scenario.window_rates),
        "peak_lam": scenario.peak_lam,
        "policies": policies,
        "winner": winner["policy"] if winner else None,
        "autoscaling_pays": bool(winner) and winner["policy"] != "static",
        "winner_saving_vs_static": saving,
        "interpolated_beyond_span": sorted(beyond),
        "dense_curve": curve.dense,
        **slo_extra,
    })


def day_tables(curves: Sequence[DeploymentCurve], scenario: DayScenario,
               slo_policy: SLOAutoscalePolicy = None) -> List[Dict]:
    """One `day_price_for_curve` row per fitted curve, cheapest day
    first — the store-wide answer to "who should serve this day"."""
    rows = [day_price_for_curve(c, scenario, slo_policy) for c in curves]
    rows.sort(key=lambda r: (
        r["policies"] and min(p["day_c_eff"] or math.inf
                              for p in r["policies"]) or math.inf))
    return rows


def render_day(rows: Sequence[Dict], title: str = "") -> str:
    lines = []
    if title:
        lines.append(f"=== cost of a day of traffic: {title} ===")
    if rows:
        r0 = rows[0]
        lines.append(f"profile: {r0['n_windows']} windows x "
                     f"{r0['window_s']:g} s, peak {r0['peak_lam']:g} req/s")
    for row in rows:
        lines.append("")
        lines.append(f"-- {row['deployment']} "
                     f"(static R={row['static_replicas']}, lam_cap "
                     f"{row['lam_cap']:.3g} req/s/replica) --")
        slo_col = any("slo_violation_minutes" in p
                      for p in row["policies"])
        hdr = (f"  {'policy':<10} {'repl-hrs':>8} {'daily $':>8} "
               f"{'Mtok':>7} {'day C_eff':>9} {'peak pen':>8} "
               f"{'idle':>4}")
        if slo_col:
            hdr += f" {'SLO-viol min':>12}"
        lines.append(hdr)
        for p in row["policies"]:
            pen = f"{p['peak_penalty']:.2f}x" \
                if p["peak_penalty"] is not None else "n/a"
            dce = f"{p['day_c_eff']:.4f}" \
                if p["day_c_eff"] is not None else "inf"
            line = (f"  {p['policy']:<10} {p['replica_hours']:>8.2f} "
                    f"{p['daily_cost_usd']:>8.3f} "
                    f"{p['daily_tokens'] / 1e6:>7.2f} {dce:>9} "
                    f"{pen:>8} {p['idle_windows']:>4d}")
            if slo_col:
                line += f" {p.get('slo_violation_minutes', 0.0):>12.1f}"
            lines.append(line)
        if row["winner"]:
            tag = f"cheapest: {row['winner']}"
            if row["winner_saving_vs_static"]:
                tag += (f" ({100 * row['winner_saving_vs_static']:.0f}% "
                        f"below static)")
            if not row["autoscaling_pays"]:
                tag += "  [autoscaling does NOT pay]"
            lines.append(f"  -> {tag}")
        if row.get("tightest_slo_policy"):
            lines.append(f"  -> tightest SLO (p90 TTFT <= "
                         f"{row['ttft_p90_slo_ms']:g} ms): "
                         f"{row['tightest_slo_policy']}")
        if row["interpolated_beyond_span"]:
            lines.append("  (caveat: per-replica rates clamped to the "
                         "measured span for: "
                         + ", ".join(row["interpolated_beyond_span"]) + ")")
    return "\n".join(lines)
