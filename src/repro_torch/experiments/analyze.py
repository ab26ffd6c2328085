"""Derive the paper's figures from an experiment store.

Everything here is a pure function of the consolidated records (no
engines are re-run): penalty-vs-lambda curves through `core.cost`, API
crossover points through `core.crossover`, the active-params saturation
ordering (§5.2), and the per-hardware FP8 uplift table (§5.3's
hardware-conditional inversion).

Cross-hardware tables (from a multi-hardware store such as
`paper_crosshw`): the spread-compression table — per (model, quant) the
min/max C_eff and load-driven spread on every hardware generation plus
the compression ratio between the widest and narrowest part (the paper's
2.5-36.3x H100 vs 7.0-11.4x A100 replication, §5.9/§7) — the FP8-uplift
table conditioned on native-fp8 hardware, and whether the active-params
saturation ordering survives on every generation.

    PYTHONPATH=src python -m repro_torch.experiments.analyze --plan paper_a100
    PYTHONPATH=src python -m repro_torch.experiments.analyze --plan paper_crosshw \
        --json results/experiments/paper_crosshw/analysis.json
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost import c_naive, underutilization_penalty
from repro_torch.core.crossover import crossover_table
from repro_torch.core.records import RunRecord
from repro_torch.simulate.hardware import HW_BY_NAME


def _groups(records: Sequence[RunRecord]
            ) -> Dict[Tuple, List[RunRecord]]:
    """(model, hw, quant, n_chips, io_shape) -> ladder-ordered records.

    Resilient records (injected failures / client retries) are
    excluded: they sit at the same coordinates as their failure-free
    siblings and would pollute the classic cost curves with degraded
    points. They are analyzed by `reliability_tables` instead.
    Non-stationary records (config prefixed `profile:`) are
    excluded too: their `lam` is the nominal mean of lambda(t), not a
    stationary offered rate, so they are not ladder knots. Flash-crowd
    records (config prefixed `flash:`) are both non-stationary
    (MMPP bursts) and degradation-shaped; `overload_tables` owns them."""
    out: Dict[Tuple, List[RunRecord]] = {}
    for r in records:
        if r.mttf > 0.0 or r.retry_max > 0:
            continue
        if r.config.startswith(("profile:", "flash:")):
            continue
        key = (r.model, r.hw, r.quant, r.n_chips, r.io_shape)
        out.setdefault(key, []).append(r)
    for group in out.values():
        group.sort(key=lambda r: r.lam)
    return out


def penalty_curves(records: Sequence[RunRecord]) -> List[dict]:
    """Per group: the load-driven C_eff spread — idle-edge penalty, the
    saturation floor, and the max/min cost ratio across the ladder (the
    paper's 2.5-24x underutilization headline lives here)."""
    out = []
    for key, group in _groups(records).items():
        ceffs = [r.c_eff for r in group]
        naive = c_naive(group[0].price_per_hr, group[0].theta_max)
        out.append({
            "model": key[0], "hw": key[1], "quant": key[2],
            "n_chips": key[3], "io_shape": key[4],
            "lams": [r.lam for r in group],
            "c_eff": ceffs,
            "penalty": [underutilization_penalty(r.tps, r.theta_max)
                        for r in group],
            "util": [r.util for r in group],
            "c_naive": naive,
            "idle_penalty": underutilization_penalty(group[0].tps,
                                                     group[0].theta_max),
            "spread": max(ceffs) / min(ceffs),
            "theta_max": group[0].theta_max,
        })
    return out


def active_params_ordering(records: Sequence[RunRecord]
                           ) -> List[dict]:
    """§5.2: saturation throughput per (hw, quant) ranked against active
    parameter counts — active params, not total, should order theta_max.
    Plans deploy models at different TP degrees (bf16 fit), so the
    ordering compares *per-chip* saturation throughput."""
    from repro_torch.configs import get_config
    rows: Dict[Tuple, List[dict]] = {}
    for key, group in _groups(records).items():
        model, hw, quant, n_chips = key[0], key[1], key[2], key[3]
        try:
            cfg = get_config(model)
            active = cfg.active_param_count()
            total = cfg.param_count()
        except KeyError:
            active = total = float("nan")
        rows.setdefault((hw, quant), []).append({
            "model": model, "active_params": active, "total_params": total,
            "theta_max": group[0].theta_max, "n_chips": n_chips,
            "theta_max_per_chip": group[0].theta_max / n_chips,
            "sat_c_eff": min(r.c_eff for r in group),
        })
    out = []
    for (hw, quant), models in sorted(rows.items()):
        models.sort(key=lambda m: -m["theta_max_per_chip"])
        by_active = sorted(models, key=lambda m: m["active_params"])
        out.append({
            "hw": hw, "quant": quant, "ranking": models,
            "ordered_by_active_params":
                [m["model"] for m in models] ==
                [m["model"] for m in by_active],
        })
    return out


def fp8_uplift(records: Sequence[RunRecord],
               baseline: str = "bf16", variant: str = "fp8") -> List[dict]:
    """§5.3 / §5.9: per (hw, model) saturation-TPS and cost uplift of the
    quantized variant over bf16. uplift < 1 is the paper's inversion —
    expected for compute-bound dense models on non-native-fp8 parts."""
    sat: Dict[Tuple, Dict[str, dict]] = {}
    for key, group in _groups(records).items():
        model, hw, quant = key[0], key[1], key[2]
        sat.setdefault((hw, model), {})[quant] = {
            "theta_max": group[0].theta_max,
            "sat_c_eff": min(r.c_eff for r in group),
        }
    out = []
    for (hw, model), by_quant in sorted(sat.items()):
        if baseline not in by_quant or variant not in by_quant:
            continue
        base, var = by_quant[baseline], by_quant[variant]
        out.append({
            "hw": hw, "model": model,
            "tps_uplift": var["theta_max"] / base["theta_max"],
            "cost_ratio": var["sat_c_eff"] / base["sat_c_eff"],
            "inverted": var["theta_max"] < base["theta_max"],
        })
    return out


def spread_compression(records: Sequence[RunRecord]) -> List[dict]:
    """§5.9/§7: per (model, quant), the load-driven C_eff spread on every
    hardware generation in the store, plus the compression ratio between
    the widest and the narrowest part. The paper's claim-robustness
    argument is that the spread *reproduces with compressed magnitude* on
    the cheaper part — single-hardware confounding would not survive
    this axis."""
    by_mq: Dict[Tuple, Dict[Tuple, dict]] = {}
    for key, group in _groups(records).items():
        model, hw, quant, n_chips, io_shape = key
        ceffs = [r.c_eff for r in group]
        # distinct footprints (two TP degrees on one part) stay distinct
        # rows instead of silently overwriting each other
        by_mq.setdefault((model, quant, io_shape), {})[(hw, n_chips)] = {
            "hw": hw, "n_chips": n_chips,
            "c_min": min(ceffs), "c_max": max(ceffs),
            "spread": max(ceffs) / min(ceffs),
            "theta_max": group[0].theta_max,
        }
    out = []
    for (model, quant, io_shape), by_hw in sorted(by_mq.items()):
        if len({h for h, _ in by_hw}) < 2:
            continue                 # the table is cross-hardware only
        widest = max(by_hw.values(), key=lambda h: h["spread"])
        narrowest = min(by_hw.values(), key=lambda h: h["spread"])
        out.append({
            "model": model, "quant": quant, "io_shape": io_shape,
            "per_hw": [by_hw[k] for k in sorted(by_hw)],
            "widest_hw": widest["hw"], "narrowest_hw": narrowest["hw"],
            "compression": widest["spread"] / narrowest["spread"],
        })
    return out


def fp8_inversion(records: Sequence[RunRecord],
                  baseline: str = "bf16", variant: str = "fp8"
                  ) -> List[dict]:
    """The FP8-uplift table conditioned on native-fp8 hardware: the
    paper's hardware-conditional caveat says the dense inversion is a
    property of the *part* (emulated-fp8 dequant penalty), not the model —
    so it must appear on non-native hardware and vanish on native-fp8
    hardware. `consistent` records whether each row obeys that rule
    (memory-bound MoEs may legitimately gain everywhere)."""
    out = []
    for row in fp8_uplift(records, baseline=baseline, variant=variant):
        hw = HW_BY_NAME.get(row["hw"])
        native = bool(hw.native_fp8) if hw is not None else False
        out.append({
            **row, "native_fp8": native,
            # an inversion on a native-fp8 part would break the story;
            # a gain on an emulating part is fine (MoEs keep the HBM win)
            "consistent": not (native and row["inverted"]),
        })
    return out


def penalty_atlas(records: Sequence[RunRecord],
                  min_points: int = 10) -> List[dict]:
    """The dense penalty-curve table from a lambda-*continuum*
    store (`paper_atlas`: 25 log-spaced offered rates instead of the
    7-point ladder). Per (model, hw, quant) group the full lambda ->
    (C_eff, penalty, utilization) curve plus the summary scalars the
    sparse ladders can only bracket:

    * `knee_lambda` — the first offered rate whose C_eff is within 25%
      of the saturation cost floor: where the paper's "substantial
      sustained load" condition (§7) actually begins on this hardware.
    * `half_cost_lambda` — the first rate at >=50% utilization (penalty
      <= 2x): the cheapest half of the curve starts here.
    * `idle_penalty` / `spread` — the curve's endpoints, directly
      comparable with the spread-compression table.

    Groups with fewer than `min_points` distinct rates are skipped — the
    atlas is meaningful only for dense stores, so 7-point plans fall
    through to the classic tables untouched. Rows are `penalty_curves`
    rows (one source of truth for the shared scalars) extended with the
    continuum-only fields."""
    out = []
    for row in penalty_curves(records):
        if len(set(row["lams"])) < min_points:
            continue
        floor = min(row["c_eff"])
        knee = next((lam for lam, c in zip(row["lams"], row["c_eff"])
                     if c <= 1.25 * floor), float("nan"))
        half = next((lam for lam, u in zip(row["lams"], row["util"])
                     if u >= 0.5), float("nan"))
        out.append({**row, "c_floor": floor, "knee_lambda": knee,
                    "half_cost_lambda": half})
    return out


def ensemble_bands(records: Sequence[RunRecord],
                   min_seeds: int = 3) -> List[dict]:
    """Monte-Carlo confidence bands from an ensemble store
    (`paper_ensemble`: every atlas group replicated at N=16 independent
    arrival seeds; `mini_ensemble`: the CI-smoke 4-seed version).

    Per (model, hw, quant) group whose lambdas carry >= `min_seeds`
    replicates: the central-95% percentile-bootstrap band of the
    geometric mean of C_eff, the underutilization penalty and the
    utilization at every offered rate — the error bars the paper's n=3
    caveat ("broader validation needed") asks for. The bootstrap rides
    `planner.curves.bootstrap_band` (deterministic, CRC-seeded), so the
    C_eff band here brackets exactly the knot the planner interpolates
    from the same store. Single-seed stores return [] and every classic
    table is unchanged."""
    from repro_torch.planner.curves import _band_rng, bootstrap_band
    import math
    out = []
    for key, group in _groups(records).items():
        by_lam: Dict[float, List[RunRecord]] = {}
        for r in group:
            by_lam.setdefault(r.lam, []).append(r)
        if max(len(v) for v in by_lam.values()) < min_seeds:
            continue
        metric_vals = {
            "c_eff": lambda r: r.c_eff,
            "penalty": lambda r: underutilization_penalty(r.tps,
                                                          r.theta_max),
            "util": lambda r: r.util,
        }
        lams = [lam for lam in sorted(by_lam)
                if len(by_lam[lam]) >= min_seeds]
        row = {
            "model": key[0], "hw": key[1], "quant": key[2],
            "n_chips": key[3], "io_shape": key[4],
            "n_seeds": max(len(by_lam[lam]) for lam in lams),
            "lams": lams,
            "n_per_lam": [len(by_lam[lam]) for lam in lams],
        }
        widest = 0.0
        for metric, value in metric_vals.items():
            rng = _band_rng(key, metric)
            mean, lo, hi = [], [], []
            for lam in lams:
                vals = [value(r) for r in by_lam[lam]]
                vals = [v for v in vals if math.isfinite(v) and v > 0]
                if len(vals) < min_seeds:
                    mean.append(float("nan"))
                    lo.append(float("nan"))
                    hi.append(float("nan"))
                    continue
                m, l, h = bootstrap_band(vals, rng)
                mean.append(m)
                lo.append(l)
                hi.append(h)
                if metric == "c_eff" and m > 0:
                    widest = max(widest, (h - l) / (2 * m))
            row[metric] = {"mean": mean, "lo": lo, "hi": hi}
        # the headline scalar: how tight the cost claim actually is —
        # the widest relative half-width of the C_eff band on the ladder
        row["max_rel_halfwidth_c_eff"] = widest
        out.append(row)
    return out


def reliability_tables(records: Sequence[RunRecord]) -> List[dict]:
    """The cost of reliability. One row per resilient record
    (mttf > 0 or retry_max > 0): goodput vs offered rate, the client
    retry-amplification factor, and — the headline — the inflation of
    C_eff per *delivered* token against the failure-free record at the
    same (model, hw, quant, footprint, io_shape, lambda). `tps` counts
    only completed requests' tokens, so C_eff is already per-delivered-
    token; failures/shedding shrink the denominator while the meter keeps
    running, which is exactly the inflation being priced."""
    base: Dict[Tuple, RunRecord] = {}
    for r in records:
        if r.mttf == 0.0 and r.retry_max == 0:
            base[(r.model, r.hw, r.quant, r.n_chips, r.io_shape, r.lam)] = r
    out = []
    for r in records:
        if r.mttf == 0.0 and r.retry_max == 0:
            continue
        b = base.get((r.model, r.hw, r.quant, r.n_chips, r.io_shape, r.lam))
        inflation = (r.c_eff / b.c_eff
                     if b is not None and b.c_eff > 0 else float("nan"))
        out.append({
            "model": r.model, "hw": r.hw, "quant": r.quant,
            "n_chips": r.n_chips, "io_shape": r.io_shape, "lam": r.lam,
            "mttf": r.mttf, "retry_max": r.retry_max,
            "offered_rps": r.lam, "goodput_rps": r.goodput_rps,
            "delivered_frac": (r.n_completed / r.n_requests
                               if r.n_requests else float("nan")),
            "retry_amplification": r.retry_amplification,
            "n_shed": r.n_shed, "n_timeout": r.n_timeout,
            "n_retried": r.n_retried, "n_abandoned": r.n_abandoned,
            "c_eff": r.c_eff,
            "c_eff_baseline": b.c_eff if b is not None else float("nan"),
            "c_eff_inflation": inflation,
        })
    # within a (coords, lam) block, rows ascend by failure *rate* (1/mttf,
    # with mttf=0 = rate 0 first) then retry budget — so the monotone-
    # inflation acceptance check reads straight down the table
    out.sort(key=lambda d: (d["model"], d["hw"], d["quant"], d["n_chips"],
                            d["io_shape"], d["lam"],
                            1.0 / d["mttf"] if d["mttf"] > 0 else 0.0,
                            d["retry_max"]))
    return out


def diurnal_tables(records: Sequence[RunRecord]) -> List[dict]:
    """The "cost of a day of traffic" table. Day-store records
    (config `day:<scenario>`) are stationary per-replica measurements at
    every rate the scenario's fleet trajectories visit;
    this recomputes the trajectories (pure, deterministic —
    `DayScenario.trajectories`) and prices the static footprint against
    every autoscaling policy from those measured points: per-window
    C_eff over the 24h profile, daily $ total and delivered tokens,
    the peak-hour penalty, and the static-vs-autoscaled verdict per
    deployment. The committed `paper_day` profile is built so the
    verdict FLIPS between its two deployments — autoscaling pays on the
    small-capacity footprint (trough savings span whole replicas) and
    costs on the big one (target-util headroom is pure premium when one
    replica already covers the peak)."""
    import math
    from repro_torch.planner.tables import _clean
    from repro_torch.serving.autoscale import DAY_SCENARIOS, price_day, \
        quantize_rate
    by_scenario: Dict[str, List[RunRecord]] = {}
    for r in records:
        if r.config.startswith("day:"):
            by_scenario.setdefault(r.config[4:], []).append(r)
    out = []
    for name in sorted(by_scenario):
        sc = DAY_SCENARIOS.get(name)
        if sc is None:
            continue                     # store from a retired scenario
        recs = by_scenario[name]
        for dep in sc.deployments:
            tps_by_lam = {
                quantize_rate(r.lam): r.tps for r in recs
                if (r.model, r.hw, r.quant, r.n_chips) ==
                   (dep.model, dep.hw, dep.quant, dep.n_chips)}
            if not tps_by_lam:
                continue
            missing = sorted(set(sc.rate_ladder(dep)) - set(tps_by_lam))
            policies = []
            for pname, traj in sc.trajectories(dep).items():
                try:
                    priced = price_day(traj, price_per_hr=dep.price_per_hr,
                                       tps_at=lambda l: tps_by_lam[l],
                                       lam_cap=dep.lam_cap)
                except KeyError:
                    continue             # ladder cell not yet run
                policies.append({"policy": pname, **priced})
            finite = [p for p in policies
                      if math.isfinite(p["day_c_eff"])]
            winner = min(finite, key=lambda p: p["day_c_eff"]) \
                if finite else None
            static = next((p for p in policies if p["policy"] == "static"),
                          None)
            saving = None
            if winner is not None and static is not None \
                    and static["day_c_eff"] > 0 \
                    and math.isfinite(static["day_c_eff"]):
                saving = 1.0 - winner["day_c_eff"] / static["day_c_eff"]
            out.append(_clean({
                "scenario": name, "deployment": dep.name,
                "model": dep.model, "hw": dep.hw, "quant": dep.quant,
                "n_chips": dep.n_chips, "price_per_hr": dep.price_per_hr,
                "lam_cap": dep.lam_cap, "window_s": sc.window_s,
                "n_windows": len(sc.window_rates),
                "peak_lam": sc.peak_lam,
                "static_replicas": sc.static_replicas(dep),
                "missing_rates": missing,
                "policies": policies,
                "winner": winner["policy"] if winner else None,
                "autoscaling_pays": bool(winner) and
                winner["policy"] != "static",
                "winner_saving_vs_static": saving,
            }))
    return out


def _overload_arm(r: RunRecord) -> dict:
    """Per-arm scalars for one flash-crowd record. `slo_met_frac` is the
    fraction of completed requests whose TTFT met the SLO;
    `slo_violation_minutes` spreads the violating fraction over the
    measurement window (a whole window out of SLO = window_s/60)."""
    from repro_torch.core.cost import c_eff as _ceff
    done = max(r.n_completed, 1)
    slo_met_frac = 1.0 - r.n_slo_viol / done
    total_tokens = r.tps * r.window_s
    return {
        "offered_rps": r.lam, "goodput_rps": r.goodput_rps,
        "delivered_frac": (r.n_completed / r.n_requests
                           if r.n_requests else float("nan")),
        "n_shed": r.n_shed, "n_class_shed": r.n_class_shed,
        "n_timeout": r.n_timeout,
        "shed_frac": ((r.n_shed + r.n_timeout) / r.n_requests
                      if r.n_requests else 0.0),
        "n_browned": r.n_browned,
        "browned_token_frac": (r.browned_tokens
                               / (r.browned_tokens + total_tokens)
                               if r.browned_tokens + total_tokens > 0
                               else 0.0),
        "n_slo_viol": r.n_slo_viol, "slo_met_frac": slo_met_frac,
        "slo_violation_minutes": (r.window_s / 60.0)
        * (r.n_slo_viol / done),
        "ttft_p90_ms": r.ttft_p90_ms,
        "tps": r.tps, "interactive_tps": r.interactive_tps,
        "c_eff": r.c_eff,
        "c_eff_interactive": _ceff(r.price_per_hr, r.interactive_tps),
        # the headline denominator: interactive tokens delivered AND
        # within the TTFT SLO (per-class SLO counts are not recorded, so
        # the completed-request SLO-met fraction prorates the stream)
        "c_eff_slo_interactive": _ceff(
            r.price_per_hr, r.interactive_tps * slo_met_frac),
    }


def overload_tables(records: Sequence[RunRecord]) -> List[dict]:
    """Priced graceful degradation under flash crowds. One row
    per (burst scenario, deployment) pair of a flash-crowd store (config
    `flash:<scenario>:<arm>`): the degradation-ON arm (armed
    OverloadPolicy: priority shedding + brownout) against the OFF arm
    (monitor-only policy — same queue cap, blind shedding, violations
    counted but nothing degraded) on the SAME arrival + class stream.

    The verdict metric is `c_eff_slo_interactive`: $/M interactive
    tokens delivered within the TTFT SLO. Degradation sheds background
    work and clamps token budgets, spending less of the window out of
    SLO — so it should beat blind shedding on cost per SLO-met
    interactive token even though it refuses more requests outright."""
    by_pair: Dict[Tuple, Dict[str, RunRecord]] = {}
    for r in records:
        if not r.config.startswith("flash:"):
            continue
        parts = r.config.split(":")
        scenario = parts[1] if len(parts) > 1 else ""
        arm = parts[2] if len(parts) > 2 else "on"
        key = (scenario, r.model, r.hw, r.quant, r.n_chips,
               r.io_shape, r.lam)
        by_pair.setdefault(key, {})[arm] = r
    out = []
    for key in sorted(by_pair, key=lambda k: (k[0], k[6])):
        arms = by_pair[key]
        row = {
            "scenario": key[0], "model": key[1], "hw": key[2],
            "quant": key[3], "n_chips": key[4], "io_shape": key[5],
            "lam": key[6],
            "arms": {arm: _overload_arm(r)
                     for arm, r in sorted(arms.items())},
        }
        on, off = row["arms"].get("on"), row["arms"].get("off")
        if on is not None and off is not None:
            row["degradation_wins"] = (on["c_eff_slo_interactive"]
                                       < off["c_eff_slo_interactive"])
            row["slo_minutes_saved"] = (off["slo_violation_minutes"]
                                        - on["slo_violation_minutes"])
            row["cost_ratio_off_over_on"] = (
                off["c_eff_slo_interactive"]
                / on["c_eff_slo_interactive"]
                if on["c_eff_slo_interactive"] > 0 else float("inf"))
        out.append(row)
    return out


def overload_verdict(rows: Sequence[dict]) -> dict:
    """Store-level headline over `overload_tables` rows: does graceful
    degradation beat blind shedding on cost per SLO-met interactive
    token on every burst cell? (The committed `paper_flashcrowd` grid is
    tuned so it does; the acceptance test asserts this.)"""
    pairs = [r for r in rows if "degradation_wins" in r]
    wins = sum(1 for r in pairs if r["degradation_wins"])
    return {
        "n_pairs": len(pairs),
        "wins": wins,
        "degradation_wins": bool(pairs) and wins == len(pairs),
        "total_slo_minutes_saved": sum(r["slo_minutes_saved"]
                                       for r in pairs),
    }


def render_overload(rows: Sequence[dict]) -> str:
    """Text rendering of `overload_tables` rows (report + planner)."""
    if not rows:
        return ""
    lines = ["-- surviving a flash crowd (degradation ON vs OFF, "
             "$/M SLO-met interactive tokens) --",
             f"{'scenario':<10} {'lam':>6} {'arm':<4} {'deliv':>6} "
             f"{'shed':>5} {'brown':>5} {'sloOK':>6} {'sloMin':>7} "
             f"{'$/M int-SLO':>11}"]
    for row in rows:
        for arm in ("on", "off"):
            a = row["arms"].get(arm)
            if a is None:
                continue
            ce = a["c_eff_slo_interactive"]
            lines.append(
                f"{row['scenario']:<10} {row['lam']:>6g} {arm:<4} "
                f"{a['delivered_frac']:>6.2f} {a['shed_frac']:>5.2f} "
                f"{a['browned_token_frac']:>5.2f} "
                f"{a['slo_met_frac']:>6.2f} "
                f"{a['slo_violation_minutes']:>7.2f} "
                + (f"{ce:>11.3f}" if ce != float("inf") else
                   f"{'inf':>11}"))
        if "degradation_wins" in row:
            tag = ("degradation pays" if row["degradation_wins"]
                   else "blind shedding cheaper")
            lines.append(f"  -> {tag} "
                         f"({row['cost_ratio_off_over_on']:.2f}x off/on, "
                         f"{row['slo_minutes_saved']:+.2f} SLO-min saved)")
    verdict = overload_verdict(rows)
    if verdict["n_pairs"]:
        lines.append(
            f"  => graceful degradation beats blind shedding on "
            f"{verdict['wins']}/{verdict['n_pairs']} burst cells")
    return "\n".join(lines)


def render_diurnal(rows: Sequence[dict]) -> str:
    """Text rendering of `diurnal_tables` rows (report + example)."""
    if not rows:
        return ""
    row0 = rows[0]
    lines = [
        f"-- cost of a day of traffic ({row0['scenario']}: "
        f"{row0['n_windows']} windows x {row0['window_s']:g} s, "
        f"peak {row0['peak_lam']:g} req/s) --"]
    for row in rows:
        lines.append(f"{row['deployment']} "
                     f"(static R={row['static_replicas']}, "
                     f"lam_cap {row['lam_cap']:g} req/s/replica):")
        lines.append(f"  {'policy':<10} {'repl-hrs':>8} {'daily $':>8} "
                     f"{'Mtok':>7} {'day C_eff':>9} {'peak pen':>8} "
                     f"{'idle':>4} {'sat':>3}")
        for p in row["policies"]:
            pen = f"{p['peak_penalty']:.2f}x" \
                if p["peak_penalty"] is not None else "n/a"
            dce = f"{p['day_c_eff']:.4f}" \
                if p["day_c_eff"] is not None else "inf"
            lines.append(
                f"  {p['policy']:<10} {p['replica_hours']:>8.2f} "
                f"{p['daily_cost_usd']:>8.3f} "
                f"{p['daily_tokens'] / 1e6:>7.2f} {dce:>9} "
                f"{pen:>8} {p['idle_windows']:>4d} "
                f"{p['saturated_windows']:>3d}")
        if row["winner"]:
            tag = f"cheapest day: {row['winner']}"
            if row["winner_saving_vs_static"]:
                tag += (f" ({100 * row['winner_saving_vs_static']:.0f}%"
                        f" below static)")
            if not row["autoscaling_pays"]:
                tag += "  [autoscaling does NOT pay here]"
            lines.append(f"  -> {tag}")
        if row["missing_rates"]:
            lines.append(f"  !! incomplete store: missing rates "
                         f"{row['missing_rates']}")
    return "\n".join(lines)


def crosshw_ordering(records: Sequence[RunRecord]) -> List[dict]:
    """§5.2 across the hardware axis: per quant, does the per-chip
    active-params saturation ordering survive on every generation?"""
    by_quant: Dict[str, List[dict]] = {}
    for row in active_params_ordering(records):
        by_quant.setdefault(row["quant"], []).append(row)
    out = []
    for quant, rows in sorted(by_quant.items()):
        if len(rows) < 2:
            continue
        out.append({
            "quant": quant,
            "hws": [r["hw"] for r in rows],
            "holds_on": [r["hw"] for r in rows
                         if r["ordered_by_active_params"]],
            "survives_all_hw": all(r["ordered_by_active_params"]
                                   for r in rows),
        })
    return out


def crosshw_tables(records: Sequence[RunRecord]) -> Dict[str, object]:
    """The cross-hardware artifacts as one JSON-ready payload. The
    penalty atlas joins when the store is dense enough (lambda-continuum
    plans); sparse-ladder stores carry an empty list there. The planner
    payload serializes the fitted per-hardware curves — the
    knots a penalty-curve figure needs — plus the recommended deployment
    at the paper's reference loads."""
    from repro_torch.planner.tables import planner_tables
    pairs = overload_tables(records)
    return {
        "spread_compression": spread_compression(records),
        "fp8_inversion": fp8_inversion(records),
        "active_params_ordering": crosshw_ordering(records),
        "penalty_atlas": penalty_atlas(records),
        "ensemble_bands": ensemble_bands(records),
        "planner_tables": planner_tables(records),
        "reliability": reliability_tables(records),
        "diurnal": diurnal_tables(records),
        "overload": {
            "pairs": pairs,
            "verdict": overload_verdict(pairs),
        },
    }


def write_tables(records: Sequence[RunRecord], path) -> None:
    """Persist `crosshw_tables` as JSON — the one serialization both CLIs
    (`run.py --analyze-json`, `analyze.py --json`) share, so the committed
    artifact can never drift between the two entry points."""
    with open(path, "w") as f:
        json.dump(crosshw_tables(records), f, indent=1, sort_keys=True)


def crossover_summary(records: Sequence[RunRecord]) -> List[dict]:
    """Per-group API crossover points (list prices, no SLA — §6.4 gate
    acknowledged explicitly here, as the examples always did)."""
    out = []
    for key, group in _groups(records).items():
        rows = crossover_table(group, accept_slo_mismatch=True)
        out.append({"model": key[0], "hw": key[1], "quant": key[2],
                    "tiers": rows})
    return out


def report(records: Sequence[RunRecord], title: str = "") -> str:
    """Human-readable consolidated report (what the CLI prints)."""
    lines = []
    if title:
        lines += [f"=== experiment report: {title} ===", ""]
    lines.append("-- load-driven C_eff spread (penalty = 1/U) --")
    lines.append(f"{'model':<24} {'hw':<9} {'quant':<5} {'theta_max':>9} "
                 f"{'idle pen':>9} {'spread':>7}")
    for row in penalty_curves(records):
        lines.append(
            f"{row['model']:<24} {row['hw']:<9} {row['quant']:<5} "
            f"{row['theta_max']:>9.0f} {row['idle_penalty']:>8.1f}x "
            f"{row['spread']:>6.1f}x")

    lines.append("")
    lines.append("-- active-params saturation ordering (§5.2, "
                 "per-chip theta_max) --")
    for row in active_params_ordering(records):
        order = " > ".join(f"{m['model']}({m['theta_max_per_chip']:.0f})"
                           for m in row["ranking"])
        ok = "matches" if row["ordered_by_active_params"] else "violates"
        lines.append(f"{row['hw']} {row['quant']}: {order}  "
                     f"[{ok} active-params order]")

    int8 = fp8_uplift(records, variant="int8")
    if int8:
        lines.append("")
        lines.append("-- INT8 uplift vs bf16 at saturation (native MXU "
                     "path on every part) --")
        lines.append(f"{'hw':<9} {'model':<24} {'TPS uplift':>10} "
                     f"{'cost ratio':>10}  note")
        for row in int8:
            note = "INVERTED (int8 slower)" if row["inverted"] else "gain"
            lines.append(f"{row['hw']:<9} {row['model']:<24} "
                         f"{row['tps_uplift']:>9.2f}x "
                         f"{row['cost_ratio']:>9.2f}x  {note}")

    uplift = fp8_inversion(records)
    if uplift:
        lines.append("")
        lines.append("-- FP8 uplift vs bf16 at saturation (per hardware, "
                     "conditioned on native fp8) --")
        lines.append(f"{'hw':<9} {'fp8':<8} {'model':<24} "
                     f"{'TPS uplift':>10} {'cost ratio':>10}  note")
        for row in uplift:
            note = "INVERTED (fp8 slower)" if row["inverted"] else "gain"
            if not row["consistent"]:
                note += "  !! inconsistent with native fp8"
            native = "native" if row["native_fp8"] else "emulated"
            lines.append(f"{row['hw']:<9} {native:<8} {row['model']:<24} "
                         f"{row['tps_uplift']:>9.2f}x "
                         f"{row['cost_ratio']:>9.2f}x  {note}")

    compression = spread_compression(records)
    if compression:
        lines.append("")
        lines.append("-- cross-hardware spread compression (§5.9/§7) --")
        lines.append(f"{'model':<24} {'quant':<5} "
                     f"{'per-hw spread (min..max C_eff)':<44} "
                     f"{'compression':>11}")
        for row in compression:
            per_hw = "  ".join(
                f"{h['hw']}:{h['spread']:.1f}x" for h in row["per_hw"])
            lines.append(f"{row['model']:<24} {row['quant']:<5} "
                         f"{per_hw:<44} {row['compression']:>10.2f}x "
                         f"(widest {row['widest_hw']})")
        for row in crosshw_ordering(records):
            tag = ("survives every hw" if row["survives_all_hw"] else
                   f"holds on {', '.join(row['holds_on']) or 'none'} "
                   f"of {', '.join(row['hws'])}")
            lines.append(f"active-params ordering [{row['quant']}]: {tag}")

    atlas = penalty_atlas(records)
    if atlas:
        lines.append("")
        lines.append("-- dense penalty atlas (lambda continuum, "
                     f"{len(atlas[0]['lams'])} points per curve) --")
        lines.append(f"{'model':<24} {'hw':<9} {'quant':<5} "
                     f"{'idle pen':>9} {'spread':>7} {'knee lam':>9} "
                     f"{'half-cost lam':>13}")
        for row in atlas:
            lines.append(
                f"{row['model']:<24} {row['hw']:<9} {row['quant']:<5} "
                f"{row['idle_penalty']:>8.1f}x {row['spread']:>6.1f}x "
                f"{row['knee_lambda']:>9.4g} {row['half_cost_lambda']:>13.4g}")

    bands = ensemble_bands(records)
    if bands:
        lines.append("")
        lines.append("-- Monte-Carlo confidence bands (central 95%, "
                     f"N={bands[0]['n_seeds']} arrival seeds) --")
        lines.append(f"{'model':<24} {'hw':<9} {'quant':<5} "
                     f"{'idle c_eff [lo..hi]':>24} "
                     f"{'sat c_eff [lo..hi]':>24} {'max hw':>7}")
        for row in bands:
            ce = row["c_eff"]
            idle = f"{ce['mean'][0]:.3f} [{ce['lo'][0]:.3f}.." \
                   f"{ce['hi'][0]:.3f}]"
            sat = f"{ce['mean'][-1]:.3f} [{ce['lo'][-1]:.3f}.." \
                  f"{ce['hi'][-1]:.3f}]"
            lines.append(
                f"{row['model']:<24} {row['hw']:<9} {row['quant']:<5} "
                f"{idle:>24} {sat:>24} "
                f"{100 * row['max_rel_halfwidth_c_eff']:>6.1f}%")

    reliability = reliability_tables(records)
    if reliability:
        lines.append("")
        lines.append("-- pricing reliability (C_eff per *delivered* "
                     "token vs failure-free baseline) --")
        lines.append(f"{'model':<24} {'lam':>6} {'mttf':>6} {'retry':>5} "
                     f"{'goodput':>8} {'ampl':>6} {'shed':>5} "
                     f"{'c_eff':>8} {'inflation':>9}")
        for row in reliability:
            mttf = f"{row['mttf']:g}" if row["mttf"] > 0 else "-"
            lines.append(
                f"{row['model']:<24} {row['lam']:>6g} {mttf:>6} "
                f"{row['retry_max']:>5d} {row['goodput_rps']:>8.2f} "
                f"{row['retry_amplification']:>5.2f}x {row['n_shed']:>5d} "
                f"{row['c_eff']:>8.3f} {row['c_eff_inflation']:>8.2f}x")

    diurnal = diurnal_tables(records)
    if diurnal:
        lines.append("")
        lines.extend(render_diurnal(diurnal).splitlines())

    overload = overload_tables(records)
    if overload:
        lines.append("")
        lines.extend(render_overload(overload).splitlines())

    from repro_torch.planner.curves import fit_curves
    from repro_torch.planner.portfolio import BLENDED_3CLASS, plan_portfolio
    from repro_torch.planner.tables import (PORTFOLIO_LAMS, certification_rows,
                                      render_certification,
                                      render_portfolio)
    curves = fit_curves(records)
    if curves:
        lines.append("")
        lines.extend(
            render_certification(certification_rows(curves)).splitlines())
        for lam in PORTFOLIO_LAMS:
            lines.append("")
            lines.extend(render_portfolio(plan_portfolio(
                curves, BLENDED_3CLASS.scaled(lam))).splitlines())

    lines.append("")
    lines.append("-- API crossover (list prices, no SLA: §6.4 gate "
                 "acknowledged) --")
    for row in crossover_summary(records):
        for tier in row["tiers"]:
            lam = tier["lambda_star"]
            tag = ("always cheaper" if tier["self_host_always_cheaper"]
                   else f"lam*={lam:.2f}")
            lines.append(f"{row['model']:<24} {row['quant']:<5} vs "
                         f"{tier['tier']:<18} {tag}")
    return "\n".join(lines)


def load_store_records(plan_name: str, root: Optional[str] = None
                       ) -> List[RunRecord]:
    from repro_torch.experiments.plans import get_plan
    from repro_torch.experiments.store import ExperimentStore
    plan = get_plan(plan_name)
    return ExperimentStore(plan.name, root).load_records(plan)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--plan", required=True)
    ap.add_argument("--root", default=None,
                    help="store root (default results/experiments)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the cross-hardware tables "
                         "(spread compression, fp8 inversion, ordering "
                         "survival) as JSON")
    args = ap.parse_args(argv)
    records = load_store_records(args.plan, args.root)
    if not records:
        raise SystemExit(f"no completed cells in store for {args.plan!r}; "
                         f"run: python -m repro_torch.experiments.run "
                         f"--plan {args.plan}")
    print(report(records, title=args.plan))
    if args.json:
        write_tables(records, args.json)
        print(f"\ncross-hardware tables written to {args.json}")


if __name__ == "__main__":
    main()
