"""Autoscaling policies + "cost of a day of traffic" pricing.

The paper prices C_eff at a fixed lambda; a real operator faces a 24h
lambda(t) profile and chooses between a *static* footprint sized for the
peak and an *autoscaled* fleet that tracks demand with lag, warmup cost
and scale-down hysteresis. This module simulates that choice on top of
the measured single-replica cost curves:

* `AutoscalePolicy` — target-utilization controller: desired replicas =
  ceil(lam / (target_util * lam_cap)), scale-up billed after
  `scale_up_lag_s` and serving after a further `warmup_s` (warming
  replicas burn money without delivering tokens), scale-down only after
  `scale_down_hold_s` of consecutive below-target demand (hysteresis),
  with an over-provision floor (`min_replicas`).
* `simulate_policy` — window-granular fleet trajectory over a
  piecewise-constant day profile; `static_windows` is the fixed-fleet
  baseline sized by `static_size` (peak over util_sla).
* `price_day` — prices a trajectory with per-replica throughput looked
  up from MEASURED cells: each (window, policy) pair resolves to a
  per-replica offered rate lam/serving, and the day store measures
  exactly those stationary points (the windows of a piecewise profile
  are stationary segments, so the committed `paper_diurnal` cells are
  policy-agnostic single-replica measurements; see
  `plans.paper_diurnal`). Stationary-window approximation: a window
  whose per-replica rate exceeds the deployment's demonstrated capacity
  delivers at most saturation throughput — the excess queues, it is not
  silently served.

`DayScenario` freezes one committed 24h profile + deployments +
policies; the scenario's `rate_ladder` is the single source of truth for
which per-replica rates the day plan must measure, shared by
`experiments.plans` (cell expansion) and `experiments.analyze` (report),
so the ladder and the report can't drift apart.

Deployment capacity literals (`lam_cap`, price) are frozen from the
committed stores' own measurements (theta_max / 256 output tokens per
chat request) — the autoscaler sizes fleets from demonstrated
throughput, never from specs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.arrivals import RateProfile


def quantize_rate(lam: float) -> float:
    """Per-replica window rates become cell lambdas, and `int(lam*1000)`
    feeds the per-cell seed derivation — quantize to 3 decimals so the
    ladder is exactly representable and seed-stable."""
    return round(float(lam), 3)


# ---------------------------------------------------------------------------
# policies + fleet trajectories
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Target-utilization scale-up with lag/warmup, hysteretic scale-down."""
    name: str
    target_util: float = 0.7        # fraction of lam_cap a replica may carry
    scale_up_lag_s: float = 0.0     # order placed -> replica billed
    warmup_s: float = 0.0           # billed -> actually serving
    scale_down_hold_s: float = 0.0  # consecutive low-demand time before down
    min_replicas: int = 1           # over-provision floor
    max_replicas: int = 64

    def desired(self, lam: float, lam_cap: float) -> int:
        """Replicas wanted for offered rate `lam` at per-replica capacity
        `lam_cap`, keeping each replica at <= target_util of capacity."""
        if lam <= 0:
            return self.min_replicas
        want = math.ceil(lam / (self.target_util * lam_cap))
        return max(self.min_replicas, min(self.max_replicas, want))


@dataclasses.dataclass(frozen=True)
class FleetWindow:
    """One window of a fleet trajectory: `serving` replicas take traffic,
    `billed` >= `serving` also counts replicas still warming up."""
    index: int
    t0: float
    t1: float
    lam: float          # fleet-wide offered rate over the window (req/s)
    serving: int
    billed: int


def static_size(peak_lam: float, lam_cap: float,
                util_sla: float = 0.95) -> int:
    """Fixed fleet sized for the peak: smallest R with
    peak_lam <= util_sla * R * lam_cap."""
    if lam_cap <= 0:
        raise ValueError(f"lam_cap must be > 0, got {lam_cap}")
    return max(1, math.ceil(peak_lam / (util_sla * lam_cap)))


def static_windows(replicas: int, rates: Sequence[float],
                   window_s: float) -> Tuple[FleetWindow, ...]:
    return tuple(
        FleetWindow(index=w, t0=w * window_s, t1=(w + 1) * window_s,
                    lam=float(r), serving=replicas, billed=replicas)
        for w, r in enumerate(rates))


def simulate_policy(policy: AutoscalePolicy, rates: Sequence[float],
                    window_s: float, lam_cap: float
                    ) -> Tuple[FleetWindow, ...]:
    """Run the controller over a piecewise-constant day, one decision per
    window boundary, observing the PREVIOUS window's rate (reactive — the
    controller has no oracle). Window 0 opens pre-provisioned at the
    first window's desired size. Scale-ups bill after `scale_up_lag_s`
    and serve after a further `warmup_s` (both in whole windows, rounded
    up); scale-downs need `scale_down_hold_s` of consecutive
    below-target demand, then release immediately — cancelling not-yet-
    warm orders first (newest first), live replicas last."""
    if window_s <= 0:
        raise ValueError(f"window_s must be > 0, got {window_s}")
    lag_w = math.ceil(policy.scale_up_lag_s / window_s)
    warm_w = math.ceil(policy.warmup_s / window_s)
    hold_w = max(1, math.ceil(policy.scale_down_hold_s / window_s))
    live = policy.desired(rates[0], lam_cap)
    orders: List[Dict[str, int]] = []   # {"bill_at", "serve_at", "n"}
    below = 0
    out: List[FleetWindow] = []
    for w, lam in enumerate(rates):
        if w > 0:
            want = policy.desired(rates[w - 1], lam_cap)
            committed = live + sum(o["n"] for o in orders)
            if want > committed:
                orders.append({"bill_at": w + lag_w,
                               "serve_at": w + lag_w + warm_w,
                               "n": want - committed})
                below = 0
            elif want < committed:
                below += 1
                if below >= hold_w:
                    shed = committed - want
                    while shed and orders:
                        take = min(shed, orders[-1]["n"])
                        orders[-1]["n"] -= take
                        shed -= take
                        if orders[-1]["n"] == 0:
                            orders.pop()
                    live -= shed
                    below = 0
            else:
                below = 0
        for o in list(orders):
            if o["serve_at"] <= w:
                live += o["n"]
                orders.remove(o)
        warming = sum(o["n"] for o in orders if o["bill_at"] <= w)
        out.append(FleetWindow(index=w, t0=w * window_s,
                               t1=(w + 1) * window_s, lam=float(lam),
                               serving=live, billed=live + warming))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SLOAutoscalePolicy:
    """SLO-aware controller: scale on the observed
    TTFT p90 instead of utilization.

    The target-util controller needs a capacity model (`lam_cap`) and a
    utilization target; this one needs neither — it watches the latency
    percentile the SLO is written against. Each window boundary it looks
    up the PREVIOUS window's realized per-replica rate in the measured
    TTFT-p90 curve (`ttft_p90_at`, a day-store record or a fitted
    DeploymentCurve): one breach orders `step_up` replicas (lag/warmup
    semantics identical to `AutoscalePolicy`); p90 below
    `headroom_frac * slo` for `scale_down_hold_s` releases one replica.
    Window 0 opens at `min_replicas` — an SLO controller has no rate
    model to pre-size from, which is exactly its difference from the
    util controller, so the cold start is part of the comparison."""
    name: str
    ttft_p90_slo_ms: float
    headroom_frac: float = 0.5      # scale-down band: p90 < frac * slo
    step_up: int = 1                # replicas ordered per breach window
    scale_up_lag_s: float = 0.0
    warmup_s: float = 0.0
    scale_down_hold_s: float = 0.0
    min_replicas: int = 1
    max_replicas: int = 64


def simulate_slo_policy(policy: SLOAutoscalePolicy,
                        rates: Sequence[float], window_s: float,
                        ttft_p90_at) -> Tuple[FleetWindow, ...]:
    """Run the SLO-aware controller over a piecewise-constant day.
    `ttft_p90_at(lam_per_replica)` returns the measured (or fitted)
    single-replica TTFT p90 in ms at that stationary offered rate.
    Same window-granular mechanics as `simulate_policy`: decisions at
    window boundaries on the previous window's observation, scale-ups
    billed after `scale_up_lag_s` and serving after a further
    `warmup_s`, hysteretic scale-down cancelling newest orders first."""
    if window_s <= 0:
        raise ValueError(f"window_s must be > 0, got {window_s}")
    lag_w = math.ceil(policy.scale_up_lag_s / window_s)
    warm_w = math.ceil(policy.warmup_s / window_s)
    hold_w = max(1, math.ceil(policy.scale_down_hold_s / window_s))
    live = policy.min_replicas
    orders: List[Dict[str, int]] = []
    below = 0
    out: List[FleetWindow] = []
    for w, lam in enumerate(rates):
        if w > 0:
            prev = out[-1]
            p90 = (float(ttft_p90_at(quantize_rate(prev.lam
                                                   / prev.serving)))
                   if prev.lam > 0 and prev.serving > 0 else 0.0)
            committed = live + sum(o["n"] for o in orders)
            if p90 > policy.ttft_p90_slo_ms:
                room = policy.max_replicas - committed
                if room > 0:
                    orders.append({"bill_at": w + lag_w,
                                   "serve_at": w + lag_w + warm_w,
                                   "n": min(policy.step_up, room)})
                below = 0
            elif (p90 < policy.headroom_frac * policy.ttft_p90_slo_ms
                  and committed > policy.min_replicas):
                below += 1
                if below >= hold_w:
                    if orders:
                        orders[-1]["n"] -= 1
                        if orders[-1]["n"] == 0:
                            orders.pop()
                    else:
                        live -= 1
                    below = 0
            else:
                below = 0
        for o in list(orders):
            if o["serve_at"] <= w:
                live += o["n"]
                orders.remove(o)
        warming = sum(o["n"] for o in orders if o["bill_at"] <= w)
        out.append(FleetWindow(index=w, t0=w * window_s,
                               t1=(w + 1) * window_s, lam=float(lam),
                               serving=live, billed=live + warming))
    return tuple(out)


def slo_violation_minutes(windows: Sequence[FleetWindow], ttft_p90_at,
                          slo_ms: float) -> float:
    """Minutes of the day a trajectory spends with the realized
    per-replica rate's TTFT p90 over the SLO (idle windows comply)."""
    total = 0.0
    for fw in windows:
        if fw.lam <= 0 or fw.serving <= 0:
            continue
        p90 = float(ttft_p90_at(quantize_rate(fw.lam / fw.serving)))
        if p90 > slo_ms:
            total += (fw.t1 - fw.t0) / 60.0
    return total


def compare_day_policies(*, util_policy: AutoscalePolicy,
                         slo_policy: SLOAutoscalePolicy,
                         rates: Sequence[float], window_s: float,
                         lam_cap: float, price_per_hr: float,
                         tps_at, ttft_p90_at) -> Dict:
    """Head-to-head: the target-util
    controller vs the SLO-aware controller on the same day, priced from
    the same measured curves. Reports each policy's day cost AND its
    SLO-violation minutes — the comparison is two-dimensional: the util
    controller can be cheaper while blowing the latency budget, which
    is precisely what scaling on the wrong signal looks like."""
    slo_ms = slo_policy.ttft_p90_slo_ms
    traj_u = simulate_policy(util_policy, rates, window_s, lam_cap)
    traj_s = simulate_slo_policy(slo_policy, rates, window_s, ttft_p90_at)
    rows = {}
    for name, traj in ((util_policy.name, traj_u),
                       (slo_policy.name, traj_s)):
        priced = price_day(traj, price_per_hr=price_per_hr,
                           tps_at=tps_at, lam_cap=lam_cap)
        rows[name] = {
            "policy": name,
            "slo_violation_minutes": slo_violation_minutes(
                traj, ttft_p90_at, slo_ms), **priced}
    u, s = rows[util_policy.name], rows[slo_policy.name]
    return {
        "util": u, "slo": s, "ttft_p90_slo_ms": slo_ms,
        "cheaper": (util_policy.name
                    if u["day_c_eff"] <= s["day_c_eff"]
                    else slo_policy.name),
        "tighter_slo": (slo_policy.name
                        if s["slo_violation_minutes"]
                        <= u["slo_violation_minutes"]
                        else util_policy.name),
        "slo_minutes_saved": (u["slo_violation_minutes"]
                              - s["slo_violation_minutes"]),
    }


# ---------------------------------------------------------------------------
# pricing a trajectory against measured per-replica throughput
# ---------------------------------------------------------------------------

def price_day(windows: Sequence[FleetWindow], *, price_per_hr: float,
              tps_at, lam_cap: float = 0.0,
              mtok_per_req: float = 256e-6) -> Dict:
    """Price one fleet trajectory. `tps_at(lam_per_replica)` returns the
    measured single-replica output-token throughput at that stationary
    offered rate (day-store record, or a fitted DeploymentCurve);
    `price_per_hr` is per replica.

    Per window: cost = billed replicas x price x dt; delivered tokens =
    serving x tps_at(quantized lam/serving) x dt; window C_eff =
    cost * 1e6 / tokens, inf on an idle window (billed, zero goodput —
    flagged, never hidden). Day totals aggregate cost and tokens, so
    `day_c_eff` is the operator's actual $/M-token for the day."""
    rows: List[Dict] = []
    total_cost = total_tok = 0.0
    for fw in windows:
        dt = fw.t1 - fw.t0
        cost = fw.billed * price_per_hr * dt / 3600.0
        if fw.lam > 0 and fw.serving > 0:
            lam_per = quantize_rate(fw.lam / fw.serving)
            tps = float(tps_at(lam_per))
            if not math.isfinite(tps) or tps < 0:
                raise ValueError(
                    f"tps_at({lam_per}) = {tps}: the day ladder must "
                    f"measure every per-replica rate the trajectories "
                    f"visit")
            tokens = fw.serving * tps * dt
        else:
            lam_per, tokens = 0.0, 0.0
        wc = cost * 1e6 / tokens if tokens > 0 else math.inf
        saturated = bool(lam_cap > 0 and lam_per > lam_cap)
        rows.append({
            "window": fw.index, "t0": fw.t0, "t1": fw.t1, "lam": fw.lam,
            "serving": fw.serving, "billed": fw.billed,
            "lam_per_replica": lam_per, "cost_usd": cost,
            "tokens": tokens, "c_eff": wc,
            "idle": tokens <= 0, "saturated": saturated,
        })
        total_cost += cost
        total_tok += tokens
    busy = [r["c_eff"] for r in rows if math.isfinite(r["c_eff"])]
    peak_row = max(rows, key=lambda r: r["lam"])
    best = min(busy) if busy else math.inf
    day_c = total_cost * 1e6 / total_tok if total_tok > 0 else math.inf
    return {
        "windows": rows,
        "daily_cost_usd": total_cost,
        "daily_tokens": total_tok,
        "day_c_eff": day_c,
        "replica_hours": sum(r["billed"] * (r["t1"] - r["t0"])
                             for r in rows) / 3600.0,
        "best_window_c_eff": best,
        "worst_busy_window_c_eff": max(busy) if busy else math.inf,
        "peak_window_c_eff": peak_row["c_eff"],
        # the paper-style penalty, time-resolved: what the peak-rate hour
        # costs per token relative to the day's best hour
        "peak_penalty": (peak_row["c_eff"] / best
                         if busy and math.isfinite(peak_row["c_eff"])
                         else None),
        "idle_windows": sum(1 for r in rows if r["idle"]),
        "saturated_windows": sum(1 for r in rows if r["saturated"]),
    }


# ---------------------------------------------------------------------------
# committed day scenarios
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Deployment:
    """One priced footprint. `lam_cap` and `price_per_hr` are frozen from
    the committed stores (theta_max / 256 tok-per-chat-request)."""
    name: str
    model: str
    hw: str
    quant: str
    n_chips: int
    price_per_hr: float
    lam_cap: float


@dataclasses.dataclass(frozen=True)
class DayScenario:
    """A committed 24h profile x deployments x policies bundle — the one
    definition `plans` expands cells from and `analyze` reports against."""
    name: str
    window_s: float
    window_rates: Tuple[float, ...]
    deployments: Tuple[Deployment, ...]
    policies: Tuple[AutoscalePolicy, ...]
    util_sla: float = 0.95

    @property
    def peak_lam(self) -> float:
        return max(self.window_rates)

    @property
    def day_s(self) -> float:
        return self.window_s * len(self.window_rates)

    def profile(self) -> RateProfile:
        """The scenario's lambda(t) as a piecewise RateProfile (for
        engine-facing streams: the meter walkthrough, smoke cells)."""
        return RateProfile.piecewise(
            [(self.window_s, r) for r in self.window_rates])

    def static_replicas(self, dep: Deployment) -> int:
        return static_size(self.peak_lam, dep.lam_cap, self.util_sla)

    def trajectories(self, dep: Deployment
                     ) -> Dict[str, Tuple[FleetWindow, ...]]:
        """'static' + one trajectory per policy, in declaration order."""
        out = {"static": static_windows(self.static_replicas(dep),
                                        self.window_rates, self.window_s)}
        for pol in self.policies:
            out[pol.name] = simulate_policy(pol, self.window_rates,
                                            self.window_s, dep.lam_cap)
        return out

    def rate_ladder(self, dep: Deployment) -> Tuple[float, ...]:
        """Every distinct quantized per-replica rate any trajectory
        visits — exactly the stationary points the day store must
        measure for this deployment."""
        rates = set()
        for traj in self.trajectories(dep).values():
            for fw in traj:
                if fw.lam > 0 and fw.serving > 0:
                    rates.add(quantize_rate(fw.lam / fw.serving))
        return tuple(sorted(rates))


# The committed 24h profile: a scaled day (1 window = 1 "hour" = 180 s of
# model clock), diurnal double-shoulder shape with a dead-of-night zero
# window (w4) — the idle regime that exposed the meter/arrivals bug
# class. Peak 34 req/s is chosen against the two deployments' measured
# capacities so the static-vs-autoscaled verdict FLIPS between them:
# the small-capacity footprint (llama31-8b @ v5e x2, ~11.8 req/s per
# replica) needs 4 static replicas and autoscaling harvests the trough;
# the big-capacity footprint (qwen3-30b-a3b @ v5e x8, ~36 req/s) covers
# the whole day with 1 static replica, so any autoscaler headroom is
# pure premium.
PAPER_DAY = DayScenario(
    name="paper_day",
    window_s=180.0,
    window_rates=(5.0, 3.0, 2.0, 1.0, 0.0, 1.0, 3.0, 7.0, 14.0, 22.0,
                  28.0, 32.0, 34.0, 33.0, 30.0, 26.0, 22.0, 20.0, 22.0,
                  25.0, 20.0, 14.0, 10.0, 7.0),
    deployments=(
        # theta_max 3009.1 tok/s -> 11.754 req/s; $1.20/chip-hr x2
        Deployment(name="llama31-8b@tpu-v5e x2", model="llama31-8b",
                   hw="tpu-v5e", quant="bf16", n_chips=2,
                   price_per_hr=2.4, lam_cap=11.754),
        # theta_max 9208.0 tok/s -> 35.969 req/s; $1.20/chip-hr x8
        Deployment(name="qwen3-30b-a3b@tpu-v5e x8", model="qwen3-30b-a3b",
                   hw="tpu-v5e", quant="bf16", n_chips=8,
                   price_per_hr=9.6, lam_cap=35.969),
    ),
    policies=(
        AutoscalePolicy(name="reactive", target_util=0.65,
                        scale_up_lag_s=180.0, warmup_s=180.0,
                        scale_down_hold_s=360.0, min_replicas=1,
                        max_replicas=8),
        AutoscalePolicy(name="cautious", target_util=0.5,
                        scale_up_lag_s=180.0, warmup_s=360.0,
                        scale_down_hold_s=1080.0, min_replicas=2,
                        max_replicas=8),
    ),
)

# CI-smoke day: 6 windows x 30 s with a zero window, one small footprint,
# one snappy policy — cheap enough to expand + run + analyze in CI.
MINI_DAY = DayScenario(
    name="mini_day",
    window_s=30.0,
    window_rates=(2.0, 5.0, 0.0, 8.0, 4.0, 1.0),
    deployments=(
        Deployment(name="llama31-8b@tpu-v5e x1", model="llama31-8b",
                   hw="tpu-v5e", quant="bf16", n_chips=1,
                   price_per_hr=1.2, lam_cap=6.0),
    ),
    policies=(
        AutoscalePolicy(name="reactive", target_util=0.6,
                        scale_up_lag_s=30.0, warmup_s=30.0,
                        scale_down_hold_s=60.0, min_replicas=1,
                        max_replicas=4),
    ),
)

DAY_SCENARIOS: Dict[str, DayScenario] = {
    "paper_day": PAPER_DAY,
    "mini_day": MINI_DAY,
}


# ---------------------------------------------------------------------------
# live-meter walkthrough (engine-facing lambda(t))
# ---------------------------------------------------------------------------

def meter_day_report(eng, *, price_per_hr: float, profile: RateProfile,
                     n_requests: int, seed: int = 0, window_s: float = 60.0,
                     io_shape: str = "chat", scale: float = 1.0,
                     max_horizon_s: float = 48 * 3600.0) -> Dict:
    """Drive ONE engine through a lambda(t) stream while the CostMeter
    ticks each half-window — the live counterpart of `price_day`. Idle
    troughs produce real zero-token meter windows, exercising the
    idle-window semantics end to end (CI smoke + example)."""
    from repro_torch.core.meter import CostMeter
    from repro_torch.serving.arrivals import ArrivalSpec, synth_requests

    spec = ArrivalSpec(lam=quantize_rate(max(profile.mean_rate(), 0.001)),
                       n_requests=n_requests, io_shape=io_shape, seed=seed,
                       scale=scale, profile=profile)
    reqs = synth_requests(spec)
    meter = CostMeter(price_per_hr, scrape=lambda: eng.metrics.render(),
                      minute_s=window_s)
    meter.tick()
    horizon = 0.0
    while any(r.finish_time is None for r in reqs):
        horizon += window_s / 2.0
        eng.run(reqs, horizon=horizon)
        meter.tick()
        if horizon > max_horizon_s:
            break
    summ = meter.summary()
    return {
        "summary": summ,
        "window_costs": meter.minute_costs(),
        "completed": sum(1 for r in reqs if r.finish_time is not None),
        "requests": len(reqs),
    }
