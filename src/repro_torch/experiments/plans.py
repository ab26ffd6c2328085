"""First-class experiment plans: the paper's benchmark matrices.

The paper's headline matrices are 42 H100 cells and 56 A100 cells over
(model, quant, lambda) — 6 resp. 8 (model, quant) combinations times the
7-point lambda ladder. Per DESIGN §3 the hardware axis maps onto TPU
generations: H100 NVL -> tpu-v5p (fast, pricey, 95 GB), A100 PCIe ->
tpu-v5e (slow, cheap, 16 GB). Both parts emulate fp8 (no native fp8
MXU path), reproducing the paper's hardware-conditional quantization
caveat: the HBM win survives, the compute path pays a dequant penalty, so
compute-bound dense models can invert while memory-bound MoEs still gain.

`paper_crosshw` replicates the paper's §5.9/§7 cross-hardware
argument in one plan: the same trio across v5e + v5p + the native-fp8
v6e, with per-(arch, hw) TP degrees, so the spread-compression and
FP8-inversion tables derive from a single store.

TP degrees are chosen so bf16 weights fit the part's HBM (the sim tier
does not enforce fit, but cross-cell $/token comparisons are only
meaningful for deployable footprints); price_per_hr scales with chips.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.core.pricing import chip_hour_price
from repro_torch.core.sweep import LAMBDA_LADDER
from repro_torch.experiments.plan import Cell, ExperimentPlan, GridSpec, cell_seed
from repro_torch.serving.autoscale import DAY_SCENARIOS, DayScenario

# paper benchmark trio: dense 8B / ultra-sparse 30B-A3B MoE / 47B-A13B MoE
PAPER_TRIO = ("llama31-8b", "qwen3-30b-a3b", "mixtral-8x7b")

# the cross-hardware TP footprints (bf16 weights fit each part's HBM),
# shared by paper_crosshw / paper_atlas / probe_int8_nonnative
CROSSHW_CHIPS = (
    ("llama31-8b", "tpu-v5e", 2),
    ("qwen3-30b-a3b", "tpu-v5e", 8),
    ("mixtral-8x7b", "tpu-v5e", 8),
    ("llama31-8b", "tpu-v5p", 1),
    ("qwen3-30b-a3b", "tpu-v5p", 1),
    ("mixtral-8x7b", "tpu-v5p", 2),
    ("llama31-8b", "tpu-v6e", 1),
    ("qwen3-30b-a3b", "tpu-v6e", 2),
    ("mixtral-8x7b", "tpu-v6e", 4),
)

# 25-point log-spaced lambda continuum, 1..200 req/s (the 7-point paper
# ladder's idle->saturation span, densified so the penalty curve is a
# curve instead of seven samples). Frozen literal: ladder values feed the
# per-cell seed derivation (int(lam*1000)), so they must never drift
# with numpy versions.
ATLAS_LADDER = (
    1.0, 1.25, 1.56, 1.94, 2.42, 3.02, 3.76, 4.69, 5.85, 7.29, 9.09,
    11.34, 14.14, 17.64, 21.99, 27.42, 34.2, 42.65, 53.18, 66.32, 82.7,
    103.13, 128.61, 160.38, 200.0,
)


def paper_h100() -> ExperimentPlan:
    """42 cells: 3 models x 2 quants x 7-lambda ladder on tpu-v5p."""
    return GridSpec(
        name="paper_h100",
        description="H100-analogue matrix (paper §5): 3 models x "
                    "{bf16, fp8} x 7-point ladder on tpu-v5p",
        archs=PAPER_TRIO,
        hws=("tpu-v5p",),
        quants=("bf16", "fp8"),
        ladder=LAMBDA_LADDER,
        n_chips_by_arch=(("llama31-8b", 1), ("qwen3-30b-a3b", 1),
                         ("mixtral-8x7b", 2)),
        seed=0,
        protocol="paper",
    ).expand()


def paper_a100() -> ExperimentPlan:
    """56 cells: 4 models x 2 quants x 7-lambda ladder on tpu-v5e.

    The extra dense mid-size model (phi3-medium-14b) widens the
    active-params ordering probe on the cheaper part, giving the 8-combo
    A100-analogue matrix of the paper."""
    return GridSpec(
        name="paper_a100",
        description="A100-analogue matrix (paper §5): 4 models x "
                    "{bf16, fp8} x 7-point ladder on tpu-v5e",
        archs=PAPER_TRIO + ("phi3-medium-14b",),
        hws=("tpu-v5e",),
        quants=("bf16", "fp8"),
        ladder=LAMBDA_LADDER,
        n_chips_by_arch=(("llama31-8b", 2), ("phi3-medium-14b", 4),
                         ("qwen3-30b-a3b", 8), ("mixtral-8x7b", 8)),
        seed=0,
        protocol="paper",
    ).expand()


def paper_crosshw() -> ExperimentPlan:
    """126 cells: 3 models x 3 hardware generations x {bf16, fp8} x
    7-lambda ladder — the paper's §5.9/§7 cross-hardware replication as
    ONE plan over ONE store.

    TP degrees fit bf16 weights to each part's HBM (v5p 95 GB, v6e 32 GB,
    v5e 16 GB), so the cross-hardware $/token comparison stays deployable.
    v6e is the native-fp8 entry: the fp8 uplift must NOT invert there,
    while the fp8-emulating v5e/v5p parts reproduce the paper's dense
    inversion — `analyze.fp8_inversion` conditions on exactly this."""
    return GridSpec(
        name="paper_crosshw",
        description="cross-hardware matrix (paper §5.9/§7): 3 models x "
                    "{tpu-v5e, tpu-v5p, tpu-v6e} x {bf16, fp8} x "
                    "7-point ladder, per-hardware TP",
        archs=PAPER_TRIO,
        hws=("tpu-v5e", "tpu-v5p", "tpu-v6e"),
        quants=("bf16", "fp8"),
        ladder=LAMBDA_LADDER,
        n_chips_by_arch_hw=CROSSHW_CHIPS,
        seed=0,
        protocol="paper",
    ).expand()


def paper_atlas() -> ExperimentPlan:
    """450 cells: 3 models x 3 hardware generations x {bf16, fp8} x the
    25-point log-spaced lambda *continuum* — the dense "penalty atlas".

    The paper's core claim is a curve (C_eff spans 2.5-36x driven by
    lambda), but the 7-point ladder only samples it; related work prices
    over ever-larger scenario products (Melange's hw x model x load
    search, WiNGPT's swept economics), so the atlas densifies the load
    axis 3.6x at the same per-cell protocol. Feasible as one command
    because the fleet backend makes a 450-cell plan cost a few dozen
    cell-equivalents of wall time:

        python -m repro_torch.experiments.run --plan paper_atlas \\
            --backend vector --resume --analyze

    `analyze.penalty_atlas` consumes the store: per (model, hw, quant)
    the dense lambda -> penalty curve, its knee (first lambda within 25%
    of the cost floor) and the idle/saturation spread that the
    spread-compression table only samples at 7 points."""
    return GridSpec(
        name="paper_atlas",
        description="dense penalty atlas: 3 models x {v5e, v5p, v6e} x "
                    "{bf16, fp8} x 25-point log-spaced lambda continuum",
        archs=PAPER_TRIO,
        hws=("tpu-v5e", "tpu-v5p", "tpu-v6e"),
        quants=("bf16", "fp8"),
        ladder=ATLAS_LADDER,
        n_chips_by_arch_hw=CROSSHW_CHIPS,
        seed=0,
        protocol="paper",
    ).expand()


def paper_ensemble() -> ExperimentPlan:
    """2016 cells: every `paper_atlas` (model, hw, quant) group x the
    7-point paper ladder x 16 independent arrival seeds — the
    Monte-Carlo ensemble behind the confidence bands.

    The paper's headline numbers carry an n=3 caveat; this plan resolves
    it inside the repo by replicating all 18 atlas groups at N=16 seeds
    so `analyze.ensemble_bands` can bootstrap confidence bands on the
    penalty / utilization / C_eff curves (threaded into the planner's
    deployment curves and `analysis.json`). Quick protocol keeps the
    per-cell cost ~10x below paper tier; at 2016 cells the plan is only
    tractable because of the jit fleet backend:

        python -m repro_torch.experiments.run --plan paper_ensemble \\
            --backend jit --resume --analyze-json
    """
    return GridSpec(
        name="paper_ensemble",
        description="Monte-Carlo ensemble: 3 models x {v5e, v5p, v6e} x "
                    "{bf16, fp8} x 7-point ladder x 16 arrival seeds",
        archs=PAPER_TRIO,
        hws=("tpu-v5e", "tpu-v5p", "tpu-v6e"),
        quants=("bf16", "fp8"),
        ladder=LAMBDA_LADDER,
        n_chips_by_arch_hw=CROSSHW_CHIPS,
        seed_offsets=tuple(range(16)),
        seed=0,
        protocol="quick",
    ).expand()


def mini_ensemble() -> ExperimentPlan:
    """CI smoke for the ensemble axis: the mini_2x2 grid x 4 arrival
    seeds, smoke-tier traffic (16 cells). Enough replicates for
    `analyze.ensemble_bands` to emit finite (non-degenerate) bands."""
    return GridSpec(
        name="mini_ensemble",
        description="ensemble CI smoke: 2 archs x 2 lambdas x 4 arrival "
                    "seeds (sim tier)",
        archs=("llama31-8b", "qwen3-30b-a3b"),
        hws=("tpu-v5e",),
        quants=("bf16",),
        ladder=(5, 50),
        seed_offsets=(0, 1, 2, 3),
        seed=0,
        protocol="smoke",
        max_batch=64,
        num_pages=8192,
    ).expand()


def probe_int8_nonnative() -> ExperimentPlan:
    """126 cells exercising `quants_by_hw` at paper scale:
    int8 — the natively-accelerated low-precision format on
    every TPU part — is probed on the fp8-*emulating* generations (v5e,
    v5p), while the native-fp8 v6e keeps its fp8 path; bf16 is the
    baseline everywhere. Per-hardware quant allow-lists carve 126 cells
    out of the full 189-cell product, reproducing the paper's §5.9
    guidance that the Q axis should follow each part's native formats."""
    return GridSpec(
        name="probe_int8_nonnative",
        description="int8-on-non-native-fp8 probe: per-hw quant "
                    "allow-lists (v5e/v5p: bf16+int8, v6e: bf16+fp8), "
                    "3 models x 7-ladder",
        archs=PAPER_TRIO,
        hws=("tpu-v5e", "tpu-v5p", "tpu-v6e"),
        quants=("bf16", "int8", "fp8"),
        ladder=LAMBDA_LADDER,
        n_chips_by_arch_hw=CROSSHW_CHIPS,
        quants_by_hw=(
            ("tpu-v5e", ("bf16", "int8")),
            ("tpu-v5p", ("bf16", "int8")),
            ("tpu-v6e", ("bf16", "fp8")),
        ),
        seed=0,
        protocol="paper",
    ).expand()


def paper_resilience() -> ExperimentPlan:
    """Pricing reliability: what failures, retries and shedding
    do to $/M *delivered* tokens.

    Grid A (48 cells): the core dense model on its cheap-part footprint
    (llama31-8b @ tpu-v5e x2), 3-lambda ladder x MTTF ladder
    {none, 40, 15, 6 s} x retry {off, 3 attempts with capped backoff}.
    Every resilient cell runs with a queue-depth cap so shed arrivals and
    crash-killed requests both feed the client retry loop; the
    (mttf=0, retry=0) column is the failure-free baseline
    `analyze.reliability_tables` normalizes inflation against.

    Grid B (14 cells): the same model priced failure-free on both its
    v5e and v5p footprints over the full 7-point ladder — the deployment
    curves `planner --availability` reprices with N+1 spares, so the
    cheapest failure-free footprint can flip under an availability target.
    """
    grid_a = GridSpec(
        name="paper_resilience",
        description="reliability pricing: llama31-8b @ tpu-v5e x2, "
                    "3-lambda x MTTF {0,40,15,6} x retry {0,3} under "
                    "admission control; + failure-free v5e/v5p ladders "
                    "for availability-aware planning",
        archs=("llama31-8b",),
        hws=("tpu-v5e",),
        quants=("bf16",),
        ladder=(5.0, 10.0, 25.0),
        n_chips=2,
        mttfs=(0.0, 40.0, 15.0, 6.0),
        retry_maxes=(0, 3),
        mttr=2.0,
        fail_frac=0.5,
        retry_base_s=0.25,
        max_queue_depth=512,
        seed=0,
        protocol="quick",
    ).expand()
    grid_b = GridSpec(
        name="paper_resilience",
        archs=("llama31-8b",),
        hws=("tpu-v5e", "tpu-v5p"),
        quants=("bf16",),
        ladder=LAMBDA_LADDER,
        n_chips_by_arch_hw=CROSSHW_CHIPS,
        seed=0,
        protocol="quick",
    ).expand()
    # grid A's failure-free baselines at lam {5,10,25} are the same cells
    # as grid B's v5e ladder points — keep the first copy of each id.
    seen = {c.cell_id for c in grid_a.cells}
    extra = tuple(c for c in grid_b.cells if c.cell_id not in seen)
    return ExperimentPlan(
        name="paper_resilience",
        cells=grid_a.cells + extra,
        seed=0,
        description=grid_a.description)


def mini_resilience() -> ExperimentPlan:
    """CI smoke for the resilience axes: 1 model x 1 lambda x
    MTTF {0, 10} x retry {0, 2}, smoke-tier traffic (4 cells)."""
    return GridSpec(
        name="mini_resilience",
        description="resilience CI smoke: llama31-8b, lam=10, "
                    "mttf {0,4} x retry {0,2} (sim tier)",
        archs=("llama31-8b",),
        hws=("tpu-v5e",),
        quants=("bf16",),
        ladder=(10,),
        mttfs=(0.0, 4.0),
        retry_maxes=(0, 2),
        mttr=1.0,
        retry_base_s=0.25,
        max_queue_depth=64,
        seed=0,
        protocol="smoke",
        max_batch=64,
        num_pages=8192,
    ).expand()


def mini_crosshw() -> ExperimentPlan:
    """CI smoke for the cross-hardware axis: 2 models x {v5e, v6e} x
    {bf16, fp8} x 2 lambdas, smoke-tier traffic (16 cells). Exercises the
    per-(arch, hw) TP override and both native-fp8 regimes."""
    return GridSpec(
        name="mini_crosshw",
        description="cross-hardware CI smoke: 2 models x 2 hw x "
                    "{bf16, fp8} x 2 lambdas (sim tier)",
        archs=("llama31-8b", "qwen3-30b-a3b"),
        hws=("tpu-v5e", "tpu-v6e"),
        quants=("bf16", "fp8"),
        ladder=(5, 50),
        n_chips_by_arch_hw=(("qwen3-30b-a3b", "tpu-v5e", 2),),
        seed=0,
        protocol="smoke",
        max_batch=64,
        num_pages=8192,
    ).expand()


def mini_2x2() -> ExperimentPlan:
    """CI smoke: 2 archs x 2 lambdas, smoke-tier traffic (4 cells)."""
    return GridSpec(
        name="mini_2x2",
        description="2x2 CI smoke matrix (sim tier)",
        archs=("llama31-8b", "qwen3-30b-a3b"),
        hws=("tpu-v5e",),
        quants=("bf16",),
        ladder=(5, 50),
        seed=0,
        protocol="smoke",
        max_batch=64,
        num_pages=8192,
    ).expand()


def quickstart() -> ExperimentPlan:
    """The quickstart example's single-model ladder as a stored plan."""
    return GridSpec(
        name="quickstart",
        description="quickstart: llama31-8b on tpu-v5e, quick protocol",
        archs=("llama31-8b",),
        hws=("tpu-v5e",),
        quants=("bf16",),
        ladder=(1, 5, 10, 25, 50, 100),
        seed=0,
        protocol="quick",
    ).expand()


def _day_cells(scenario: DayScenario, *, plan_name: str, max_requests: int,
               min_requests: int, max_batch: int = 256,
               num_pages: int = 65536, seed: int = 0) -> Tuple[Cell, ...]:
    """Expand a DayScenario into its measurement cells.

    The windows of a piecewise-constant day are stationary segments, so
    the store measures POLICY-AGNOSTIC stationary points: for each
    deployment, one cell per distinct quantized per-replica rate that
    any trajectory (static or policy) visits — `scenario.rate_ladder` is
    the shared source of truth, so `analyze.diurnal_tables` can map
    every (window, policy) back to its record. Each cell captures about
    one window's worth of traffic (lam x window_s requests, clamped)."""
    cells = []
    for dep in scenario.deployments:
        for lam in scenario.rate_ladder(dep):
            n = int(min(max_requests,
                        max(min_requests, round(lam * scenario.window_s))))
            cell = Cell(
                plan=plan_name, config=f"day:{scenario.name}",
                model=dep.model, arch=dep.model, hw=dep.hw,
                quant=dep.quant, n_chips=dep.n_chips, lam=float(lam),
                io_shape="chat", seed=0, n_requests=n, warmup=0,
                price_per_hr=dep.price_per_hr, max_batch=max_batch,
                num_pages=num_pages)
            cells.append(dataclasses.replace(
                cell, seed=cell_seed(seed, cell.seed_key, cell.lam)))
    return tuple(cells)


def paper_diurnal() -> ExperimentPlan:
    """The "cost of a day of traffic" store: every stationary
    per-replica rate the `paper_day` scenario's trajectories visit —
    24 windows x (static + reactive + cautious autoscaling) x 2
    deployments, deduplicated to the distinct quantized rates
    (~60 cells). `analyze.diurnal_tables` recomputes the fleet
    trajectories (pure) and prices each policy's day from these
    measurements; the committed profile is chosen so the
    static-vs-autoscaled verdict FLIPS between the two deployments.

        python -m repro_torch.experiments.run --plan paper_diurnal \\
            --backend vector --resume --analyze
    """
    sc = DAY_SCENARIOS["paper_day"]
    return ExperimentPlan(
        name="paper_diurnal",
        cells=_day_cells(sc, plan_name="paper_diurnal",
                         max_requests=5000, min_requests=40),
        seed=0,
        description="cost of a day of traffic: per-replica stationary "
                    "rates for the paper_day 24h profile, static + 2 "
                    "autoscaling policies x 2 deployments")


def mini_diurnal() -> ExperimentPlan:
    """CI smoke for the non-stationary layer: the `mini_day` scenario's
    rate ladder at smoke tier (including a zero-rate window priced as
    idle), plus two profile-bearing cells — a trace replay and a diurnal
    sinusoid — that push lambda(t) streams through the fleet backend
    end to end."""
    sc = DAY_SCENARIOS["mini_day"]
    cells = list(_day_cells(sc, plan_name="mini_diurnal", max_requests=150,
                            min_requests=16, max_batch=64, num_pages=8192))
    dep = sc.deployments[0]
    t, knots = 0.0, []
    for r in sc.window_rates:
        knots.append((t, r))
        t += sc.window_s
    # the `profile:` config prefix marks non-stationary records: their
    # `lam` is the nominal mean of lambda(t), not a stationary offered
    # rate, so stationary analytics (_groups / fit_curves) skip them
    for config, kind, kn, period, args in (
            ("profile:trace_smoke", "trace", tuple(knots), sc.day_s, ()),
            ("profile:diurnal_smoke", "diurnal", (), 120.0,
             (1.0, 8.0, 0.5))):
        cell = Cell(
            plan="mini_diurnal", config=config, model=dep.model,
            arch=dep.model, hw=dep.hw, quant=dep.quant,
            n_chips=dep.n_chips, lam=4.0, io_shape="chat", seed=0,
            n_requests=120, warmup=0, price_per_hr=dep.price_per_hr,
            max_batch=64, num_pages=8192, profile_kind=kind,
            profile_knots=kn, profile_period_s=period, profile_args=args)
        cells.append(dataclasses.replace(
            cell, seed=cell_seed(0, cell.seed_key, cell.lam)))
    return ExperimentPlan(
        name="mini_diurnal", cells=tuple(cells), seed=0,
        description="diurnal CI smoke: mini_day rate ladder (incl. idle "
                    "window) + trace/diurnal lambda(t) stream cells")


# --------------------------------------------------------------------------
# flash crowds
# --------------------------------------------------------------------------

# arrival class mix: interactive / batch / background. Half the crowd
# is latency-sensitive; the other half is deferrable work the
# controller can shed — the headroom graceful degradation spends.
FLASH_MIX = (0.5, 0.3, 0.2)

# MMPP burst cells sweeping burst intensity: (name, base rate, burst
# rate, base dwell s, burst dwell s). The deployment (llama31-8b @
# tpu-v5e x2, theta_max ~2.9k tok/s ~= 11.5 req/s at chat shapes)
# saturates under every burst state — "calm" barely, "crowd" at ~5x
# capacity — so the queue actually floods and the controller has
# something to survive.
FLASH_BURSTS = (
    ("calm", 6.0, 18.0, 40.0, 10.0),
    ("gusty", 6.0, 30.0, 40.0, 10.0),
    ("crowd", 6.0, 60.0, 40.0, 10.0),
)

# degradation-ON arm: enter brownout at depth 16 (refuse background,
# clamp outputs to 64 tokens — the clamp multiplies request-rate
# capacity, which is what keeps interactive TTFT under the SLO at 3-5x
# overload), hard-shed batch+background at depth 32, recover below 4;
# degradation-OFF arm: monitor-only policy (same TTFT SLO, so
# violations are counted identically) with only the class-blind queue
# cap shedding — "blind shedding".
FLASH_POLICY = dict(ovl_brownout_depth=16, ovl_shed_depth=32,
                    ovl_recover_depth=4, ovl_ttft_slo_s=2.0,
                    ovl_brownout_max_new=64)
FLASH_MONITOR = dict(ovl_ttft_slo_s=2.0)


def _flashcrowd_cells(*, plan_name: str, bursts, policy: dict,
                      monitor: dict, mqd: int, duration_s: float,
                      max_batch: int = 256, num_pages: int = 65536,
                      seed: int = 0) -> Tuple[Cell, ...]:
    """Expand MMPP burst scenarios into paired degradation-on/off cells.

    Both arms of a burst share one seed (derived from the arm-agnostic
    template cell), hence one arrival + class stream — the comparison is
    *paired*, isolating the controller's effect. `lam` is the
    time-weighted mean of the two MMPP states (the record's nominal
    rate); `n_requests` covers ~`duration_s` of that mean rate."""
    cells = []
    for bname, ra, rb, da, db in bursts:
        lam = (ra * da + rb * db) / (da + db)
        base = Cell(
            plan=plan_name, config=f"flash:{bname}", model="llama31-8b",
            arch="llama31-8b", hw="tpu-v5e", quant="bf16", n_chips=2,
            lam=lam, io_shape="chat", seed=0,
            n_requests=int(lam * duration_s), warmup=0,
            price_per_hr=chip_hour_price("tpu-v5e", 2),
            max_batch=max_batch, num_pages=num_pages,
            profile_kind="mmpp", profile_args=(ra, rb, da, db),
            class_mix=FLASH_MIX, max_queue_depth=mqd)
        shared = cell_seed(seed, base.seed_key, lam)
        for arm, ovl in (("on", policy), ("off", monitor)):
            cells.append(dataclasses.replace(
                base, config=f"flash:{bname}:{arm}", seed=shared, **ovl))
    return tuple(cells)


def paper_flashcrowd() -> ExperimentPlan:
    """Overload survival: 3 MMPP burst intensities x
    {degradation on, off} on the core cheap-part deployment (6 cells,
    ~150 s of traffic each).

    Each burst pair shares its arrival + priority-class stream; the ON
    arm runs the armed OverloadPolicy (priority shedding + token-budget
    brownout + hysteresis), the OFF arm a monitor-only policy behind the
    same queue cap (blind shedding, violations still counted).
    `analyze.overload_tables` prices both arms per SLO-met interactive
    token; the committed store is tuned so degradation wins every cell.

        python -m repro_torch.experiments.run --plan paper_flashcrowd \\
            --backend vector --resume --analyze-json
    """
    return ExperimentPlan(
        name="paper_flashcrowd",
        cells=_flashcrowd_cells(
            plan_name="paper_flashcrowd", bursts=FLASH_BURSTS,
            policy=FLASH_POLICY, monitor=FLASH_MONITOR, mqd=256,
            duration_s=150.0),
        seed=0,
        description="flash-crowd survival: 3 MMPP burst intensities x "
                    "{degradation on, off}, llama31-8b @ tpu-v5e x2, "
                    "paired arrival streams")


def mini_flashcrowd() -> ExperimentPlan:
    """CI smoke for the overload layer: one MMPP burst x {on, off} at
    smoke tier (2 cells). Exercises class mixes, the armed controller
    and the monitor-only arm end to end through the fleet backend."""
    return ExperimentPlan(
        name="mini_flashcrowd",
        cells=_flashcrowd_cells(
            plan_name="mini_flashcrowd",
            bursts=(("squall", 3.0, 24.0, 30.0, 12.0),),
            policy=dict(ovl_brownout_depth=8, ovl_shed_depth=16,
                        ovl_recover_depth=2, ovl_ttft_slo_s=1.5,
                        ovl_brownout_max_new=64),
            monitor=dict(ovl_ttft_slo_s=1.5),
            mqd=96, duration_s=45.0, max_batch=64, num_pages=8192),
        seed=0,
        description="flash-crowd CI smoke: one MMPP burst x "
                    "{degradation on, off} (sim tier)")


def crossover_trio() -> ExperimentPlan:
    """The crossover example's three configs on tpu-v5p, quick protocol."""
    plans = []
    for arch, quant, chips in (("llama31-8b", "bf16", 1),
                               ("qwen3-30b-a3b", "int8", 1),
                               ("mixtral-8x7b", "bf16", 2)):
        plans.append(GridSpec(
            name="crossover_trio", archs=(arch,), hws=("tpu-v5p",),
            quants=(quant,), ladder=(1, 2, 5, 10, 25, 50, 100),
            n_chips=chips, seed=0, protocol="quick").expand())
    cells = tuple(c for p in plans for c in p.cells)
    return ExperimentPlan(
        name="crossover_trio", cells=cells, seed=0,
        description="crossover example: 3 (model, quant, TP) configs on "
                    "tpu-v5p, quick protocol")


PLANS: Dict[str, Callable[[], ExperimentPlan]] = {
    "paper_h100": paper_h100,
    "paper_a100": paper_a100,
    "paper_crosshw": paper_crosshw,
    "paper_atlas": paper_atlas,
    "paper_ensemble": paper_ensemble,
    "mini_ensemble": mini_ensemble,
    "probe_int8_nonnative": probe_int8_nonnative,
    "paper_resilience": paper_resilience,
    "mini_resilience": mini_resilience,
    "paper_diurnal": paper_diurnal,
    "mini_diurnal": mini_diurnal,
    "paper_flashcrowd": paper_flashcrowd,
    "mini_flashcrowd": mini_flashcrowd,
    "mini_crosshw": mini_crosshw,
    "mini_2x2": mini_2x2,
    "quickstart": quickstart,
    "crossover_trio": crossover_trio,
}


def get_plan(name: str) -> ExperimentPlan:
    if name not in PLANS:
        raise KeyError(f"unknown plan {name!r}; known: {sorted(PLANS)}")
    return PLANS[name]()


def on_hw(plan: ExperimentPlan, hw: str, *, add: bool = False
          ) -> ExperimentPlan:
    """`plan` moved onto the hardware-book entry `hw`: the cells of the
    plan's generation whose HBM is nearest `hw`'s, each with that
    generation's chip count, priced at `hw`'s rate and seeded as a grid on
    `hw` would seed it; the plan is named `<plan>_on_<hw>`. With `add` the
    plan keeps its name and its own cells, and these join them (a
    cross-hardware plan gains a generation; its store's cells stay
    valid)."""
    from repro_torch.simulate.hardware import HW_BY_NAME
    target = HW_BY_NAME[hw].hbm_bytes
    src = min(dict.fromkeys(c.hw for c in plan.cells),
              key=lambda h: abs(HW_BY_NAME[h].hbm_bytes - target))
    name = plan.name if add else f"{plan.name}_on_{hw.replace('-', '_')}"
    moved = []
    for c in plan.cells:
        if c.hw != src:
            continue
        c = dataclasses.replace(c, plan=name, hw=hw, price_per_hr=
                                chip_hour_price(hw, c.n_chips))
        moved.append(dataclasses.replace(
            c, seed=cell_seed(plan.seed, c.seed_key, c.lam)))
    return dataclasses.replace(plan, name=name, cells=(
        plan.cells if add else ()) + tuple(moved))
