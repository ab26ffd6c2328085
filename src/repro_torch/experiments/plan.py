"""Declarative experiment cells and plans.

A `Cell` is one fully-specified measurement — everything `run_point`
needs, flattened into a frozen, picklable, hashable record: model/hw/quant
coordinates, the offered rate, the arrival protocol (request counts baked
to ints at expansion time) and the engine knobs. A `GridSpec` expands an
arch x hw x quant x n_chips x lambda x io_shape product into an
`ExperimentPlan`; expansion is pure, so the same spec always yields the
same cell list with the same per-cell seeds.

Seed derivation: each ladder group (every coordinate except lambda) gets a
group seed from the plan seed plus a CRC32 of the group key — stable
across processes and Python versions, unlike `hash()` — and each cell in
the group derives `group_seed + int(lam * 1000)`, the exact rule
`core.sweep._ladder_specs` has always used. A ladder plan built from the
same seed therefore reproduces `lambda_sweep` records bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.pricing import chip_hour_price
from repro_torch.core.sweep import (LAMBDA_LADDER, SimEngineSpec,
                              default_requests_per_point,
                              default_warmup_per_point)


def quick_requests_per_point(lam: float) -> int:
    """The examples' reduced protocol (~10x lighter than the paper's)."""
    return int(min(600, max(120, 20 * lam)))


def smoke_requests_per_point(lam: float) -> int:
    """CI-smoke tier: just enough traffic to exercise the queue."""
    return int(min(80, max(30, 4 * lam)))


def zero_warmup(lam: float) -> int:
    return 0


# protocol name -> (requests_per_point, warmup_per_point); cells bake the
# resulting ints so workers never ship callables across the pool.
PROTOCOLS: Dict[str, Tuple[Callable[[float], int], Callable[[float], int]]] = {
    "paper": (default_requests_per_point, default_warmup_per_point),
    "quick": (quick_requests_per_point, zero_warmup),
    "smoke": (smoke_requests_per_point, zero_warmup),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (model, hw, quant, n_chips, lambda, io_shape) measurement."""
    plan: str
    config: str                 # record label (paper C1..C6 or free-form)
    model: str
    arch: str                   # registry key for the engine factory
    hw: str
    quant: str
    n_chips: int
    lam: float
    io_shape: str
    seed: int
    n_requests: int
    warmup: int
    price_per_hr: float
    process: str = "poisson"
    cv: float = 1.0
    scale: float = 1.0
    horizon: Optional[float] = None
    failure_times: Tuple[float, ...] = ()
    engine_kind: str = "sim"
    # engine knobs (SimEngineSpec fields)
    max_batch: int = 256
    page_size: int = 16
    num_pages: int = 65536
    max_pages_per_seq: int = 64
    prefill_token_budget: int = 2048
    max_prefill_reqs: int = 8
    fast_forward: bool = True
    # resilience axes — all-zero means off; they join cell_id /
    # group_key only when on, so pre-existing plans keep their historical
    # seed streams (and records) exactly.
    mttf: float = 0.0           # mean time to replica failure (0 = none)
    mttr: float = 0.0           # mean restart lag after a crash
    fail_frac: float = 0.5      # fraction of running slots lost per crash
    retry_max: int = 0          # client retry budget (0 = no retries)
    retry_base_s: float = 0.5   # backoff base (doubles per attempt)
    retry_jitter_s: float = 0.0
    max_queue_depth: int = 0    # engine admission-control shed depth
    deadline_s: float = 0.0     # engine queue-time deadline
    # Monte-Carlo replicate index. Nonzero offsets join
    # cell_id / seed_key so each replicate draws an independent arrival
    # stream; offset 0 stays OUT of the keys, so pre-ensemble plans keep
    # their historical seed streams (and committed records) byte-exactly.
    seed_offset: int = 0
    # lambda(t): a non-stationary cell carries its RateProfile
    # flattened into hashable tuples (kind/knots/period/args — see
    # serving.arrivals.RateProfile). Empty kind = stationary; like
    # seed_offset, the default stays OUT of cell_id / seed_key /
    # fingerprint so every historical plan and committed store keeps its
    # exact ids, seeds and cell files.
    profile_kind: str = ""
    profile_knots: Tuple[Tuple[float, float], ...] = ()
    profile_period_s: float = 0.0
    profile_args: Tuple[float, ...] = ()
    # overload survival: priority-class mix over arrivals and
    # the flattened OverloadPolicy. All-default means off and, like
    # seed_offset/profile_*, stays OUT of cell_id / seed_key /
    # fingerprint so historical plans and committed stores keep their
    # exact ids, seeds and cell files. The ovl_* fields mirror
    # `serving.overload.OverloadPolicy` one-for-one.
    class_mix: Tuple[float, ...] = ()
    ovl_brownout_depth: int = 0
    ovl_shed_depth: int = 0
    ovl_recover_depth: int = 0
    ovl_ttft_slo_s: float = 0.0
    ovl_brownout_max_new: int = 0
    ovl_brownout_shed_floor: int = 2    # overload.BACKGROUND
    ovl_shed_floor: int = 1             # overload.BATCH
    # runner execution policy (not part of the measurement itself)
    cell_retries: int = 2       # re-dispatch budget after worker loss

    @property
    def profile_key(self) -> Tuple:
        return (self.profile_kind, self.profile_knots,
                self.profile_period_s, self.profile_args)

    @property
    def resilience_key(self) -> Tuple:
        return (self.mttf, self.mttr, self.fail_frac, self.retry_max,
                self.retry_base_s, self.retry_jitter_s,
                self.max_queue_depth, self.deadline_s)

    @property
    def overload_key(self) -> Tuple:
        return (self.class_mix, self.ovl_brownout_depth, self.ovl_shed_depth,
                self.ovl_recover_depth, self.ovl_ttft_slo_s,
                self.ovl_brownout_max_new, self.ovl_brownout_shed_floor,
                self.ovl_shed_floor)

    @property
    def overloaded(self) -> bool:
        """True when the cell carries a priority-class mix or an
        OverloadPolicy — armed or monitor-only (ttft_slo_s only)."""
        return (bool(self.class_mix) or self.ovl_brownout_depth > 0
                or self.ovl_shed_depth > 0 or self.ovl_brownout_max_new > 0
                or self.ovl_ttft_slo_s > 0.0)

    @property
    def resilient(self) -> bool:
        """True when any behavior-changing resilience knob is on.
        fail_frac/mttr/retry_base_s/jitter are parameters OF those knobs
        (nonzero defaults), so they don't gate by themselves."""
        return (self.mttf > 0.0 or self.retry_max > 0
                or self.max_queue_depth > 0 or self.deadline_s > 0.0)

    @property
    def cell_id(self) -> str:
        lam = f"{self.lam:g}".replace(".", "p")
        raw = (f"{self.arch}_{self.hw}_{self.quant}_x{self.n_chips}"
               f"_{self.io_shape}_lam{lam}")
        if self.resilient:
            mttf = f"{self.mttf:g}".replace(".", "p")
            raw += f"_mttf{mttf}_r{self.retry_max}"
        if self.seed_offset:
            raw += f"_s{self.seed_offset}"
        if self.profile_kind:
            pk = zlib.crc32(repr(self.profile_key).encode()) % 100000
            raw += f"_prof-{self.profile_kind}{pk}"
        if self.overloaded:
            ok = zlib.crc32(repr(self.overload_key).encode()) % 100000
            raw += f"_ovl{ok}"
        return raw.replace("/", "-")

    @property
    def seed_key(self) -> Tuple:
        """Arrival-seed group: the resilience axes are EXCLUDED, so every
        resilient cell shares its failure-free sibling's arrival stream.
        Reliability comparisons are therefore *paired* — same arrivals,
        same request shapes — isolating the failure/retry effect from
        arrival-realization noise.

        Ensemble replicates (nonzero `seed_offset`) append the offset so
        each replicate draws an independent arrival stream; offset 0 is
        omitted, keeping every historical plan's streams unchanged."""
        base = (self.config, self.model, self.arch, self.hw, self.quant,
                self.n_chips, self.io_shape, self.process, self.cv,
                self.scale, self.engine_kind)
        if self.seed_offset:
            base = base + (("seed_offset", self.seed_offset),)
        if self.profile_kind:
            base = base + (("profile",) + self.profile_key,)
        return base

    @property
    def group_key(self) -> Tuple:
        """Ladder group: theta_max is back-filled across cells that share
        everything but the offered rate."""
        base = self.seed_key
        if self.resilient:
            base = base + self.resilience_key
        if self.overloaded:
            # overload axes group like the resilience axes: they stay out
            # of seed_key (degradation-on/off arms share one arrival +
            # class stream — *paired* comparison) but split ladder groups,
            # so theta_max is back-filled per policy arm.
            base = base + (("ovl",) + self.overload_key,)
        return base

    def fingerprint(self) -> str:
        """Spec hash stored beside each result; a stale on-disk cell (spec
        changed since it ran) is re-run instead of resumed."""
        spec = dataclasses.asdict(self)
        if not self.seed_offset:
            # like the keys, the default-zero ensemble offset stays out
            # of the hash: stores committed before the axis existed must
            # keep resuming (and their cell files keep byte-identity)
            spec.pop("seed_offset")
        if not self.profile_kind:
            # same rule for the lambda(t) fields
            for k in ("profile_kind", "profile_knots", "profile_period_s",
                      "profile_args"):
                spec.pop(k)
        if not self.overloaded:
            # and for the overload-survival fields
            for k in ("class_mix", "ovl_brownout_depth", "ovl_shed_depth",
                      "ovl_recover_depth", "ovl_ttft_slo_s",
                      "ovl_brownout_max_new", "ovl_brownout_shed_floor",
                      "ovl_shed_floor"):
                spec.pop(k)
        blob = json.dumps(spec, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def engine_spec(self) -> SimEngineSpec:
        return SimEngineSpec(
            arch=self.arch, hw=self.hw, quant=self.quant,
            n_chips=self.n_chips, max_batch=self.max_batch,
            page_size=self.page_size, num_pages=self.num_pages,
            max_pages_per_seq=self.max_pages_per_seq,
            prefill_token_budget=self.prefill_token_budget,
            max_prefill_reqs=self.max_prefill_reqs,
            fast_forward=self.fast_forward,
            max_queue_depth=self.max_queue_depth,
            deadline_s=self.deadline_s,
            overload=self.overload_policy())

    def failure_spec(self):
        """FailureSpec for this cell, or None. The stream seed is derived
        from the cell seed at a fixed offset so every cell gets its own
        deterministic crash schedule."""
        if self.mttf <= 0.0:
            return None
        from repro_torch.serving.resilience import FailureSpec
        return FailureSpec(mttf=self.mttf, mttr=self.mttr,
                           loss_frac=self.fail_frac, seed=self.seed + 911)

    def overload_policy(self):
        """OverloadPolicy for this cell, or None. A cell with only
        `ovl_ttft_slo_s` set carries a monitor-only policy (violations
        counted, nothing shed or clamped) — the degradation-OFF arm of
        the flash-crowd experiment."""
        if not (self.ovl_brownout_depth > 0 or self.ovl_shed_depth > 0
                or self.ovl_brownout_max_new > 0
                or self.ovl_ttft_slo_s > 0.0):
            return None
        from repro_torch.serving.overload import OverloadPolicy
        return OverloadPolicy(
            brownout_depth=self.ovl_brownout_depth,
            shed_depth=self.ovl_shed_depth,
            recover_depth=self.ovl_recover_depth,
            ttft_slo_s=self.ovl_ttft_slo_s,
            brownout_max_new=self.ovl_brownout_max_new,
            brownout_shed_floor=self.ovl_brownout_shed_floor,
            shed_floor=self.ovl_shed_floor).validate()

    def retry_policy(self):
        if self.retry_max <= 0:
            return None
        from repro_torch.serving.resilience import RetryPolicy
        return RetryPolicy(max_attempts=self.retry_max,
                           base_delay_s=self.retry_base_s,
                           jitter_s=self.retry_jitter_s,
                           seed=self.seed + 977)

    def arrival_spec(self):
        from repro_torch.serving.arrivals import ArrivalSpec, RateProfile
        profile = None
        if self.profile_kind:
            profile = RateProfile(
                kind=self.profile_kind,
                knots=tuple(tuple(k) for k in self.profile_knots),
                period_s=self.profile_period_s,
                args=tuple(self.profile_args)).validate()
        return ArrivalSpec(lam=self.lam, n_requests=self.n_requests,
                           io_shape=self.io_shape, process=self.process,
                           cv=self.cv, seed=self.seed, scale=self.scale,
                           profile=profile, class_mix=self.class_mix)

    def record_kw(self) -> Dict:
        return dict(config=self.config, model=self.model, hw=self.hw,
                    n_chips=self.n_chips, quant=self.quant,
                    engine_kind=self.engine_kind,
                    price_per_hr=self.price_per_hr)


def group_seed(plan_seed: int, group_key: Sequence) -> int:
    """Stable per-group base seed (CRC32, not hash(): PYTHONHASHSEED-proof)."""
    key = "|".join(str(k) for k in group_key)
    return plan_seed + (zlib.crc32(key.encode()) % 900_000_000)


def cell_seed(plan_seed: int, group_key: Sequence, lam: float) -> int:
    """group base + the ladder rule `_ladder_specs` has always used."""
    return group_seed(plan_seed, group_key) + int(lam * 1000)


@dataclasses.dataclass(frozen=True)
class ExperimentPlan:
    name: str
    cells: Tuple[Cell, ...]
    seed: int = 0
    description: str = ""

    def __len__(self) -> int:
        return len(self.cells)

    def groups(self) -> Dict[Tuple, List[Cell]]:
        out: Dict[Tuple, List[Cell]] = {}
        for c in self.cells:
            out.setdefault(c.group_key, []).append(c)
        return out

    def transform(self, fn: Callable[[Cell], Cell],
                  suffix: str = "") -> "ExperimentPlan":
        """Plan transform: map every cell (e.g. a PERF-override variant).
        The transformed plan keeps per-cell seeds unless `fn` changes them."""
        cells = tuple(fn(c) for c in self.cells)
        return dataclasses.replace(
            self, name=self.name + suffix, cells=cells)

    def subset(self, pred: Callable[[Cell], bool]) -> "ExperimentPlan":
        return dataclasses.replace(
            self, cells=tuple(c for c in self.cells if pred(c)))


def iter_grid(**axes: Sequence) -> Iterator[Dict]:
    """Ordered cartesian product over named axes — the one grid walker the
    subsystem (and launch/optimized_sweep) share, so every consumer
    enumerates cells in the same deterministic order."""
    names = list(axes)
    for combo in itertools.product(*(axes[n] for n in names)):
        yield dict(zip(names, combo))


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Declarative arch x hw x quant x n_chips x lambda x io_shape grid.

    Hardware is a first-class axis: one spec can span several
    generations (`hws=("tpu-v5e", "tpu-v5p", "tpu-v6e")`) with
    per-hardware TP degrees — the same model needs more of the small-HBM
    part — via `n_chips_by_arch_hw`, and per-hardware quant restrictions
    via `quants_by_hw` (e.g. probe fp8 only on the native-fp8 part).
    """
    name: str
    archs: Tuple[str, ...]
    hws: Tuple[str, ...] = ("tpu-v5e",)
    quants: Tuple[str, ...] = ("bf16",)
    ladder: Tuple[float, ...] = LAMBDA_LADDER
    io_shapes: Tuple[str, ...] = ("chat",)
    n_chips: int = 1
    # per-arch TP override as (arch, n_chips) pairs (frozen-friendly map)
    n_chips_by_arch: Tuple[Tuple[str, int], ...] = ()
    # per-(arch, hw) TP override; wins over n_chips_by_arch. This is what
    # lets a cross-hardware plan deploy the same model at hardware-fitting
    # footprints (bf16 weights must fit the part's HBM).
    n_chips_by_arch_hw: Tuple[Tuple[str, str, int], ...] = ()
    # per-hw quant allow-list as (hw, (quant, ...)) pairs; an hw absent
    # from the map runs every quant in `quants`.
    quants_by_hw: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    seed: int = 0
    protocol: str = "paper"
    process: str = "poisson"
    cv: float = 1.0
    scale: float = 1.0
    description: str = ""
    # engine knobs applied to every cell
    max_batch: int = 256
    num_pages: int = 65536
    max_pages_per_seq: int = 64
    fast_forward: bool = True
    # resilience axes: the grid walks mttf x retry_max after
    # lambda; the remaining knobs are scalars shared by every cell. The
    # defaults keep every pre-existing spec expanding to bit-identical
    # plans (all-zero == resilience off).
    mttfs: Tuple[float, ...] = (0.0,)
    retry_maxes: Tuple[int, ...] = (0,)
    mttr: float = 0.0
    fail_frac: float = 0.5
    retry_base_s: float = 0.5
    retry_jitter_s: float = 0.0
    max_queue_depth: int = 0
    deadline_s: float = 0.0
    # Monte-Carlo ensemble axis: each offset replicates the
    # whole grid with an independent arrival stream. The default (0,)
    # expands to the exact historical plan (offset 0 never joins keys).
    seed_offsets: Tuple[int, ...] = (0,)

    def chips_for(self, arch: str, hw: Optional[str] = None) -> int:
        if hw is not None:
            for a, h, n in self.n_chips_by_arch_hw:
                if (a, h) == (arch, hw):
                    return n
        return dict(self.n_chips_by_arch).get(arch, self.n_chips)

    def quants_for(self, hw: str) -> Tuple[str, ...]:
        allowed = dict(self.quants_by_hw).get(hw)
        if allowed is None:
            return self.quants
        return tuple(q for q in self.quants if q in allowed)

    def expand(self) -> ExperimentPlan:
        """Pure expansion: same spec -> same cells, same seeds."""
        req_fn, warm_fn = PROTOCOLS[self.protocol]
        cells: List[Cell] = []
        for ax in iter_grid(arch=self.archs, hw=self.hws, quant=self.quants,
                            io_shape=self.io_shapes, lam=self.ladder,
                            mttf=self.mttfs, retry_max=self.retry_maxes,
                            seed_offset=self.seed_offsets):
            if ax["quant"] not in self.quants_for(ax["hw"]):
                continue
            chips = self.chips_for(ax["arch"], ax["hw"])
            resil = ax["mttf"] > 0.0 or ax["retry_max"] > 0
            cell = Cell(
                plan=self.name, config=ax["arch"], model=ax["arch"],
                arch=ax["arch"], hw=ax["hw"], quant=ax["quant"],
                n_chips=chips, lam=float(ax["lam"]),
                io_shape=ax["io_shape"], seed=0,
                n_requests=req_fn(ax["lam"]), warmup=warm_fn(ax["lam"]),
                price_per_hr=chip_hour_price(ax["hw"], chips),
                process=self.process, cv=self.cv, scale=self.scale,
                max_batch=self.max_batch, num_pages=self.num_pages,
                max_pages_per_seq=self.max_pages_per_seq,
                fast_forward=self.fast_forward,
                mttf=float(ax["mttf"]), retry_max=int(ax["retry_max"]),
                # shared knobs only matter on resilient cells; keeping
                # them zeroed elsewhere preserves historical cell specs.
                mttr=self.mttr if ax["mttf"] > 0.0 else 0.0,
                fail_frac=self.fail_frac if ax["mttf"] > 0.0 else 0.5,
                retry_base_s=self.retry_base_s,
                retry_jitter_s=self.retry_jitter_s,
                max_queue_depth=self.max_queue_depth if resil else 0,
                deadline_s=self.deadline_s if resil else 0.0,
                seed_offset=int(ax["seed_offset"]))
            cells.append(dataclasses.replace(
                cell, seed=cell_seed(self.seed, cell.seed_key, cell.lam)))
        return ExperimentPlan(name=self.name, cells=tuple(cells),
                              seed=self.seed, description=self.description)


def ladder_plan(*, name: str = "ladder", ladder: Sequence[float],
                io_shape: str = "chat", scale: float = 1.0,
                requests_per_point: Optional[Callable[[float], int]] = None,
                warmup_per_point: Optional[Callable[[float], int]] = None,
                horizon: Optional[float] = None, seed: int = 0,
                process: str = "poisson", cv: float = 1.0,
                config: str = "", model: str = "", hw: str = "cpu-node",
                n_chips: int = 1, quant: str = "bf16",
                engine_kind: str = "sim", price_per_hr: float = 1.0,
                failure_times: Sequence[float] = (),
                arch: str = "") -> ExperimentPlan:
    """The single-group plan behind `lambda_sweep`/`parallel_sweep`.

    Seeds are `seed + int(lam * 1000)` — the raw sweep seed, NOT routed
    through `group_seed`, so refactored sweeps reproduce the historical
    records exactly.
    """
    if requests_per_point is None:
        requests_per_point = default_requests_per_point
    if warmup_per_point is None:
        warmup_per_point = default_warmup_per_point
    cells = tuple(
        Cell(plan=name, config=config, model=model, arch=arch, hw=hw,
             quant=quant, n_chips=n_chips, lam=float(lam), io_shape=io_shape,
             seed=seed + int(lam * 1000), n_requests=requests_per_point(lam),
             warmup=warmup_per_point(lam), price_per_hr=price_per_hr,
             process=process, cv=cv, scale=scale, horizon=horizon,
             failure_times=tuple(failure_times), engine_kind=engine_kind)
        for lam in ladder)
    return ExperimentPlan(name=name, cells=cells, seed=seed)
