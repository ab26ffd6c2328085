"""Open-loop arrival processes and synthetic request generation.

Matches the paper's protocol (§4.3): Poisson arrivals (burstiness 1.0) by
default, Gamma inter-arrivals for the burstiness probe (CV=2 ==
--burstiness 0.25), fixed 512:256 I/O shape by default with the RAG /
agentic / variable-length (log-normal) shapes of §5.7 available.

Non-stationary traffic: a `RateProfile` turns the stationary
lambda into lambda(t) — piecewise-constant windows, a diurnal sinusoid,
MMPP-style two-state burst switching, or replay of a (t, rate) trace —
and `profile_arrivals` generates the corresponding non-homogeneous
Poisson stream by Lewis-Shedler thinning.

lambda(t) stream protocol (frozen, like the `synth_arrays` contract):

* Candidate points are drawn from a homogeneous Poisson process at the
  profile's max rate in fixed blocks of `THINNING_BLOCK` draws — per
  block, `rng.exponential(1/lam_max, THINNING_BLOCK)` gaps first, then
  `rng.random(THINNING_BLOCK)` acceptance uniforms — and candidate t is
  accepted iff `u * lam_max < lambda(t)`. Block size, draw order and the
  strict `<` are part of the protocol: they fix the rng consumption
  pattern, so the same (spec.seed, profile) always yields the same
  stream on every backend.
* A CONSTANT profile never thins: `synth_arrays` routes it through the
  exact legacy `poisson_arrivals`/`gamma_arrivals` path, so a stationary
  spec with `profile=RateProfile.constant(spec.lam)` is byte-identical
  to the same spec with `profile=None` (tested; committed stores rely on
  it).
* MMPP profiles are *realized* before thinning: the two-state switching
  timeline is drawn from a dedicated generator seeded
  `spec.seed + MMPP_SEED_OFFSET`, never from the arrival stream's
  generator, so the arrival draws stay aligned with the other kinds.
* Zero-rate segments accept nothing — candidates falling inside them are
  rejected, which is exactly "no arrivals in this window". A profile
  whose max rate is 0 raises ValueError, and a profile that accepts too
  few points (e.g. a trace that decays to 0 forever) raises RuntimeError
  after `THINNING_MAX_BLOCKS` candidate blocks instead of spinning.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request


def poisson_arrivals(rng: np.random.Generator, lam: float, n: int,
                     start: float = 0.0) -> np.ndarray:
    """n exponential inter-arrival times at rate lam (CV=1).

    lam == 0 means "no arrivals in this window" and returns an empty
    array (previously 1/lam minted inf times that propagated
    silently through cumsum into engine clocks); lam < 0 raises."""
    if lam < 0:
        raise ValueError(f"arrival rate must be >= 0, got {lam}")
    if lam == 0:
        return np.empty(0, np.float64)
    gaps = rng.exponential(1.0 / lam, size=n)
    return start + np.cumsum(gaps)


def gamma_arrivals(rng: np.random.Generator, lam: float, cv: float, n: int,
                   start: float = 0.0) -> np.ndarray:
    """Gamma inter-arrivals with coefficient of variation `cv` at rate lam.

    shape k = 1/cv^2, scale = cv^2 / lam  (mean 1/lam, CV = cv).
    Zero/negative rates follow `poisson_arrivals`' contract."""
    if lam < 0:
        raise ValueError(f"arrival rate must be >= 0, got {lam}")
    if lam == 0:
        return np.empty(0, np.float64)
    k = 1.0 / (cv * cv)
    theta = cv * cv / lam
    gaps = rng.gamma(k, theta, size=n)
    return start + np.cumsum(gaps)


# ---------------------------------------------------------------------------
# lambda(t): rate profiles + thinning
# ---------------------------------------------------------------------------

# thinning draw-block size — part of the frozen stream protocol above
THINNING_BLOCK = 4096
# candidate blocks before giving up on a profile that accepts ~nothing
THINNING_MAX_BLOCKS = 4096
# MMPP switching timelines draw from spec.seed + this offset (dedicated
# stream, like the warmup stream's +7777 and FailureSpec's +911)
MMPP_SEED_OFFSET = 9973
# priority-class draws come from their own generator at
# spec.seed + this offset: a spec without a class mix performs ZERO
# extra draws, so every historical stream stays byte-identical
CLASS_SEED_OFFSET = 5851


@dataclasses.dataclass(frozen=True)
class RateProfile:
    """lambda(t), picklable and frozen so it can ride Cells/FleetPoints.

    kinds:
      constant   rate(t) = args[0] (routes through the legacy generators)
      piecewise  knots = ((duration_s, rate), ...) cycled forever
      diurnal    sinusoid over period_s: trough/peak = args[0]/args[1],
                 peak centered at args[2] (fraction of the period)
      mmpp       2-state Markov-modulated Poisson: args = (rate_a,
                 rate_b, dwell_a_s, dwell_b_s); the exponential-dwell
                 switching timeline is realized from a dedicated seed
      trace      knots = ((t_s, rate), ...) step-held replay; rate holds
                 past the last knot, and period_s > 0 cycles the trace
    """
    kind: str = "constant"
    knots: Tuple[Tuple[float, float], ...] = ()
    period_s: float = 0.0
    args: Tuple[float, ...] = ()

    # -- constructors ----------------------------------------------------
    @classmethod
    def constant(cls, rate: float) -> "RateProfile":
        return cls(kind="constant", args=(float(rate),))

    @classmethod
    def piecewise(cls, segments) -> "RateProfile":
        return cls(kind="piecewise",
                   knots=tuple((float(d), float(r)) for d, r in segments))

    @classmethod
    def diurnal(cls, trough: float, peak: float, period_s: float,
                peak_frac: float = 0.5) -> "RateProfile":
        return cls(kind="diurnal", period_s=float(period_s),
                   args=(float(trough), float(peak), float(peak_frac)))

    @classmethod
    def mmpp(cls, rate_a: float, rate_b: float, dwell_a_s: float,
             dwell_b_s: float) -> "RateProfile":
        return cls(kind="mmpp", args=(float(rate_a), float(rate_b),
                                      float(dwell_a_s), float(dwell_b_s)))

    @classmethod
    def trace(cls, points, period_s: float = 0.0) -> "RateProfile":
        return cls(kind="trace", period_s=float(period_s),
                   knots=tuple((float(t), float(r)) for t, r in points))

    # -- validation ------------------------------------------------------
    def validate(self) -> "RateProfile":
        if self.kind == "constant":
            if len(self.args) != 1:
                raise ValueError("constant profile needs args=(rate,)")
            if self.args[0] < 0:
                raise ValueError(f"rate must be >= 0, got {self.args[0]}")
        elif self.kind == "piecewise":
            if not self.knots:
                raise ValueError("piecewise profile needs segments")
            for d, r in self.knots:
                if d <= 0:
                    raise ValueError(f"segment duration must be > 0: {d}")
                if r < 0:
                    raise ValueError(f"rate must be >= 0, got {r}")
        elif self.kind == "diurnal":
            if len(self.args) != 3:
                raise ValueError(
                    "diurnal profile needs args=(trough, peak, peak_frac)")
            trough, peak, _ = self.args
            if trough < 0 or peak < trough:
                raise ValueError(
                    f"need 0 <= trough <= peak, got {trough}..{peak}")
            if self.period_s <= 0:
                raise ValueError("diurnal profile needs period_s > 0")
        elif self.kind == "mmpp":
            if len(self.args) != 4:
                raise ValueError("mmpp profile needs args=(rate_a, rate_b, "
                                 "dwell_a_s, dwell_b_s)")
            ra, rb, da, db = self.args
            if ra < 0 or rb < 0:
                raise ValueError(f"rates must be >= 0, got {ra}, {rb}")
            if da <= 0 or db <= 0:
                raise ValueError(f"dwells must be > 0, got {da}, {db}")
        elif self.kind == "trace":
            if not self.knots:
                raise ValueError("trace profile needs (t, rate) knots")
            ts = [t for t, _ in self.knots]
            if ts != sorted(ts):
                raise ValueError("trace knots must ascend in t")
            for _, r in self.knots:
                if r < 0:
                    raise ValueError(f"rate must be >= 0, got {r}")
        else:
            raise ValueError(f"unknown profile kind {self.kind!r}")
        return self

    # -- queries ---------------------------------------------------------
    @property
    def is_constant(self) -> bool:
        return self.kind == "constant"

    def as_constant(self) -> Optional[float]:
        """The constant rate this profile degenerates to, else None.

        An MMPP whose two states share one rate (`rate_a == rate_b`), or
        whose first dwell is infinite (it never leaves state A), IS a
        constant-rate process — thinning it would only burn rng draws and
        float error for the identical distribution. `synth_arrays` routes
        such profiles through the exact legacy generators, so the stream
        is byte-identical to `RateProfile.constant(rate)`
        (regression-tested)."""
        if self.kind == "constant":
            return self.args[0]
        if self.kind == "mmpp":
            ra, rb, da, _ = self.args
            if ra == rb or math.isinf(da):
                return ra
        return None

    def max_rate(self) -> float:
        if self.kind == "constant":
            return self.args[0]
        if self.kind in ("piecewise", "trace"):
            return max(r for _, r in self.knots)
        if self.kind == "diurnal":
            return self.args[1]
        if self.kind == "mmpp":
            return max(self.args[0], self.args[1])
        raise ValueError(f"unknown profile kind {self.kind!r}")

    def mean_rate(self) -> float:
        """Long-run mean of lambda(t) (label/reporting, not generation)."""
        if self.kind == "constant":
            return self.args[0]
        if self.kind == "piecewise":
            total = sum(d for d, _ in self.knots)
            return sum(d * r for d, r in self.knots) / total
        if self.kind == "diurnal":
            return 0.5 * (self.args[0] + self.args[1])
        if self.kind == "mmpp":
            ra, rb, da, db = self.args
            return (ra * da + rb * db) / (da + db)
        if self.kind == "trace":
            span = self.period_s if self.period_s > 0 else self.knots[-1][0]
            if span <= self.knots[0][0]:
                return self.knots[-1][1]
            ts = [t for t, _ in self.knots] + [span]
            return sum((t1 - t0) * r for t0, t1, (_, r) in
                       zip(ts, ts[1:], self.knots)) / (span - ts[0])
        raise ValueError(f"unknown profile kind {self.kind!r}")

    def rate_at(self, ts: np.ndarray) -> np.ndarray:
        """Vectorized lambda(t). MMPP profiles must be realized first
        (`profile_arrivals` does; calling this raises)."""
        ts = np.asarray(ts, np.float64)
        if self.kind == "constant":
            return np.full(ts.shape, self.args[0])
        if self.kind == "piecewise":
            durs = np.array([d for d, _ in self.knots])
            rates = np.array([r for _, r in self.knots])
            edges = np.cumsum(durs)
            tt = np.mod(ts, edges[-1])
            return rates[np.searchsorted(edges, tt, side="right")]
        if self.kind == "diurnal":
            trough, peak, peak_frac = self.args
            phase = ts / self.period_s - peak_frac
            return trough + (peak - trough) * 0.5 * (
                1.0 + np.cos(2.0 * np.pi * phase))
        if self.kind == "trace":
            tt = np.mod(ts, self.period_s) if self.period_s > 0 else ts
            t0 = np.array([t for t, _ in self.knots])
            rates = np.array([r for _, r in self.knots])
            idx = np.clip(np.searchsorted(t0, tt, side="right") - 1,
                          0, len(rates) - 1)
            return rates[idx]
        if self.kind == "mmpp":
            raise ValueError("mmpp profiles must be realized before "
                             "evaluation (profile_arrivals does this)")
        raise ValueError(f"unknown profile kind {self.kind!r}")

    def realize(self, seed: int, t_end: float) -> "RateProfile":
        """MMPP -> the equivalent piecewise profile covering [0, t_end):
        alternating exponential dwells drawn from a dedicated generator
        (`seed + MMPP_SEED_OFFSET`). Deterministic and prefix-stable: a
        longer t_end extends the same timeline. Other kinds return self."""
        if self.kind != "mmpp":
            return self
        ra, rb, da, db = self.args
        rng = np.random.default_rng(seed + MMPP_SEED_OFFSET)
        segs, t, state = [], 0.0, 0
        while t < t_end:
            dwell = float(rng.exponential(da if state == 0 else db))
            dwell = max(dwell, 1e-9)
            segs.append((dwell, ra if state == 0 else rb))
            t += dwell
            state ^= 1
        return RateProfile.piecewise(segs)


def profile_arrivals(rng: np.random.Generator, profile: RateProfile,
                     n: int, start: float = 0.0,
                     seed: int = 0) -> np.ndarray:
    """n arrival times from the non-homogeneous Poisson process lambda(t)
    by Lewis-Shedler thinning (see the module docstring for the frozen
    draw protocol). Constant profiles should take the legacy path in
    `synth_arrays` instead — calling this on one works but consumes a
    different rng pattern."""
    profile.validate()
    lam_max = profile.max_rate()
    if lam_max <= 0:
        raise ValueError("profile max rate is 0 — no arrivals can ever be "
                         "accepted (an all-zero profile means no traffic)")
    accepted: List[np.ndarray] = []
    got, t_last, blocks = 0, float(start), 0
    realized = profile
    while got < n:
        if blocks >= THINNING_MAX_BLOCKS:
            raise RuntimeError(
                f"thinning accepted only {got}/{n} arrivals after "
                f"{blocks} candidate blocks — the profile's rate mass is "
                f"(near-)zero over the generated span")
        gaps = rng.exponential(1.0 / lam_max, size=THINNING_BLOCK)
        ts = t_last + np.cumsum(gaps)
        us = rng.random(THINNING_BLOCK)
        if profile.kind == "mmpp":
            realized = profile.realize(seed, float(ts[-1]))
        keep = ts[us * lam_max < realized.rate_at(ts)]
        accepted.append(keep)
        got += len(keep)
        t_last = float(ts[-1])
        blocks += 1
    return np.concatenate(accepted)[:n]


# I/O shapes from the paper: chat 512:256 (headline), RAG 4096:1024,
# agentic 1024:4096 (§5.7).
IO_SHAPES = {
    "chat": (512, 256),
    "rag": (4096, 1024),
    "agentic": (1024, 4096),
}


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    lam: float                      # offered rate (req/s); with a non-
    #                                 constant profile this is the nominal
    #                                 label (records/seeds), lambda(t) rules
    n_requests: int
    io_shape: str = "chat"          # key of IO_SHAPES or "variable"
    process: str = "poisson"        # poisson | gamma
    cv: float = 1.0                 # gamma CV (paper probe: 2.0)
    seed: int = 0
    scale: float = 1.0              # token-length scale (CPU tier shrinks)
    shared_prefix_groups: int = 0   # >0 -> prefix-sharing workload (§5.7)
    # lambda(t): None = stationary (exact historical streams);
    # a constant profile routes through the legacy generators and is
    # byte-identical to profile=None at the same rate (tested).
    profile: Optional[RateProfile] = None
    # priority-class mix: per-class probabilities in class
    # order (interactive, batch, background, ...). Empty = every request
    # is interactive and NO class draws happen (historical streams and
    # their rng consumption stay byte-identical). Classes draw from a
    # dedicated generator at seed + CLASS_SEED_OFFSET.
    class_mix: Tuple[float, ...] = ()


def synth_arrays(spec: ArrivalSpec, start: float = 0.0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The request stream as struct-of-arrays: (arrival_times, prompt_lens,
    max_new_tokens) in rid order — length `spec.n_requests`, except that a
    zero-rate stationary spec yields empty arrays (no arrivals ever).

    This is the one place the stream's random draws happen (times first,
    then lengths, off a single generator), so `synth_requests` and the
    fleet simulator's array-native lanes consume bit-identical streams.
    Non-constant profiles draw times by thinning (module docstring
    protocol) off the same generator, then lengths exactly as before."""
    if spec.shared_prefix_groups:
        # §5.7 declares a prefix-sharing workload, but neither the sim
        # engine nor the step-time model gives shared prefixes a distinct
        # cost yet — running such a cell as plain chat would silently
        # mislabel the measurement (loud > silent).
        raise NotImplementedError(
            "shared_prefix_groups is declared (§5.7) but no execution "
            "tier models prefix sharing yet; set it to 0 — cells claiming "
            "a prefix-sharing workload must not silently run plain chat")
    rng = np.random.default_rng(spec.seed)
    prof = spec.profile
    const_rate = prof.as_constant() if prof is not None else None
    if prof is not None and const_rate is None:
        if spec.process != "poisson":
            raise ValueError(
                "non-constant rate profiles require process='poisson' "
                "(thinning is exact for Poisson streams only)")
        prof.validate()
        times = profile_arrivals(rng, prof, spec.n_requests, start,
                                 seed=spec.seed)
    else:
        lam = const_rate if prof is not None else spec.lam
        if spec.process == "gamma":
            times = gamma_arrivals(rng, lam, spec.cv, spec.n_requests, start)
        else:
            times = poisson_arrivals(rng, lam, spec.n_requests, start)

    n = len(times)
    if spec.io_shape == "variable":
        # §5.7 log-normal: input median ~400 (p10/p90 120/906),
        # output median ~200 (p10/p90 68/408). One vectorized draw per
        # stream, sampled in rid order (same values as a per-request loop
        # drawing p_in then p_out would need two interleaved calls, so the
        # stream layout here is its own stable protocol).
        p_ins = rng.lognormal(math.log(400), 0.63, size=n)
        p_outs = rng.lognormal(math.log(200), 0.70, size=n)
        p_ins = np.maximum(8, p_ins.astype(np.int64))
        p_outs = np.maximum(4, p_outs.astype(np.int64))
    else:
        p_in, p_out = IO_SHAPES[spec.io_shape]
        p_ins = np.full(n, p_in, np.int64)
        p_outs = np.full(n, p_out, np.int64)
    p_ins = np.maximum(4, (p_ins * spec.scale).astype(np.int64))
    p_outs = np.maximum(2, (p_outs * spec.scale).astype(np.int64))
    return times, p_ins, p_outs


def synth_classes(spec: ArrivalSpec, n: int) -> np.ndarray:
    """Per-request priority classes in rid order.

    Drawn from a DEDICATED generator (`spec.seed + CLASS_SEED_OFFSET`),
    never from the stream's generator — adding a class mix to a spec
    leaves its (times, lengths) stream byte-identical, and a spec
    without a mix draws nothing at all (all-interactive zeros)."""
    mix = spec.class_mix
    if not mix:
        return np.zeros(n, np.int64)
    if any(p < 0 for p in mix) or sum(mix) <= 0:
        raise ValueError(f"class_mix must be nonnegative with mass: {mix}")
    p = np.asarray(mix, np.float64)
    p = p / p.sum()
    rng = np.random.default_rng(spec.seed + CLASS_SEED_OFFSET)
    return rng.choice(len(p), size=n, p=p).astype(np.int64)


def synth_requests(spec: ArrivalSpec, start: float = 0.0) -> List[Request]:
    times, p_ins, p_outs = synth_arrays(spec, start)
    classes = synth_classes(spec, len(times))
    return [Request(rid=i, arrival_time=float(times[i]),
                    prompt_len=int(p_ins[i]), max_new_tokens=int(p_outs[i]),
                    priority=int(classes[i]))
            for i in range(len(times))]
