"""Overload survival: priority classes, brownout, hysteretic shedding.

Without it the engine has only *blind* admission control —
`max_queue_depth` sheds whoever arrives over the cap, interactive or
not. Real operators survive flash crowds with graceful degradation:
shed the background work first, clamp output-token budgets ("brownout")
before refusing anyone, and only hard-shed when both levers are
exhausted. This module is that controller, engine-agnostic and
deterministic.

Design constraints:

* **Pure functions of engine-observable state.** The controller never
  owns a clock or an RNG: `next_state` maps (state, queue depth, last
  observed TTFT) -> state, and `admits`/`clamp` are lookups. All three
  execution paths (per-token reference, event-driven fast-forward,
  fleet lanes) evaluate the controller at the same deterministic points
  — per drained submission in `Engine._accept` / the fleet's
  `_accept_lane` — on bit-identical inputs (queue contents and prefill
  times are already path-identical), so records stay bit-identical.
* **Hysteresis.** Entry thresholds (`brownout_depth`, `shed_depth`) and
  the exit threshold (`recover_depth`) form a band: a controller that
  entered BROWNOUT at depth 8 does not flap back at depth 7 — it waits
  for depth <= `recover_depth` (and a TTFT observation back under the
  SLO). Recovery steps DOWN one level per evaluation (SHED -> BROWNOUT
  -> NORMAL), never jumps.
* **Priority-ordered shedding.** Requests carry a priority class
  (interactive=0 < batch=1 < background=2; lower = more important). In
  BROWNOUT only classes >= `brownout_shed_floor` are refused (default:
  background only); in SHED, classes >= `shed_floor` (default: batch
  and background). Interactive traffic is only ever refused by the
  class-blind `max_queue_depth` hard cap, which stays the last line.
* **Brownout clamps, it does not refuse.** In BROWNOUT and SHED,
  admitted requests get `max_new_tokens` clamped to
  `brownout_max_new` — each clamped request frees decode budget and
  KV pages for the crowd. The clipped token count is metered
  (`repro:browned_tokens_total`) so the degradation is *priced*, not
  hidden.

The SLO knob (`ttft_slo_s`) is dual-use: it is the measurement SLO
(every served request whose TTFT exceeds it increments
`repro:request_slo_violation_total`, even under a monitor-only policy)
and, when the controller is armed, a brownout trigger (one observed
TTFT over the SLO enters BROWNOUT regardless of depth). A policy with
*only* `ttft_slo_s` set is a pure monitor: `enabled` is False, nothing
is shed or clamped, violations are counted — that is the
degradation-OFF arm of the flash-crowd experiment.
"""
from __future__ import annotations

import dataclasses

# priority classes (lower = more important; the default class is
# interactive so priority-free workloads are never shed by class rules)
INTERACTIVE = 0
BATCH = 1
BACKGROUND = 2

# controller states, ordered by severity
NORMAL = 0
BROWNOUT = 1
SHED = 2

STATE_NAMES = {NORMAL: "normal", BROWNOUT: "brownout", SHED: "shed"}


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Deterministic admission/degradation controller (frozen, picklable,
    hashable — rides SimEngineSpec/Cell like FailureSpec/RetryPolicy).

    All-zero fields are the inert policy: `enabled` is False and an
    engine configured with it behaves bit-identically to one with
    `overload=None` (the committed-store invariant)."""
    brownout_depth: int = 0       # queue depth that enters BROWNOUT (0=off)
    shed_depth: int = 0           # queue depth that enters SHED (0=off)
    recover_depth: int = 0        # depth at/below which state steps down
    ttft_slo_s: float = 0.0       # TTFT SLO: measurement + brownout trigger
    brownout_max_new: int = 0     # max_new_tokens clamp in BROWNOUT/SHED
    brownout_shed_floor: int = BACKGROUND   # classes >= floor refused in
    #                                         BROWNOUT (BACKGROUND+1 = none)
    shed_floor: int = BATCH       # classes >= floor refused in SHED

    @property
    def enabled(self) -> bool:
        """Armed iff any degradation lever exists. A policy with only
        `ttft_slo_s` set is a pure SLO monitor (violation counting
        without control) — the degradation-OFF experiment arm."""
        return (self.brownout_depth > 0 or self.shed_depth > 0
                or self.brownout_max_new > 0)

    def validate(self) -> "OverloadPolicy":
        if self.brownout_depth < 0 or self.shed_depth < 0 \
                or self.recover_depth < 0:
            raise ValueError("depth thresholds must be >= 0")
        if self.shed_depth > 0 and self.brownout_depth > 0 \
                and self.shed_depth < self.brownout_depth:
            raise ValueError(
                f"shed_depth {self.shed_depth} below brownout_depth "
                f"{self.brownout_depth}: SHED must be the deeper state")
        lo = min(d for d in (self.brownout_depth, self.shed_depth)
                 if d > 0) if self.enabled and (
                     self.brownout_depth > 0 or self.shed_depth > 0) else 0
        if lo and self.recover_depth >= lo:
            raise ValueError(
                f"recover_depth {self.recover_depth} must sit strictly "
                f"below the lowest entry threshold {lo} (hysteresis band)")
        if self.ttft_slo_s < 0:
            raise ValueError("ttft_slo_s must be >= 0")
        if self.brownout_max_new < 0:
            raise ValueError("brownout_max_new must be >= 0")
        return self

    # -- the state machine (pure) ---------------------------------------
    def next_state(self, state: int, depth: int, last_ttft: float) -> int:
        """One transition, evaluated per drained submission. `depth` is
        the queue length BEFORE the submission joins (the same reading
        `max_queue_depth` shedding uses); `last_ttft` is the most recent
        TTFT observed at a prefill (0.0 before any observation)."""
        ttft_hot = self.ttft_slo_s > 0.0 and last_ttft > self.ttft_slo_s
        if self.shed_depth > 0 and depth >= self.shed_depth:
            return SHED
        hot = (self.brownout_depth > 0 and depth >= self.brownout_depth) \
            or ttft_hot
        cool = depth <= self.recover_depth and not ttft_hot
        if state == SHED:
            return BROWNOUT if cool else SHED
        if state == BROWNOUT:
            return NORMAL if cool else BROWNOUT
        return BROWNOUT if hot else NORMAL

    def admits(self, state: int, priority: int) -> bool:
        """Class admission under the current state (the class-blind
        `max_queue_depth` cap is checked separately by the engine)."""
        if state == SHED:
            return priority < self.shed_floor
        if state == BROWNOUT:
            return priority < self.brownout_shed_floor
        return True

    def clamp(self, state: int, max_new_tokens: int) -> int:
        """Brownout token budget: admitted requests decode at most
        `brownout_max_new` tokens while the controller is degraded."""
        if state >= BROWNOUT and self.brownout_max_new > 0:
            return min(max_new_tokens, self.brownout_max_new)
        return max_new_tokens
