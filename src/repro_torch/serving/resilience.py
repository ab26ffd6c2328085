"""Failure, retry, and shedding primitives for the serving stack.

The paper's C_eff is only honest if it reflects what infrastructure
*delivers*: replicas crash and lose in-flight work, queued requests time
out, clients retry and thereby raise the offered load. This module holds
the deterministic specifications of those processes so the scalar engine,
the fleet backend, and the experiment grid all consume bit-identical
event streams.

* `FailureSpec` — an exponential crash/recovery process (MTTF/MTTR) with
  a partial-slot loss fraction. `FailureStream` lazily draws the events
  from one seeded generator so runs with unknown horizons (open-loop
  drains) stay deterministic: gap_i ~ Exp(mttf) measured from the last
  recovery, downtime_i ~ Exp(mttr); during downtime the engine admits
  nothing (restart/warmup lag).
* `RetryPolicy` — client-side capped exponential backoff with a retry
  budget and optional jitter. Re-submissions feed back into the arrival
  stream inside the engine loop, so retry amplification visibly raises
  offered lambda.
* `FailureEvent` / `as_failure_events` — normalisation of the legacy
  `failure_times=[t, ...]` replay (a bare float means "lose half the
  running slots at t", the original hardcoded behaviour).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One replica-loss event: at `time`, lose `frac` of running slots and
    admit nothing for `downtime` seconds (restart/warmup lag)."""
    time: float
    frac: float = 0.5
    downtime: float = 0.0


def as_failure_events(failure_times: Sequence[Union[float, FailureEvent]]
                      ) -> List[FailureEvent]:
    """Normalise the legacy float replay to events, keeping time order."""
    evs = [ft if isinstance(ft, FailureEvent) else FailureEvent(float(ft))
           for ft in failure_times]
    return sorted(evs, key=lambda e: e.time)


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """Exponential crash-recovery process. `mttf <= 0` disables it."""
    mttf: float = 0.0       # mean time to failure (s of engine clock)
    mttr: float = 0.0       # mean restart lag; 0 = instant recovery
    loss_frac: float = 0.5  # fraction of running slots lost per crash
    seed: int = 0

    @property
    def enabled(self) -> bool:
        return self.mttf > 0.0

    def availability(self) -> float:
        """Steady-state single-replica availability mttf/(mttf+mttr)."""
        if not self.enabled:
            return 1.0
        return self.mttf / (self.mttf + max(self.mttr, 0.0))

    def stream(self) -> "FailureStream":
        return FailureStream(self)


class FailureStream:
    """Deterministic lazy iterator over a FailureSpec's crash events.

    Draw order per event is fixed (gap, then downtime) so any consumer
    seeing the same spec sees the same stream; `peek()` materialises the
    next event without consuming it, which lets re-entrant engine runs
    keep their place."""

    def __init__(self, spec: FailureSpec):
        self.spec = spec
        self._rng = np.random.default_rng(spec.seed)
        self._clock = 0.0
        self._next: Optional[FailureEvent] = None

    def peek(self) -> Optional[FailureEvent]:
        if not self.spec.enabled:
            return None
        if self._next is None:
            gap = float(self._rng.exponential(self.spec.mttf))
            down = (float(self._rng.exponential(self.spec.mttr))
                    if self.spec.mttr > 0.0 else 0.0)
            self._clock += gap
            self._next = FailureEvent(self._clock, self.spec.loss_frac, down)
            self._clock += down      # next gap counts from recovery
        return self._next

    def pop(self) -> Optional[FailureEvent]:
        ev = self.peek()
        self._next = None
        return ev


class FailureTimeline:
    """Merged view of a legacy replay list and a FailureSpec stream.

    The engine asks `peek()` at the top of every scheduling iteration and
    `pop()` when it injects the event; both paths (per-token reference and
    event-driven fast-forward) therefore agree on event times exactly."""

    def __init__(self, legacy: Iterable[FailureEvent],
                 stream: Optional[FailureStream] = None):
        self._legacy = list(legacy)
        self._li = 0
        self._stream = stream

    def peek(self) -> Optional[FailureEvent]:
        lg = (self._legacy[self._li]
              if self._li < len(self._legacy) else None)
        sp = self._stream.peek() if self._stream is not None else None
        if lg is None:
            return sp
        if sp is None or lg.time <= sp.time:
            return lg
        return sp

    def pop(self) -> Optional[FailureEvent]:
        ev = self.peek()
        if ev is None:
            return None
        lg = (self._legacy[self._li]
              if self._li < len(self._legacy) else None)
        if lg is ev:
            self._li += 1
        else:
            self._stream.pop()
        return ev


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Client retry: capped exponential backoff with a retry budget.

    `max_attempts <= 0` disables it. The k-th re-submission (k = 1..budget)
    waits `min(base_delay_s * 2**(k-1), max_delay_s) + U(0, jitter_s)`
    after the rejection it reacts to; delays are measured from the
    *path-independent* trigger time (arrival, deadline expiry, failure
    event), never from the scheduler's bookkeeping clock, so the reference
    and fast-forward paths re-submit at bit-identical times."""
    max_attempts: int = 0
    base_delay_s: float = 0.5
    max_delay_s: float = 8.0
    jitter_s: float = 0.0
    seed: int = 0

    @property
    def enabled(self) -> bool:
        return self.max_attempts > 0

    def delay(self, attempt: int, rng=None) -> float:
        d = min(self.base_delay_s * (2.0 ** max(attempt - 1, 0)),
                self.max_delay_s)
        if self.jitter_s > 0.0 and rng is not None:
            d += self.jitter_s * float(rng.random())
        return d
