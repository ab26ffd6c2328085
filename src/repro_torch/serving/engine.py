"""Continuous-batching engine: FCFS admission + chunked prefill + paged KV.

The scheduling loop mirrors vLLM's continuous batching: every step admits
as many queued prompts as page capacity and the prefill token budget allow,
prefills them (recording TTFT), then decodes for the running slots. Time is
whatever the executor says it is — wall-clock (RealExecutor) or the TPU
model clock (SimExecutor) — so the same queueing dynamics produce both
measured and simulated C_eff(lambda) curves.

Two scheduler paths share identical semantics:

* **event-driven fast-forward** (`EngineConfig.fast_forward`, the default
  when the executor provides `decode_multi`): between scheduling events —
  next arrival while the queue is empty, next completion, next failure
  injection, horizon — the running batch composition is constant, so the
  engine advances the clock by the closed-form sum of the next `k` decode
  steps in one `decode_multi` call and updates all per-slot bookkeeping
  (tokens_out, context_lens, completion detection) with vectorized numpy
  ops. An arrival is *not* an event while the FCFS queue head is blocked
  on capacity: admission can only unblock at a completion or failure.
* **reference per-token loop** (`fast_forward=False`): one Python
  iteration per decode token, kept verbatim as the executable spec; the
  equivalence tests compare the two paths and the throughput benchmark
  uses it as the step-by-step baseline.

Equivalence guarantee: both paths take the same scheduling decisions in
the same order (admissions, prefills, completions, failure re-queues), so
RunRecord fields (tps, c_eff, ttft/tpot/e2e percentiles, mean_inflight)
agree to float-rounding tolerance. `RealExecutor` cannot predict wall
time, so its `decode_multi` falls back to per-step execution internally —
the fast path then degenerates to the reference loop with vectorized
bookkeeping, still semantically identical.

Fault handling: `fail_running()` simulates a replica/slot loss; affected
requests release pages and re-queue (bounded retries), matching the
straggler/failure story in DESIGN §5.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.kv_cache import PageManager
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.overload import OverloadPolicy
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.resilience import (FailureSpec, FailureTimeline,
                                      RetryPolicy, as_failure_events)
from repro_torch.tracing import span


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    page_size: int = 16
    num_pages: int = 1024
    max_pages_per_seq: int = 128
    prefill_token_budget: int = 2048    # chunked-prefill budget per step
    max_prefill_reqs: int = 8
    max_retries: int = 2
    fast_forward: bool = True           # event-driven clock; False = per-token
    #                                     reference loop (the baseline/oracle)
    # resilience knobs: zero = off, bit-identical to the engine without them
    max_queue_depth: int = 0            # >0: shed arrivals over this depth
    deadline_s: float = 0.0             # >0: queue-time deadline at admission
    # overload controller: None = no controller; a policy with
    # only ttft_slo_s set is a pure SLO monitor (violation counting)
    overload: Optional[OverloadPolicy] = None


class Engine:
    def __init__(self, cfg: EngineConfig, executor, metrics=None):
        self.cfg = cfg
        self.ex = executor
        self.pm = PageManager(cfg.num_pages, cfg.page_size, cfg.max_batch,
                              cfg.max_pages_per_seq)
        self.metrics = metrics or MetricsRegistry()
        self.t = 0.0
        self.slot_req: Dict[int, Request] = {}
        self.slot_tokens = np.zeros(cfg.max_batch, np.int32)
        self.context_lens = np.zeros(cfg.max_batch, np.int32)
        # per-slot mirrors of request bookkeeping (fast path works on these
        # and syncs back to Request objects at completion / run() exit)
        self.active = np.zeros(cfg.max_batch, bool)
        self.tokens_out_arr = np.zeros(cfg.max_batch, np.int64)
        self.max_new_arr = np.zeros(cfg.max_batch, np.int64)
        self._requeue: List[Request] = []
        # pre-bound latency histograms (reset() clears them in place)
        self._h_e2e = self.metrics.hist("repro:e2e_request_latency_seconds")
        self._h_ttft = self.metrics.hist(
            "repro:time_to_first_token_seconds")
        self._h_tpot = self.metrics.hist(
            "repro:time_per_output_token_seconds")
        # time-weighted in-flight integral for Little's-law checks
        self._inflight_area = 0.0
        self._last_t = 0.0
        # resilience state; all inert until a run enables them
        self._fail_rng = None               # persistent victim stream
        self._fail_stream = None            # FailureSpec event stream
        self._down_until = 0.0              # restart lag: no admission before
        self._retry: Optional[RetryPolicy] = None
        self._retry_rng = None
        self._retry_heap: List[Tuple[float, int, Request]] = []
        self._in_retry: set = set()         # rids parked awaiting re-submit
        # overload controller state: hysteretic state machine +
        # last observed TTFT. Both persist across run() re-entry AND the
        # warmup/measurement reset (a controller does not forget it is in
        # brownout because the meter rolled a window) — _last_ttft is a
        # duration, so clock resets cannot skew it.
        self._ovl_state = 0                 # overload.NORMAL
        self._last_ttft = 0.0
        # scheduler iterations, both paths (spans: `repro_torch.tracing`)
        self.n_iterations = 0

    # ------------------------------------------------------------------
    def _advance(self, dt: float):
        inflight = len(self.slot_req)
        self._inflight_area += inflight * dt
        self.t += dt
        self._last_t = self.t
        self.metrics.set("repro:time_seconds", self.t)
        self.metrics.set("repro:num_requests_running", inflight)

    def mean_inflight(self) -> float:
        return self._inflight_area / max(self.t, 1e-9)

    def reset_measurement(self):
        """Zero the virtual clock + metrics at a warmup/measurement boundary.

        Only valid when no request is mid-flight (warmup fully drained) —
        in-flight timestamps would otherwise straddle the reset."""
        self.t = 0.0
        self._inflight_area = 0.0
        self._last_t = 0.0
        self.metrics.reset()

    # ------------------------------------------------------------------
    def _complete(self, slot: int):
        req = self.slot_req.pop(slot)
        req.state = RequestState.DONE
        req.finish_time = self.t
        self.pm.release(slot)
        self.ex.reset_slot(slot)
        self.context_lens[slot] = 0
        self.active[slot] = False
        self.tokens_out_arr[slot] = 0
        self.max_new_arr[slot] = 0
        self.metrics.inc("repro:request_success_total")
        self._h_e2e.observe(req.e2e)
        if req.ttft is not None:
            self._h_ttft.observe(req.ttft)
        if req.tpot is not None:
            self._h_tpot.observe(req.tpot)

    def _sync_inflight_from_mirrors(self):
        """Fast-path only: push the slot mirrors' decode progress back
        onto the Request objects before an event that may terminate them
        (a killed-past-budget request keeps its `tokens_out` at death,
        and the reference loop keeps that field current per token)."""
        for slot, r in self.slot_req.items():
            r.tokens_out = int(self.tokens_out_arr[slot])

    def fail_running(self, frac: float = 1.0, rng=None):
        """Simulate replica loss: re-queue `frac` of running requests.

        With `rng=None` victims come from a persistent engine-owned stream
        seeded once per engine, so stacked failure events draw
        consecutively and two engines given the same schedule pick the
        same victims. `frac <= 0` loses nothing (an earlier version
        failed one request); `frac >= 1` loses every running slot."""
        if rng is None:
            if self._fail_rng is None:
                self._fail_rng = np.random.default_rng(0)
            rng = self._fail_rng
        slots = list(self.slot_req)
        if not slots or frac <= 0.0:
            n = 0
        elif frac >= 1.0:
            n = len(slots)
        else:
            n = max(1, int(len(slots) * frac))
        for slot in (rng.choice(slots, n, replace=False) if n else []):
            req = self.slot_req.pop(int(slot))
            self.pm.release(int(slot))
            self.ex.reset_slot(int(slot))
            self.context_lens[int(slot)] = 0
            self.active[int(slot)] = False
            self.tokens_out_arr[int(slot)] = 0
            self.max_new_arr[int(slot)] = 0
            req.slot = -1
            req.retries += 1
            self.metrics.inc("repro:request_preempted_total")
            if req.retries <= self.cfg.max_retries:
                req.state = RequestState.QUEUED
                req.prefill_done = 0
                req.tokens_out = 0
                req.first_token_time = None
                self._requeue.append(req)
            else:
                req.state = RequestState.FAILED
                self.metrics.inc("repro:request_failure_total")
                self._client_reject(req, self.t)

    # ---- client-side retry / shedding ----------------------
    def _client_reject(self, req: Request, base_t: float):
        """Client reaction to a shed/expired/failed request: re-submit
        with capped exponential backoff if the RetryPolicy allows, else
        abandon. `base_t` is the path-independent trigger time (arrival,
        deadline expiry, failure event) so both scheduler paths schedule
        bit-identical re-submission times."""
        pol = self._retry
        if pol is not None and pol.enabled and req.attempts < pol.max_attempts:
            req.attempts += 1
            if self._retry_rng is None:
                self._retry_rng = np.random.default_rng(pol.seed)
            at = base_t + pol.delay(req.attempts, self._retry_rng)
            req.state = RequestState.QUEUED
            req.slot = -1
            req.prefill_done = 0
            req.tokens_out = 0
            req.first_token_time = None
            req.retries = 0
            req.submit_time = at
            self._in_retry.add(req.rid)
            heapq.heappush(self._retry_heap, (at, req.rid, req))
            self.metrics.inc("repro:request_retry_total")
        else:
            req.state = RequestState.FAILED
            self.metrics.inc("repro:request_abandoned_total")

    def _accept(self, queue, req: Request):
        """Arrival-time admission control, one evaluation per drained
        submission (the deterministic point every scheduler path shares):
        the overload controller's state transition + class shedding
        first, then the class-blind max_queue_depth cap
       , then the brownout token-budget clamp on the admitted
        request. The depth reading is the queue length BEFORE this
        submission joins, same as the legacy cap's."""
        pol = self.cfg.overload
        if pol is not None and pol.enabled:
            self._ovl_state = pol.next_state(self._ovl_state, len(queue),
                                             self._last_ttft)
            if not pol.admits(self._ovl_state, req.priority):
                self.metrics.inc("repro:request_shed_total")
                self.metrics.inc("repro:request_class_shed_total")
                self._client_reject(req, req.submitted_at)
                return
        mqd = self.cfg.max_queue_depth
        if mqd > 0 and len(queue) >= mqd:
            self.metrics.inc("repro:request_shed_total")
            self._client_reject(req, req.submitted_at)
            return
        if pol is not None and pol.enabled:
            clamped = pol.clamp(self._ovl_state, req.max_new_tokens)
            if clamped < req.max_new_tokens:
                self.metrics.inc("repro:request_browned_total")
                self.metrics.inc("repro:browned_tokens_total",
                                 req.max_new_tokens - clamped)
                req.max_new_tokens = clamped
        queue.append(req)

    def _observe_ttfts(self, batch: List[Request]):
        """Post-prefill TTFT observation (both scheduler paths call this
        at the same clock instants, so controller inputs stay
        path-identical): count SLO violations whenever a policy declares
        an SLO — armed or monitor-only — and remember the last observed
        TTFT (batch admission order) for the brownout trigger."""
        pol = self.cfg.overload
        if pol is None:
            return
        slo = pol.ttft_slo_s
        for r in batch:
            ttft = self.t - r.arrival_time
            if slo > 0.0 and ttft > slo:
                self.metrics.inc("repro:request_slo_violation_total")
            self._last_ttft = ttft

    def _next_submit(self, pending, pi: int) -> Optional[float]:
        """Earliest future submission: next arrival or retry re-submit."""
        nxt = pending[pi].arrival_time if pi < len(pending) else None
        if self._retry_heap:
            h = self._retry_heap[0][0]
            nxt = h if nxt is None else min(nxt, h)
        return nxt

    def _drain_submissions(self, queue, pending, pi: int) -> int:
        """Move every due submission (arrival or retry re-submit) into the
        queue in global submission-time order (ties: arrivals first).
        Both scheduler paths process submissions at different clock
        granularities; merging by submission time keeps the FCFS order —
        and thereby shed decisions — identical between them."""
        heap = self._retry_heap
        n = len(pending)
        while True:
            pa = pending[pi].arrival_time if pi < n else None
            ha = heap[0][0] if heap else None
            if (pa is not None and pa <= self.t
                    and (ha is None or pa <= ha)):
                self._accept(queue, pending[pi])
                pi += 1
            elif ha is not None and ha <= self.t:
                _, _, req = heapq.heappop(heap)
                self._in_retry.discard(req.rid)
                self._accept(queue, req)
            else:
                return pi

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request], *,
            horizon: Optional[float] = None,
            failure_times: Sequence[float] = (),
            failure_spec: Optional[FailureSpec] = None,
            retry: Optional[RetryPolicy] = None) -> List[Request]:
        """Open-loop run; returns the request list with timings filled.

        Re-entrant: calling run() again with the same list (e.g. under a
        meter-tick horizon loop) resumes — requests already admitted or
        finished are not re-enqueued; a FailureSpec stream keeps its
        place across re-entry. `failure_times` accepts bare floats
        (legacy: lose half the running slots) or FailureEvents."""
        if retry is not None:
            self._retry = retry if retry.enabled else None
        if (failure_spec is not None and failure_spec.enabled
                and self._fail_stream is None):
            self._fail_stream = failure_spec.stream()
        timeline = FailureTimeline(as_failure_events(failure_times),
                                   self._fail_stream)
        if self.cfg.fast_forward and hasattr(self.ex, "decode_multi"):
            return self._run_fast(requests, horizon=horizon,
                                  timeline=timeline)
        return self._run_reference(requests, horizon=horizon,
                                   timeline=timeline)

    # ---- admission (shared helper) -----------------------------------
    def _admit_from(self, queue) -> List[Request]:
        batch: List[Request] = []
        budget = self.cfg.prefill_token_budget
        ddl = self.cfg.deadline_s
        while queue:
            if ddl > 0.0 and self.t - queue[0].submitted_at > ddl:
                # queue-time deadline: expired heads are popped (they no
                # longer block FCFS) and handed back to the client.
                # Tie semantics: strictly greater-than, so a
                # request whose wait EQUALS deadline_s is still served —
                # matching the arrival-draw protocol's closed-boundary
                # convention. All three scheduler paths (this helper is
                # shared by reference + fast-forward; the fleet mirrors
                # it in _admit_lane) pin the same choice; a regression
                # test exercises the exact-tie cell on each.
                req = (queue.popleft() if isinstance(queue, deque)
                       else queue.pop(0))
                self.metrics.inc("repro:request_timeout_total")
                self._client_reject(req, req.submitted_at + ddl)
                continue
            if not (len(batch) < self.cfg.max_prefill_reqs and
                    (queue[0].prompt_len <= budget or not batch) and
                    self.pm.can_admit(queue[0].prompt_len,
                                      queue[0].max_new_tokens)):
                break
            req = queue.popleft() if isinstance(queue, deque) else queue.pop(0)
            slot = self.pm.admit(req.prompt_len, req.max_new_tokens)
            req.slot = slot
            req.admitted_time = self.t
            req.state = RequestState.PREFILL
            self.slot_req[slot] = req
            batch.append(req)
            budget -= req.prompt_len
            self.metrics.set("repro:kv_cache_usage_perc",
                             self.pm.utilization())
        return batch

    def _prefill_tokens(self, batch: List[Request]) -> np.ndarray:
        """Materialise the padded token matrix (only if the executor reads
        token values; the sim tier meters counts and timing only)."""
        B = self.cfg.max_batch
        if not getattr(self.ex, "needs_tokens", True):
            return np.zeros((B, 0), np.int32)
        lp = -(-max(r.prompt_len for r in batch) // 64) * 64
        tokens = np.zeros((B, lp), np.int32)
        rng = np.random.default_rng(batch[0].rid)
        for r in batch:
            row = (np.asarray(r.prompt[:lp], np.int32)
                   if r.prompt else
                   rng.integers(0, 1000, r.prompt_len))
            tokens[r.slot, :r.prompt_len] = row[:r.prompt_len]
        return tokens

    # ---- fast path ----------------------------------------------------
    def _run_fast(self, requests: Sequence[Request], *,
                  horizon: Optional[float] = None,
                  timeline: Optional[FailureTimeline] = None) -> List[Request]:
        B = self.cfg.max_batch
        pending = sorted(
            (r for r in requests
             if r.state == RequestState.QUEUED and r.slot < 0
             and r.rid not in self._in_retry),
            key=lambda r: r.arrival_time)
        pi = 0                              # pending cursor (no pop(0))
        queue: Deque[Request] = deque()
        timeline = timeline or FailureTimeline(())
        next_ev = timeline.peek()
        ddl = self.cfg.deadline_s
        needs_tok = getattr(self.ex, "needs_tokens", True)

        # resync slot mirrors from request objects (re-entry / mode switch)
        self.active[:] = False
        self.tokens_out_arr[:] = 0
        self.max_new_arr[:] = 0
        for slot, r in self.slot_req.items():
            self.active[slot] = True
            self.tokens_out_arr[slot] = r.tokens_out
            self.max_new_arr[slot] = r.max_new_tokens

        while (pi < len(pending) or queue or self.slot_req or self._requeue
               or self._retry_heap):
            with span("engine.iteration"):
                self.n_iterations += 1
                if horizon is not None and self.t >= horizon:
                    break
                # failure injection
                if next_ev is not None and self.t >= next_ev.time:
                    self._sync_inflight_from_mirrors()
                    self.fail_running(next_ev.frac)
                    if next_ev.downtime > 0.0:
                        self._down_until = max(self._down_until,
                                               next_ev.time + next_ev.downtime)
                    timeline.pop()
                    next_ev = timeline.peek()
                # idle regime: batch and queue both empty — jump the
                # clock straight to the next submission (arrival or retry
                # re-submit) and admit it (plus any co-arrivals) in this same
                # wakeup, instead of burning a whole scheduler iteration on
                # the advance alone. The reference loop re-checks horizon and
                # failure injection at the top of its next iteration before
                # admitting, so replay those two checks here to keep the
                # event order identical.
                if not self.slot_req and not queue and not self._requeue:
                    nxt_sub = self._next_submit(pending, pi)
                    if nxt_sub is not None and nxt_sub > self.t:
                        self._advance(max(nxt_sub - self.t, 1e-6))
                        if horizon is not None and self.t >= horizon:
                            break
                        if next_ev is not None and self.t >= next_ev.time:
                            self._sync_inflight_from_mirrors()
                            self.fail_running(next_ev.frac)
                            if next_ev.downtime > 0.0:
                                self._down_until = max(
                                    self._down_until,
                                    next_ev.time + next_ev.downtime)
                            timeline.pop()
                            next_ev = timeline.peek()
                with span("engine.admit"):
                    # arrivals (client re-submissions are arrivals too)
                    pi = self._drain_submissions(queue, pending, pi)
                    if self._requeue:
                        queue.extendleft(reversed(self._requeue))
                        self._requeue = []

                    blocked = self.t < self._down_until   # restart/warmup lag
                    batch = [] if blocked else self._admit_from(queue)
                    if batch:
                        lens = np.zeros(B, np.int32)
                        mask = np.zeros(B, bool)
                        for r in batch:
                            lens[r.slot] = r.prompt_len
                            mask[r.slot] = True
                        tokens = self._prefill_tokens(batch)
                did_work = False
                if batch:
                    first, dt = self.ex.prefill(tokens, lens, mask,
                                                self.pm.block_tables)
                    with span("engine.bookkeep"):
                        self._advance(dt)
                        n_prompt = 0
                        for r in batch:
                            r.state = RequestState.RUNNING
                            r.tokens_out = 1
                            r.first_token_time = self.t
                            r.prev_token_time = self.t
                            self.slot_tokens[r.slot] = first[r.slot]
                            self.context_lens[r.slot] = r.prompt_len
                            self.active[r.slot] = True
                            self.tokens_out_arr[r.slot] = 1
                            self.max_new_arr[r.slot] = r.max_new_tokens
                            n_prompt += r.prompt_len
                        self.metrics.inc("repro:prompt_tokens_total", n_prompt)
                        self.metrics.inc("repro:generation_tokens_total",
                                         len(batch))
                        self._observe_ttfts(batch)
                        for r in batch:
                            if self.slot_tokens[r.slot] >= 0 and \
                                    r.tokens_out >= r.max_new_tokens:
                                self._complete(r.slot)
                    did_work = True

                # ---- decode: closed-form jump to the next scheduling event
                nrun = int(self.active.sum())
                if nrun:
                    if batch:
                        # composition just changed; take exactly one step (the
                        # reference loop decodes once per prefill iteration)
                        k_max, tbudget = 1, None
                    else:
                        rem = (self.max_new_arr[self.active] -
                               self.tokens_out_arr[self.active])
                        k_max = int(rem.min())
                        cands = []
                        if not queue:
                            # submissions only matter while nothing is queued:
                            # a blocked FCFS head keeps newcomers unadmittable
                            nxt_sub = self._next_submit(pending, pi)
                            if nxt_sub is not None:
                                cands.append(nxt_sub - self.t)
                        if next_ev is not None:
                            cands.append(next_ev.time - self.t)
                        if blocked and (queue or self._requeue):
                            cands.append(self._down_until - self.t)
                        if ddl > 0.0 and queue and not blocked:
                            # head expiry unblocks FCFS: it is an event
                            cands.append(queue[0].submitted_at + ddl - self.t)
                        if horizon is not None:
                            cands.append(horizon - self.t)
                        tbudget = min(cands) if cands else None
                    nxt, dt, steps = self.ex.decode_multi(
                        self.slot_tokens, self.active, self.pm.block_tables,
                        self.context_lens, k_max, tbudget)
                    with span("engine.bookkeep"):
                        self._advance(dt)
                        act = self.active
                        if needs_tok:
                            self.slot_tokens[act] = nxt[act]
                        self.tokens_out_arr[act] += steps
                        self.context_lens[act] += steps
                        self.metrics.inc("repro:generation_tokens_total",
                                         steps * nrun)
                        done_mask = act & (self.tokens_out_arr
                                           >= self.max_new_arr)
                        if done_mask.any():
                            for slot in np.flatnonzero(done_mask):
                                slot = int(slot)
                                r = self.slot_req[slot]
                                r.tokens_out = int(self.tokens_out_arr[slot])
                                r.prev_token_time = self.t
                                self._complete(slot)
                    did_work = True

                if not did_work:
                    cands = []
                    nxt_sub = self._next_submit(pending, pi)
                    if nxt_sub is not None:
                        cands.append(nxt_sub)
                    if blocked and (queue or self._requeue):
                        cands.append(self._down_until)
                    if ddl > 0.0 and queue and not blocked:
                        cands.append(queue[0].submitted_at + ddl)
                    if cands:
                        self._advance(max(min(cands) - self.t, 1e-6))
                    elif queue:
                        raise RuntimeError(
                            "scheduler stall: queued request cannot ever fit; "
                            "increase num_pages/max_pages_per_seq")
                    else:
                        break

        # sync slot mirrors back onto in-flight request objects so a
        # re-entrant run() (or the caller) sees consistent progress
        for slot, r in self.slot_req.items():
            r.tokens_out = int(self.tokens_out_arr[slot])
            r.prev_token_time = self.t
        return list(requests)

    # ---- reference path (the executable spec / benchmark baseline) ----
    def _run_reference(self, requests: Sequence[Request], *,
                       horizon: Optional[float] = None,
                       timeline: Optional[FailureTimeline] = None
                       ) -> List[Request]:
        pending = sorted(
            (r for r in requests
             if r.state == RequestState.QUEUED and r.slot < 0
             and r.rid not in self._in_retry),
            key=lambda r: r.arrival_time)
        pi = 0
        queue: List[Request] = []
        timeline = timeline or FailureTimeline(())
        next_ev = timeline.peek()
        ddl = self.cfg.deadline_s

        while (pi < len(pending) or queue or self.slot_req or self._requeue
               or self._retry_heap):
            with span("engine.iteration"):
                self.n_iterations += 1
                if horizon is not None and self.t >= horizon:
                    break
                # failure injection
                if next_ev is not None and self.t >= next_ev.time:
                    self.fail_running(next_ev.frac)
                    if next_ev.downtime > 0.0:
                        self._down_until = max(self._down_until,
                                               next_ev.time + next_ev.downtime)
                    timeline.pop()
                    next_ev = timeline.peek()
                with span("engine.admit"):
                    # arrivals (client re-submissions are arrivals too)
                    pi = self._drain_submissions(queue, pending, pi)
                    queue = self._requeue + queue
                    self._requeue = []

                    blocked = self.t < self._down_until   # restart/warmup lag
                    batch = [] if blocked else self._admit_from(queue)
                    if batch:
                        B = self.cfg.max_batch
                        tokens = self._prefill_tokens(batch)
                        lens = np.zeros(B, np.int32)
                        mask = np.zeros(B, bool)
                        for r in batch:
                            lens[r.slot] = r.prompt_len
                            mask[r.slot] = True
                did_work = False
                if batch:
                    first, dt = self.ex.prefill(tokens, lens, mask,
                                                self.pm.block_tables)
                    with span("engine.bookkeep"):
                        self._advance(dt)
                        for r in batch:
                            r.state = RequestState.RUNNING
                            r.tokens_out = 1
                            r.first_token_time = self.t
                            r.prev_token_time = self.t
                            self.slot_tokens[r.slot] = first[r.slot]
                            self.context_lens[r.slot] = r.prompt_len
                            self.metrics.inc("repro:prompt_tokens_total",
                                             r.prompt_len)
                            self.metrics.inc(
                                "repro:generation_tokens_total", 1)
                            if self.slot_tokens[r.slot] >= 0 and \
                                    r.tokens_out >= r.max_new_tokens:
                                self._complete(r.slot)
                        self._observe_ttfts(batch)
                    did_work = True

                # ---- decode step for all running slots
                running = [r for r in self.slot_req.values()
                           if r.state == RequestState.RUNNING]
                if running:
                    B = self.cfg.max_batch
                    active = np.zeros(B, bool)
                    for r in running:
                        active[r.slot] = True
                    try:
                        nxt, dt = self.ex.decode(
                            self.slot_tokens, active, self.pm.block_tables,
                            context_lens=self.context_lens)
                    except TypeError:
                        nxt, dt = self.ex.decode(self.slot_tokens, active,
                                                 self.pm.block_tables)
                    with span("engine.bookkeep"):
                        self._advance(dt)
                        ngen = 0
                        for r in running:
                            r.tokens_out += 1
                            ngen += 1
                            r.prev_token_time = self.t
                            self.slot_tokens[r.slot] = nxt[r.slot]
                            self.context_lens[r.slot] += 1
                            if r.tokens_out >= r.max_new_tokens:
                                self._complete(r.slot)
                        self.metrics.inc("repro:generation_tokens_total", ngen)
                    did_work = True

                if not did_work:
                    cands = []
                    nxt_sub = self._next_submit(pending, pi)
                    if nxt_sub is not None:
                        cands.append(nxt_sub)
                    if blocked and (queue or self._requeue):
                        cands.append(self._down_until)
                    if ddl > 0.0 and queue and not blocked:
                        cands.append(queue[0].submitted_at + ddl)
                    if cands:
                        self._advance(max(min(cands) - self.t, 1e-6))
                    elif queue:
                        # queued but cannot admit (capacity) and nothing
                        # running -> deadlock guard (shouldn't happen)
                        raise RuntimeError(
                            "scheduler stall: queued request cannot ever fit; "
                            "increase num_pages/max_pages_per_seq")
                    else:
                        break
        return list(requests)
