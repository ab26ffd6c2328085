"""Vectorized multi-cell fleet simulator.

One fleet = B independent experiment cells run as *lanes* of a single
struct-of-arrays event loop. The scalar engine (`serving.engine.Engine`
under `fast_forward=True`) pays one Python scheduler iteration per
scheduling event per cell; the fleet pays one Python iteration per event
*round* — every live lane advances through exactly one iteration of the
scalar state machine per round, with the per-iteration work (next-event
selection, the closed-form `decode_time_multi` clock jump, slot
bookkeeping, completion detection) computed across all lanes in batched
numpy ops on (B,) / (B, max_batch) / (B, n_requests) arrays. The
Python-interpreter cost of a scheduling event is thereby amortized over
the whole fleet instead of paid per cell.

Equivalence discipline (the fast-forward engine's contract, extended to
a third path):
every lane takes bit-for-bit the same scheduling decisions and clock
arithmetic as a scalar `run_point` on the same cell — not merely within
tolerance. Two mechanisms enforce this:

* `FleetStepModel` mirrors `StepTimeModel._decode_terms` /
  `decode_time` / `decode_time_multi` / `prefill_time` op-for-op in
  float64 numpy (same association order, same guards), so each lane's
  step durations are IEEE-identical to the scalar model's
  (`tests/test_fleet.py` asserts `==`, not `approx`). Any new roofline
  term added to `StepTimeModel` must be mirrored here — the bitwise
  test is the tripwire.
* `FleetEngine` replays `Engine._run_fast`'s event order exactly: the
  same iteration structure (horizon check, failure injection, idle
  jump with its horizon/failure replay, arrivals, FCFS admission under
  the chunked-prefill budget, one-step decode after a composition
  change, closed-form jump to the next event otherwise), the same
  `max(gap, 1e-6)` advances, the same per-lane clock accumulation
  order, and the same failure-injection RNG stream (slot ids evolve
  identically, so `default_rng(0).choice` picks the same victims).

Sequential-by-nature work (FCFS admission, free-list bookkeeping,
failure re-queues) stays per-lane Python but is O(#events) — identical
to the scalar path — while everything per-iteration is vectorized; the
speedup is the amortization of the loop body, not a change in what the
scheduler decides. RunRecords produced by `fleet_run_points` are
therefore byte-identical to `core.sweep.run_point`'s after store
consolidation, which is what lets `experiments.runner.execute_cells`
treat `backend="vector"` as a pure execution detail.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.arrivals import ArrivalSpec, synth_arrays, synth_classes

_HUGE = np.iinfo(np.int64).max // 4


@dataclasses.dataclass(frozen=True)
class FleetPoint:
    """One lane: everything `core.sweep.run_point` takes, flattened into a
    picklable record (the fleet analogue of an experiment `Cell`)."""
    engine: "SimEngineSpec"           # sim-tier engine coordinates
    arrivals: ArrivalSpec
    warmup: int = 0
    horizon: Optional[float] = None
    failure_times: Tuple[float, ...] = ()
    # RunRecord labels (run_point's **record_kw)
    config: str = ""
    model: str = ""
    hw: str = "cpu-node"
    n_chips: int = 1
    quant: str = "bf16"
    engine_kind: str = "sim"
    price_per_hr: float = 1.0
    # resilience / overload: lanes with a stochastic
    # failure process or client retries run through the scalar engine per
    # lane (fleet_run_points routes them) — the SoA loop's contiguous
    # queue cursors cannot express retry feedback, and per-lane fallback
    # keeps the RNG streams trivially identical to run_point's. Pure
    # admission lanes (max_queue_depth / deadline_s / OverloadPolicy,
    # no failures, no retries) run IN the fleet via an explicit per-lane
    # admission queue (`_accept_lane` / `_admit_lane_adm`).
    failure_spec: Optional["FailureSpec"] = None
    retry: Optional["RetryPolicy"] = None


# ---------------------------------------------------------------------------
# Vectorized step-time model
# ---------------------------------------------------------------------------


class FleetStepModel:
    """Struct-of-arrays mirror of `simulate.step_time.StepTimeModel`.

    Per-lane derived constants are precomputed with exactly the scalar
    model's expressions (association order preserved), and every method
    below mirrors its scalar counterpart op-for-op in float64, so lane i
    answers bitwise what `models[i]` would. All inputs/outputs are (B,)
    float64 arrays; integers are passed as exact float64 values.
    """

    def __init__(self, models: Sequence["StepTimeModel"]):
        f = lambda vals: np.asarray(vals, np.float64)        # noqa: E731
        self.nc = f([m.n_chips for m in models])
        self.fixed = f([m.fixed_overhead for m in models])
        self.is_moe = np.asarray([m.cfg.moe is not None for m in models])
        self.moe_oh = f([m.moe_dispatch_overhead for m in models])
        self.moe_ratio = f([(m.cfg.moe.top_k / m.cfg.moe.num_experts)
                            if m.cfg.moe is not None else 0.0
                            for m in models])
        self.wb = f([m.weight_bytes for m in models])
        # awb/wb with the scalar's own division (one rounding, reused)
        self.q_ratio = f([m.active_weight_bytes / m.weight_bytes
                          for m in models])
        self.kv = f([m._kv_bytes_tok for m in models])
        self.ap2 = f([2.0 * m._active_params for m in models])
        # denominators exactly as the scalar builds them each call:
        # (n_chips * peak) * mfu — association order matters for rounding
        self.cdenom = f([m.n_chips * m._peak_decode * m.mfu_decode
                         for m in models])
        self.pdenom = f([m.n_chips * m._peak * m.mfu for m in models])
        self.bwd = f([m.n_chips * m.hw.hbm_bw * m.mbu for m in models])
        self.ici_denom = f([m.n_chips * m.hw.ici_bw for m in models])
        self.ncm1 = f([m.n_chips - 1 for m in models])
        self.L2 = f([2 * m.cfg.num_layers for m in models])
        self.Lf = f([m.cfg.num_layers for m in models])
        self.dm = f([m.cfg.d_model for m in models])
        self.attn_coef = f([2 * 2 * m._n_attn * m.cfg.num_heads *
                            m.cfg.resolved_head_dim for m in models])

    # -- mirrors of StepTimeModel (op order preserved) -------------------
    def _collective(self, tokens: np.ndarray) -> np.ndarray:
        bytes_ar = (self.L2 * tokens * self.dm * 2.0 * 2.0 *
                    self.ncm1 / self.nc)
        out = bytes_ar / self.ici_denom
        return np.where(self.nc <= 1.0, 0.0, out)

    def _decode_terms(self, b: np.ndarray):
        compute = self.ap2 * b / self.cdenom
        inner = np.where(self.is_moe, b * self.moe_ratio, 1.0)
        touched = np.minimum(1.0, np.maximum(self.q_ratio, inner))
        mem_base = self.wb * touched / self.bwd
        mem_slope = b * self.kv / self.bwd
        moe_term = np.where(self.is_moe, self.moe_oh * b, 0.0)
        const = self._collective(b) + moe_term + self.fixed
        return compute, mem_base, mem_slope, const

    def decode_time(self, b: np.ndarray, ctx: np.ndarray) -> np.ndarray:
        compute, mem_base, mem_slope, const = self._decode_terms(b)
        dt = np.maximum(compute, mem_base + mem_slope * ctx) + const
        return np.where(b == 0.0, self.fixed, dt)

    def jump(self, terms, ctx0: np.ndarray, k: np.ndarray) -> np.ndarray:
        """k-step jump from cached `_decode_terms(b)` — the engine computes
        the terms once per round and reuses them across the initial jump,
        every bisection probe and the final duration. Valid for k >= 1;
        the k == 1 case needs no special-casing: with k = 1 the series
        formula reduces bit-for-bit to `1 * decode_time(b, ctx0)` (m
        clips to 0 or 1, leaving exactly `max(compute, mem0) + const`).
        Requires a caller-scoped errstate/seterr guard: lanes with
        slope == 0 divide by zero here and are overwritten by `flat`."""
        compute, mem_base, slope, const = terms
        mem0 = mem_base + slope * ctx0
        m = np.ceil((compute - mem0) / slope)
        m = np.minimum(np.maximum(m, 0.0), k)
        series = (k - m) * mem0 + slope * (m + k - 1.0) * (k - m) / 2.0
        out = m * compute + series + k * const
        if (slope <= 0.0).any():
            flat = k * (np.maximum(compute, mem0) + const)
            out = np.where(slope <= 0.0, flat, out)
        return out

    def decode_time_multi(self, b: np.ndarray, ctx0: np.ndarray,
                          k: np.ndarray) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            out = self.jump(self._decode_terms(b), ctx0, k)
        out = np.where(b == 0.0, k * self.fixed, out)
        return np.where(k <= 0.0, 0.0, out)

    def prefill_time(self, n_tok: np.ndarray, n_req: np.ndarray
                     ) -> np.ndarray:
        mean_len = n_tok / np.maximum(n_req, 1.0)
        flops = self.ap2 * n_tok
        flops = flops + self.attn_coef * n_tok * mean_len
        compute = flops / self.pdenom
        mem_bytes = self.wb + 2.0 * n_tok * self.dm * 2.0 * self.Lf
        memory = mem_bytes / self.bwd
        moe_term = np.where(self.is_moe, self.moe_oh * n_tok, 0.0)
        out = (np.maximum(compute, memory) + self._collective(n_tok) +
               moe_term + self.fixed)
        return np.where(n_tok == 0.0, 0.0, out)


# ---------------------------------------------------------------------------
# Struct-of-arrays engine
# ---------------------------------------------------------------------------


class FleetEngine:
    """B scalar fast-forward engines advanced in vectorized lockstep.

    Slot state lives in (B, S) arrays (S = the widest lane's max_batch);
    request streams in (B, N+1) arrays padded with +inf arrivals; the
    free-slot lists are array-backed stacks whose push/pop order matches
    the scalar PageManager's list exactly (so slot ids — and thereby the
    failure-injection RNG stream — are identical). Lanes with uniform
    request shapes (every grid cell: fixed io_shape) admit through a
    closed-form vectorized FCFS pass; variable-shape lanes, re-queue
    fronts and failure-tracked lanes fall back to a per-lane mirror of
    `Engine._admit_from`. Slot context is tracked as a per-lane running
    sum (ctx of a slot is always prompt_len + tokens_out - 1), which is
    all `SimExecutor.decode_multi`'s mean-context input needs."""

    def __init__(self, specs: Sequence["SimEngineSpec"]):
        from repro_torch.configs import get_config
        from repro_torch.simulate import HW_BY_NAME, StepTimeModel

        self.B = B = len(specs)
        self.specs = list(specs)
        models = []
        for s in specs:
            cfg = get_config(s.arch)
            models.append(StepTimeModel(cfg, HW_BY_NAME[s.hw],
                                        n_chips=s.n_chips, quant=s.quant))
        self.model = FleetStepModel(models)
        self.S = S = max(s.max_batch for s in specs)
        ivec = lambda key: np.asarray([key(s) for s in specs], np.int64)  # noqa: E731
        self.mb = ivec(lambda s: s.max_batch)
        self.page_size = ivec(lambda s: s.page_size)
        self.mpps = ivec(lambda s: s.max_pages_per_seq)
        self.pf_budget = ivec(lambda s: s.prefill_token_budget)
        self.max_pf_reqs = ivec(lambda s: s.max_prefill_reqs)
        # page 0 is reserved (PageManager trash page)
        self.num_pages = ivec(lambda s: s.num_pages)
        self.free_pages = self.num_pages - 1
        self.max_retries = np.full(B, 2, np.int64)   # EngineConfig default
        # admission control / overload: lanes with any of these
        # run their FCFS queue as an explicit per-lane rid list (the
        # contiguous [q_next, arrived) window cannot express sheds or
        # deadline pops); everything else keeps the windowed fast path
        self.mqd = ivec(lambda s: getattr(s, "max_queue_depth", 0))
        self.ddl = np.asarray(
            [float(getattr(s, "deadline_s", 0.0)) for s in specs])
        self.ovl = [getattr(s, "overload", None) for s in specs]
        self.ovl_enabled = np.asarray(
            [p is not None and p.enabled for p in self.ovl])
        self.has_pol = np.asarray([p is not None for p in self.ovl])
        self.any_pol = bool(self.has_pol.any())
        self.slo_s = np.asarray(
            [p.ttft_slo_s if p is not None else 0.0 for p in self.ovl])
        self.adm = self.ovl_enabled | (self.mqd > 0) | (self.ddl > 0.0)
        self.any_adm = bool(self.adm.any())
        self.adm_ddl = self.adm & (self.ddl > 0.0)
        self.any_adm_ddl = bool(self.adm_ddl.any())
        self.adm_queue: List[List[int]] = [[] for _ in range(B)]
        self.adm_qlen = np.zeros(B, np.int64)
        # controller state persists across phases AND the measurement
        # reset, exactly like the scalar engine's _ovl_state/_last_ttft
        self.ovl_state = np.zeros(B, np.int64)
        self.last_ttft = np.zeros(B)
        # outcome counters — the scalar engine's MetricsRegistry counters,
        # zeroed at the warmup/measurement boundary like metrics.reset()
        self.cnt_shed = np.zeros(B, np.int64)
        self.cnt_timeout = np.zeros(B, np.int64)
        self.cnt_abandoned = np.zeros(B, np.int64)
        self.cnt_class_shed = np.zeros(B, np.int64)
        self.cnt_browned = np.zeros(B, np.int64)
        self.cnt_browned_tokens = np.zeros(B, np.int64)
        self.cnt_slo_viol = np.zeros(B, np.int64)

        # lane clock + Little's-law integral
        self.t = np.zeros(B)
        self.area = np.zeros(B)
        self.n_occ = np.zeros(B, np.int64)
        self.ctx_sum = np.zeros(B, np.int64)
        # slot state (B, S); s_max is _HUGE on inactive slots so the
        # remaining-token min and the completion compare need no mask
        self.s_active = np.zeros((B, S), bool)
        self.s_out = np.zeros((B, S), np.int64)
        self.s_max = np.full((B, S), _HUGE, np.int64)
        self.s_rid = np.zeros((B, S), np.int64)
        self.s_need = np.zeros((B, S), np.int64)
        # free-slot stack: row i valid in [0, n_free[i]), top at the end —
        # push/pop order identical to the scalar free_slots list
        self.free_stack = np.zeros((B, S), np.int64)
        for i, m in enumerate(self.mb):
            self.free_stack[i, :m] = np.arange(int(m) - 1, -1, -1)
        self.n_free = self.mb.copy()
        # slot_req insertion order, kept only where failure injection can
        # read it (fail_running's rng.choice walks admission order)
        self.occ_order: List[Optional[Dict[int, None]]] = [None] * B
        # persistent per-lane victim streams, mirroring the scalar
        # engine's `_fail_rng` (seeded once, consecutive draws across
        # stacked failure events)
        self.fail_rngs: List[Optional[np.random.Generator]] = [None] * B
        self.requeue: List[List[int]] = [[] for _ in range(B)]
        self.n_requeue = np.zeros(B, np.int64)
        # scheduler instrumentation (bench surface)
        self.n_rounds = 0

    # -- phase loading ---------------------------------------------------
    def load_phase(self, streams: Sequence[Sequence[np.ndarray]],
                   horizons: Sequence[Optional[float]],
                   failure_times: Sequence[Sequence[float]]):
        """Install one request stream per lane ((times, p_ins, p_outs)
        from `synth_arrays`, optionally + classes from `synth_classes`);
        empty lanes (n=0) are born finished."""
        B = self.B
        self.n_req = np.asarray([len(s[0]) for s in streams], np.int64)
        N = int(self.n_req.max()) if B else 0
        self.r_arr = np.full((B, N + 1), np.inf)
        self.r_plen = np.zeros((B, N), np.int64)
        self.r_mnew = np.zeros((B, N), np.int64)
        self.r_first = np.full((B, N), np.nan)
        self.r_finish = np.full((B, N), np.nan)
        self.r_out = np.zeros((B, N), np.int64)
        self.r_retry = np.zeros((B, N), np.int64)
        self.times: List[np.ndarray] = []
        self.plen_l: List[List[int]] = []
        self.mnew_l: List[List[int]] = []
        self.cls_l: List[np.ndarray] = []
        self.uniform = np.zeros(B, bool)
        self.uplen = np.ones(B, np.int64)
        self.umn = np.ones(B, np.int64)
        for i, stream in enumerate(streams):
            times, p_ins, p_outs = stream[0], stream[1], stream[2]
            n = len(times)
            self.cls_l.append(np.asarray(stream[3], np.int64)
                              if len(stream) > 3 else np.zeros(n, np.int64))
            self.r_arr[i, :n] = times
            self.r_plen[i, :n] = p_ins
            self.r_mnew[i, :n] = p_outs
            self.times.append(np.asarray(times, np.float64))
            self.plen_l.append([int(v) for v in p_ins])
            self.mnew_l.append([int(v) for v in p_outs])
            if n and p_ins.min() == p_ins.max() and \
                    p_outs.min() == p_outs.max():
                self.uniform[i] = True
                self.uplen[i] = int(p_ins[0])
                self.umn[i] = int(p_outs[0])
        self.uneed = -(-(self.uplen + self.umn) // self.page_size)
        self.q_next = np.zeros(B, np.int64)
        self.arrived = np.zeros(B, np.int64)
        self.horizon = np.asarray(
            [np.inf if h is None else float(h) for h in horizons])
        self.fails: List[List[float]] = [sorted(ft) for ft in failure_times]
        self.fail_idx = [0] * B
        self.next_fail = np.asarray(
            [ft[0] if ft else np.inf for ft in self.fails])
        # track slot_req insertion order only on lanes that can fail;
        # uniform-shape untracked lanes take the vectorized admission path
        self.tracked = np.asarray([bool(ft) for ft in self.fails])
        for i in range(B):
            self.requeue[i] = []
            self.adm_queue[i] = []
            self.occ_order[i] = {} if self.tracked[i] else None
            if self.tracked[i] and self.n_occ[i]:
                raise RuntimeError("failure-tracked lane loaded with "
                                   "slots still occupied")
        self.n_requeue[:] = 0
        self.adm_qlen[:] = 0

    def reset_measurement(self):
        """Scalar `Engine.reset_measurement`: zero clocks + counters at
        the warmup/measurement boundary (engine state stays warm; the
        overload controller's ovl_state/last_ttft persist, exactly like
        the scalar engine's fields vs its metrics)."""
        self.t[:] = 0.0
        self.area[:] = 0.0
        self.cnt_shed[:] = 0
        self.cnt_timeout[:] = 0
        self.cnt_abandoned[:] = 0
        self.cnt_class_shed[:] = 0
        self.cnt_browned[:] = 0
        self.cnt_browned_tokens[:] = 0
        self.cnt_slo_viol[:] = 0

    # -- per-lane sequential helpers ------------------------------------
    def _pop_fail(self, i: int):
        self.fail_idx[i] += 1
        fl = self.fails[i]
        self.next_fail[i] = (fl[self.fail_idx[i]]
                             if self.fail_idx[i] < len(fl) else np.inf)

    def _fail_lane(self, i: int, frac: float):
        """Mirror of `Engine.fail_running(frac)` for one lane (persistent
        per-lane `default_rng(0)` stream, choice over slots in admission
        order, exact frac=0/1 handling — all matching the scalar)."""
        slots = list(self.occ_order[i])
        if not slots or frac <= 0.0:
            return
        n = len(slots) if frac >= 1.0 else max(1, int(len(slots) * frac))
        if self.fail_rngs[i] is None:
            self.fail_rngs[i] = np.random.default_rng(0)
        rng = self.fail_rngs[i]
        requeued: List[int] = []
        for slot in rng.choice(slots, n, replace=False):
            slot = int(slot)
            rid = int(self.s_rid[i, slot])
            self.free_pages[i] += self.s_need[i, slot]
            self.free_stack[i, self.n_free[i]] = slot
            self.n_free[i] += 1
            del self.occ_order[i][slot]
            self.ctx_sum[i] -= self.plen_l[i][rid] + self.s_out[i, slot] - 1
            self.s_active[i, slot] = False
            self.s_out[i, slot] = 0
            self.s_max[i, slot] = _HUGE
            self.s_need[i, slot] = 0
            self.n_occ[i] -= 1
            self.r_retry[i, rid] += 1
            if self.r_retry[i, rid] <= self.max_retries[i]:
                self.r_out[i, rid] = 0
                self.r_first[i, rid] = np.nan
                requeued.append(rid)
            else:
                # FAILED — finish stays NaN; with no client retry the
                # scalar _client_reject counts it abandoned
                self.cnt_abandoned[i] += 1
        # PREPEND this event's victims: the scalar loop front-merges
        # `_requeue` into the FCFS queue every iteration
        # (`queue.extendleft(reversed(...))`), so a later failure's
        # requeues go AHEAD of an earlier failure's still-queued leftovers
        self.requeue[i][:0] = requeued
        self.n_requeue[i] += len(requeued)

    def _accept_lane(self, i: int, rid: int):
        """Mirror of `Engine._accept` for one drained arrival on an
        admission lane: overload state transition + class shed first,
        then the class-blind max_queue_depth cap, then the brownout
        clamp on the admitted request. The depth reading is the queue
        length BEFORE this arrival joins (scalar semantics). Fleet lanes
        never carry a RetryPolicy (`_needs_scalar`), so every rejection
        is a client abandonment."""
        pol = self.ovl[i]
        q = self.adm_queue[i]
        if pol is not None and pol.enabled:
            st = pol.next_state(int(self.ovl_state[i]), len(q),
                                float(self.last_ttft[i]))
            self.ovl_state[i] = st
            if not pol.admits(st, int(self.cls_l[i][rid])):
                self.cnt_shed[i] += 1
                self.cnt_class_shed[i] += 1
                self.cnt_abandoned[i] += 1
                return
        mqd = int(self.mqd[i])
        if mqd > 0 and len(q) >= mqd:
            self.cnt_shed[i] += 1
            self.cnt_abandoned[i] += 1
            return
        if pol is not None and pol.enabled:
            mnew = self.mnew_l[i][rid]
            clamped = pol.clamp(int(self.ovl_state[i]), mnew)
            if clamped < mnew:
                self.cnt_browned[i] += 1
                self.cnt_browned_tokens[i] += mnew - clamped
                self.mnew_l[i][rid] = clamped
                self.r_mnew[i, rid] = clamped
        q.append(rid)
        self.adm_qlen[i] += 1

    def _observe_lane(self, i: int, rids: Sequence[int]):
        """Mirror of `Engine._observe_ttfts` for one lane's prefilled
        batch (admission order, last writer wins)."""
        ttft = self.t[i] - self.times[i][np.asarray(rids, np.int64)]
        slo = float(self.slo_s[i])
        if slo > 0.0:
            self.cnt_slo_viol[i] += int((ttft > slo).sum())
        self.last_ttft[i] = float(ttft[-1])

    def _admit_lane_adm(self, i: int):
        """Mirror of `Engine._admit_from` over the explicit admission
        queue: deadline-expired heads pop unbounded (timeout + abandon —
        strictly greater-than, a wait equal to deadline_s is served; the
        pinned tie choice), interleaved with FCFS admission under the
        chunked-prefill budget. Called whenever the queue is non-empty —
        even when nothing can admit — because the scalar path pops
        expired heads on every iteration regardless of capacity."""
        budget = int(self.pf_budget[i])
        nmax = int(self.max_pf_reqs[i])
        ps = int(self.page_size[i])
        mpps = int(self.mpps[i])
        plen_l, mnew_l = self.plen_l[i], self.mnew_l[i]
        q = self.adm_queue[i]
        times = self.times[i]
        ddl = float(self.ddl[i])
        t = float(self.t[i])
        free_pages = int(self.free_pages[i])
        n_free = int(self.n_free[i])
        slots: List[int] = []
        rids: List[int] = []
        plens: List[int] = []
        mnews: List[int] = []
        n_tok = 0
        while q:
            rid = q[0]
            if ddl > 0.0 and t - times[rid] > ddl:
                q.pop(0)
                self.adm_qlen[i] -= 1
                self.cnt_timeout[i] += 1
                self.cnt_abandoned[i] += 1
                continue
            plen, mnew = plen_l[rid], mnew_l[rid]
            if not (len(slots) < nmax and (plen <= budget or not slots)):
                break
            need = -(-(plen + mnew) // ps)
            if need > mpps or not n_free or free_pages < need:
                break
            q.pop(0)
            self.adm_qlen[i] -= 1
            n_free -= 1
            slot = int(self.free_stack[i, n_free])
            slots.append(slot)
            rids.append(rid)
            plens.append(plen)
            mnews.append(mnew)
            free_pages -= need
            n_tok += plen
            budget -= plen
        if slots:
            self.s_rid[i, slots] = rids
            self.s_need[i, slots] = [
                -(-(p + m) // ps) for p, m in zip(plens, mnews)]
            self.s_max[i, slots] = mnews
            self.free_pages[i] = free_pages
            self.n_free[i] = n_free
            self.n_occ[i] += len(slots)
        return slots, rids, plens, mnews, n_tok

    def _admit_lane(self, i: int):
        """Mirror of `Engine._admit_from` for one lane: FCFS admission
        under the chunked-prefill budget (the general path — re-queue
        fronts, variable shapes, failure-tracked lanes). Returns (slots,
        rids, plens, mnews, n_tok)."""
        budget = int(self.pf_budget[i])
        nmax = int(self.max_pf_reqs[i])
        ps = int(self.page_size[i])
        mpps = int(self.mpps[i])
        plen_l, mnew_l = self.plen_l[i], self.mnew_l[i]
        occ = self.occ_order[i]
        rq = self.requeue[i]
        free_pages = int(self.free_pages[i])
        n_free = int(self.n_free[i])
        q_next = int(self.q_next[i])
        arrived = int(self.arrived[i])
        slots: List[int] = []
        rids: List[int] = []
        plens: List[int] = []
        mnews: List[int] = []
        n_tok = 0
        while len(slots) < nmax:
            if rq:
                rid = rq[0]
                from_rq = True
            elif q_next < arrived:
                rid = q_next
                from_rq = False
            else:
                break
            plen, mnew = plen_l[rid], mnew_l[rid]
            if not (plen <= budget or not slots):
                break
            need = -(-(plen + mnew) // ps)
            if need > mpps or not n_free or free_pages < need:
                break
            if from_rq:
                rq.pop(0)
                self.n_requeue[i] -= 1
            else:
                q_next += 1
            n_free -= 1
            slot = int(self.free_stack[i, n_free])
            if occ is not None:
                occ[slot] = None
            slots.append(slot)
            rids.append(rid)
            plens.append(plen)
            mnews.append(mnew)
            free_pages -= need
            n_tok += plen
            budget -= plen
        if slots:
            self.s_rid[i, slots] = rids
            self.s_need[i, slots] = [
                -(-(p + m) // ps) for p, m in zip(plens, mnews)]
            self.s_max[i, slots] = mnews
            self.free_pages[i] = free_pages
            self.n_free[i] = n_free
            self.q_next[i] = q_next
            self.n_occ[i] += len(slots)
        return slots, rids, plens, mnews, n_tok

    # -- the vectorized event loop ---------------------------------------
    def run_phase(self, on_lane_dead=None):
        """Advance every lane to completion. `on_lane_dead(i)` fires the
        moment lane i leaves the event loop (drained, horizon) — its
        request arrays are final from that point, which is what lets the
        vector backend stream per-cell results into the resumable store
        instead of checkpointing whole chunks."""
        B = self.B
        lanes = np.arange(B)
        live = np.ones(B, bool)
        self._run_phase_inner(B, lanes, live, self.model, on_lane_dead)

    def _run_phase_inner(self, B, lanes, live, model, on_lane_dead):
        any_tracked = bool(self.tracked.any())
        has_horizon = bool(np.isfinite(self.horizon).any())
        reported = np.zeros(B, bool)
        while True:
            # loop condition (top of the scalar while): anything left?
            live &= ((self.arrived < self.n_req)
                     | (self.q_next < self.arrived)
                     | (self.n_requeue > 0) | (self.n_occ > 0)
                     | (self.adm_qlen > 0))
            if on_lane_dead is not None:
                fresh = ~live & ~reported
                if fresh.any():
                    reported |= fresh
                    for i in np.flatnonzero(fresh):
                        on_lane_dead(int(i))
            if not live.any():
                break
            self.n_rounds += 1
            alive = live.copy()
            # 1. horizon
            if has_horizon:
                hb = alive & (self.t >= self.horizon)
                if hb.any():
                    live &= ~hb
                    alive &= ~hb
            # 2. failure injection
            if any_tracked:
                due = alive & (self.t >= self.next_fail)
                for i in np.flatnonzero(due):
                    self._fail_lane(int(i), 0.5)
                    self._pop_fail(int(i))
            # 3. idle regime: batch+queue empty -> jump to next arrival,
            #    replaying the horizon/failure checks (scalar order)
            next_arr = self.r_arr[lanes, self.arrived]
            maybe_idle = alive & (self.n_occ == 0)
            if maybe_idle.any():
                idle = (maybe_idle & (self.q_next == self.arrived)
                        & (self.n_requeue == 0) & (self.adm_qlen == 0)
                        & (self.arrived < self.n_req)
                        & (next_arr > self.t))
                if idle.any():
                    gap = np.maximum(next_arr - self.t, 1e-6)
                    self.t[idle] += gap[idle]   # inflight == 0: area += 0
                    if has_horizon:
                        hb = idle & (self.t >= self.horizon)
                        if hb.any():
                            live &= ~hb
                            alive &= ~hb
                    if any_tracked:
                        due = idle & alive & (self.t >= self.next_fail)
                        for i in np.flatnonzero(due):
                            self._fail_lane(int(i), 0.5)
                            self._pop_fail(int(i))
            # 4. arrivals: advance the arrived cursor past times <= t;
            #    admission lanes drain each arrival through _accept_lane
            #    (shed / clamp / enqueue) and keep q_next == arrived so
            #    the contiguous-window paths see an empty window
            move = alive & (next_arr <= self.t)
            if move.any():
                for i in np.flatnonzero(move):
                    i = int(i)
                    na = int(np.searchsorted(
                        self.times[i], self.t[i], side="right"))
                    if self.adm[i]:
                        for rid in range(int(self.arrived[i]), na):
                            self._accept_lane(i, rid)
                        self.q_next[i] = na
                    self.arrived[i] = na
            # 5+6. admission + prefill
            had_batch, pf_li, pf_ri = self._admit_and_prefill(B, lanes,
                                                              alive,
                                                              any_tracked)
            # 7. decode: closed-form jump to each lane's next event
            dec = alive & (self.n_occ > 0)
            if dec.any():
                self._decode(B, lanes, dec, had_batch, model, any_tracked,
                             has_horizon)
            # 8. no work: advance to the next arrival (or queued-head
            #    deadline expiry on admission lanes) / stall / finished
            nw = alive & ~had_batch & ~dec
            if nw.any():
                tgt = self.r_arr[lanes, self.arrived]
                if self.any_adm_ddl:
                    tgt = tgt.copy()
                    for i in np.flatnonzero(nw & self.adm_ddl
                                            & (self.adm_qlen > 0)):
                        i = int(i)
                        exp = (self.times[i][self.adm_queue[i][0]]
                               + self.ddl[i])
                        if exp < tgt[i]:
                            tgt[i] = exp
                pend = nw & np.isfinite(tgt)
                if pend.any():
                    gap = np.maximum(tgt - self.t, 1e-6)
                    self.t[pend] += gap[pend]
                stall = nw & ~pend & ((self.q_next < self.arrived)
                                      | (self.n_requeue > 0)
                                      | (self.adm_qlen > 0))
                if stall.any():
                    raise RuntimeError(
                        "scheduler stall: queued request cannot ever fit; "
                        "increase num_pages/max_pages_per_seq "
                        f"(lanes {np.flatnonzero(stall).tolist()})")
                live &= ~(nw & ~pend)

    # -- admission + prefill (one round) ---------------------------------
    def _admit_and_prefill(self, B, lanes, alive, any_tracked):
        qc = np.minimum(self.q_next, self.n_req - 1)
        head_tok = self.r_plen[lanes, qc] + self.r_mnew[lanes, qc]
        need = -(-head_tok // self.page_size)
        has_rq = self.n_requeue > 0
        can = (alive & ((self.q_next < self.arrived) | has_rq)
               & (self.n_occ < self.mb) & (self.max_pf_reqs > 0))
        # contiguous-queue head admissibility, vectorized; lanes with a
        # re-queue front fall back to the per-lane loop's own checks
        can &= (has_rq | ((need <= self.mpps) & (self.free_pages >= need)))
        # admission lanes (explicit queue) always take their own per-lane
        # path while the queue is non-empty — even when nothing can admit,
        # because the scalar _admit_from pops deadline-expired heads on
        # every iteration regardless of capacity
        slow_adm = (alive & self.adm & (self.adm_qlen > 0)) \
            if self.any_adm else np.zeros(B, bool)
        had_batch = np.zeros(B, bool)
        if not can.any() and not slow_adm.any():
            return had_batch, None, None
        # fast path: uniform request shape, no re-queue front, untracked —
        # the FCFS admission count is closed-form per lane
        fast = can & self.uniform & ~has_rq
        if any_tracked:
            fast &= ~self.tracked
        slow = can & ~fast
        n_tok = np.zeros(B, np.int64)
        li = ri = None
        if fast.any():
            n = np.maximum(self.pf_budget // self.uplen, 1)
            n = np.minimum(n, self.max_pf_reqs)
            n = np.minimum(n, self.arrived - self.q_next)
            n = np.minimum(n, self.free_pages // self.uneed)
            n = np.minimum(n, self.n_free)
            n_adm = np.where(fast, n, 0)
            fl = np.flatnonzero(n_adm)
            cnt = n_adm[fl]
            total = int(cnt.sum())
            li = np.repeat(fl, cnt)
            ends = np.cumsum(cnt)
            within = np.arange(total) - np.repeat(ends - cnt, cnt)
            si = self.free_stack[li, self.n_free[li] - 1 - within]
            ri = np.repeat(self.q_next[fl], cnt) + within
            self.n_free[fl] -= cnt
            self.q_next[fl] += cnt
            self.free_pages[fl] -= cnt * self.uneed[fl]
            self.n_occ[fl] += cnt
            self.s_rid[li, si] = ri
            self.s_need[li, si] = self.uneed[li]
            self.s_max[li, si] = self.umn[li]
            self.s_out[li, si] = 1
            self.s_active[li, si] = True
            n_tok[fl] = cnt * self.uplen[fl]
            had_batch[fl] = True
        slow_items = []
        if slow.any():
            for i in np.flatnonzero(slow):
                i = int(i)
                slots, rids, plens, mnews, toks = self._admit_lane(i)
                if slots:
                    slow_items.append((i, slots, rids, mnews))
                    had_batch[i] = True
                    n_tok[i] = toks
                    self.s_out[i, slots] = 1
                    self.s_active[i, slots] = True
        if slow_adm.any():
            for i in np.flatnonzero(slow_adm):
                i = int(i)
                slots, rids, plens, mnews, toks = self._admit_lane_adm(i)
                if slots:
                    slow_items.append((i, slots, rids, mnews))
                    had_batch[i] = True
                    n_tok[i] = toks
                    self.s_out[i, slots] = 1
                    self.s_active[i, slots] = True
        if not had_batch.any():
            return had_batch, None, None
        # number of admitted requests per lane this round
        n_breq = np.zeros(B, np.int64)
        if li is not None:
            np.add.at(n_breq, li, 1)
        for i, slots, _, _ in slow_items:
            n_breq[i] = len(slots)
        dt = self.model.prefill_time(n_tok.astype(np.float64),
                                     n_breq.astype(np.float64))
        pb = had_batch
        self.t[pb] += dt[pb]
        self.area[pb] += self.n_occ[pb] * dt[pb]
        self.ctx_sum[pb] += n_tok[pb]
        if li is not None:
            self.r_first[li, ri] = self.t[li]
            self.r_out[li, ri] = 1
        for i, slots, rids, mnews in slow_items:
            self.r_first[i, rids] = self.t[i]
            self.r_out[i, rids] = 1
        # post-prefill TTFT observation (scalar _observe_ttfts): SLO
        # violation counting + last-TTFT brownout input, batch order
        if self.any_pol:
            if li is not None and self.has_pol[li].any():
                for i in np.flatnonzero(fast & had_batch & self.has_pol):
                    i = int(i)
                    self._observe_lane(i, ri[li == i])
            for i, slots, rids, mnews in slow_items:
                if self.has_pol[i]:
                    self._observe_lane(int(i), rids)
        # prefill-time completion (max_new <= 1): scalar post-prefill
        # check, processed in admission order (free-stack push order
        # must match the scalar batch walk)
        pf_watch = [(i, slots, mnews) for i, slots, _, mnews in slow_items
                    if min(mnews) <= 1]
        if li is not None and (self.umn[had_batch] <= 1).any():
            for i in np.flatnonzero(fast & had_batch & (self.umn <= 1)):
                sl = si[li == i]
                pf_watch.append((int(i), sl.tolist(),
                                 [int(self.umn[i])] * len(sl)))
        for i, slots, mnews in pf_watch:
            pf_done = [s for s, m in zip(slots, mnews) if m <= 1]
            if not pf_done:
                continue
            rd = self.s_rid[i, pf_done]
            self.r_out[i, rd] = self.s_out[i, pf_done]
            self.r_finish[i, rd] = self.t[i]
            self._complete_slots(int(i), pf_done)
        return had_batch, li, ri

    def _complete_slots(self, i: int, slots: Sequence[int]):
        """Per-lane completion (prefill-time finishes; the decode path
        uses the flat vectorized pass)."""
        sl = list(slots)
        self.free_pages[i] += int(self.s_need[i, sl].sum())
        nf = int(self.n_free[i])
        self.free_stack[i, nf:nf + len(sl)] = sl
        self.n_free[i] = nf + len(sl)
        if self.occ_order[i] is not None:
            occ = self.occ_order[i]
            for s in sl:
                del occ[s]
        for s in sl:
            self.ctx_sum[i] -= (self.plen_l[i][int(self.s_rid[i, s])]
                                + self.s_out[i, s] - 1)
        self.s_active[i, sl] = False
        self.s_out[i, sl] = 0
        self.s_max[i, sl] = _HUGE
        self.s_need[i, sl] = 0
        self.n_occ[i] -= len(sl)

    # -- decode (one round) ----------------------------------------------
    def _decode(self, B, lanes, dec, had_batch, model, any_tracked,
                has_horizon):
        rem = (self.s_max - self.s_out).min(axis=1)
        k = np.maximum(np.where(had_batch, 1, np.minimum(rem, _HUGE)), 1)
        # time budget = nearest future event (inf when none): arrivals
        # only count while the FCFS queue is empty
        q_empty = ((self.q_next == self.arrived) & (self.n_requeue == 0)
                   & (self.adm_qlen == 0))
        next_arr = self.r_arr[lanes, self.arrived]
        cand = np.where(q_empty & (self.arrived < self.n_req),
                        next_arr - self.t, np.inf)
        if any_tracked:
            cand = np.minimum(cand, self.next_fail - self.t, out=cand)
        if has_horizon:
            cand = np.minimum(cand, self.horizon - self.t, out=cand)
        if self.any_adm_ddl:
            # queued-head deadline expiry unblocks FCFS: it is an event
            for i in np.flatnonzero(dec & self.adm_ddl
                                    & (self.adm_qlen > 0)):
                i = int(i)
                exp = (self.times[i][self.adm_queue[i][0]] + self.ddl[i]
                       - self.t[i])
                if exp < cand[i]:
                    cand[i] = exp
        # b floored to 1 on frozen/empty lanes: their values are masked
        # out below, and a nonzero b keeps slope > 0 (no flat branch).
        # errstate is scoped to the model math only — user callbacks
        # (store writes, progress hooks) must keep their normal fp state
        with np.errstate(divide="ignore", invalid="ignore"):
            n_eff = np.maximum(self.n_occ, 1)
            b = n_eff.astype(np.float64)
            ctx0 = self.ctx_sum / n_eff
            terms = model._decode_terms(b)
            kf = k.astype(np.float64)
            dtd = model.jump(terms, ctx0, kf)
            bis = dec & (k > 1) & (dtd >= cand)
            if bis.any():
                k, dtd = self._event_budget_k(model, terms, ctx0, cand, k,
                                              dtd, bis)
        self.t[dec] += dtd[dec]
        self.area[dec] += self.n_occ[dec] * dtd[dec]
        kk = np.where(dec, k, 0)
        self._apply_decode(B, dec, kk)

    def _event_budget_k(self, model, terms, ctx0, cand, k, dtd, bis):
        """Smallest k' in [1, k] with S(k') >= budget, for lanes whose
        decode burst is cut short by a nearer event (arrival / failure /
        horizon). A closed-form inversion of the k-step series — linear
        while compute-bound, quadratic once the growing KV read crosses
        the roofline — gives a candidate; a <=2-eval minimality check
        (S(k') >= budget, S(k'-1) < budget) confirms it as exactly the
        answer `SimExecutor.decode_multi`'s bisection returns (S is
        strictly increasing, so the minimal k' is unique), and rare
        float-edge stragglers fall back to true bisection."""
        idx = np.flatnonzero(bis)
        tsub = tuple(tt[idx] for tt in terms)
        compute, mem_base, slope, const = tsub
        c0 = ctx0[idx]
        bud = cand[idx]
        kmax = k[idx]
        kmaxf = kmax.astype(np.float64)
        mem0 = mem_base + slope * c0
        flat_step = np.maximum(compute, mem0) + const
        m_full = np.maximum(np.ceil((compute - mem0) / slope), 0.0)
        lin_k = np.ceil(bud / (compute + const))
        a = slope / 2.0
        bq = mem0 + const - a
        cq = m_full * compute - m_full * mem0 + a * (m_full -
                                                     m_full * m_full)
        disc = bq * bq - 4.0 * a * (cq - bud)
        root = (-bq + np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a)
        kc = np.where(lin_k <= m_full, lin_k,
                      np.maximum(np.ceil(root), m_full + 1.0))
        kc = np.where(slope <= 0.0, np.ceil(bud / flat_step), kc)
        kc = np.minimum(np.maximum(kc, 1.0), kmaxf).astype(np.int64)
        sk = model.jump(tsub, c0, kc.astype(np.float64))
        good = np.zeros(len(idx), bool)
        for _ in range(3):
            ge = sk >= bud
            skm1 = model.jump(tsub, c0,
                              np.maximum(kc - 1, 1).astype(np.float64))
            good = ge & ((kc <= 1) | (skm1 < bud))
            if good.all():
                break
            kc = np.where(ge, np.where(good, kc, kc - 1), kc + 1)
            kc = np.minimum(np.maximum(kc, 1), kmax)
            sk = model.jump(tsub, c0, kc.astype(np.float64))
        if not good.all():
            # float-edge stragglers: exact bisection on the leftovers
            bad = ~good
            lo = np.ones(len(idx), np.int64)
            hi = kmax.copy()
            while True:
                act = bad & (lo < hi)
                if not act.any():
                    break
                mid = (lo + hi) // 2
                ge = model.jump(tsub, c0, mid.astype(np.float64)) >= bud
                hi = np.where(act & ge, mid, hi)
                lo = np.where(act & ~ge, mid + 1, lo)
            kc = np.where(bad, lo, kc)
            sk = np.where(bad, model.jump(tsub, c0,
                                          kc.astype(np.float64)), sk)
        k = k.copy()
        dtd = dtd.copy()
        k[idx] = kc
        dtd[idx] = sk
        return k, dtd

    def _apply_decode(self, B, dec, kk):
        self.ctx_sum[dec] += kk[dec] * self.n_occ[dec]
        step = kk[:, None] * self.s_active
        self.s_out += step
        done = self.s_out >= self.s_max
        if done.any():
            # flat completion pass across every lane at once; np.nonzero
            # is row-major, so per-lane slot order is ascending — same as
            # the scalar flatnonzero walk
            li, si = np.nonzero(done)
            rd = self.s_rid[li, si]
            self.r_out[li, rd] = self.s_out[li, si]
            self.r_finish[li, rd] = self.t[li]
            self.free_pages += np.bincount(
                li, self.s_need[li, si], minlength=B).astype(np.int64)
            ctx_del = self.r_plen[li, rd] + self.s_out[li, si] - 1
            counts = np.bincount(li, minlength=B)
            self.ctx_sum -= np.bincount(li, ctx_del,
                                        minlength=B).astype(np.int64)
            self.s_active[li, si] = False
            self.s_out[li, si] = 0
            self.s_max[li, si] = _HUGE
            self.s_need[li, si] = 0
            # push freed slots back on the stacks (ascending per lane)
            ends = np.cumsum(counts)
            within = np.arange(len(li)) - np.repeat(ends - counts, counts)
            self.free_stack[li, self.n_free[li] + within] = si
            self.n_free += counts
            self.n_occ -= counts
            if self.tracked[li].any():
                pos = 0
                for i in np.flatnonzero(counts):
                    c = int(counts[i])
                    if self.tracked[i]:
                        occ = self.occ_order[int(i)]
                        for s in si[pos:pos + c]:
                            del occ[int(s)]
                    pos += c


# ---------------------------------------------------------------------------
# run_point over a fleet
# ---------------------------------------------------------------------------


def _pct(vals: np.ndarray, q: float) -> float:
    """core.sweep._pct over an array (same np.percentile, same *1e3)."""
    return float(np.percentile(vals, q)) * 1e3 if len(vals) else float("nan")


def _lane_record(eng: FleetEngine, i: int, p: FleetPoint) -> "RunRecord":
    """Assemble lane i's RunRecord exactly as `run_point` would (same
    percentile calls, same reductions); valid once the lane has left the
    measured-phase event loop."""
    from repro_torch.core.cost import c_eff
    from repro_torch.core.records import RunRecord

    n = int(eng.n_req[i])
    spec = p.arrivals
    done = ~np.isnan(eng.r_finish[i, :n])
    finish = eng.r_finish[i, :n][done]
    first = eng.r_first[i, :n][done]
    arr = eng.r_arr[i, :n][done]
    toks = eng.r_out[i, :n][done]
    window = float(eng.t[i])
    out_toks = int(toks.sum())
    in_toks = int(eng.r_plen[i, :n][done].sum())
    tps = out_toks / window if window > 0 else 0.0
    tpot = (finish - first) / np.maximum(toks - 1, 1)
    mean_inflight = float(eng.area[i]) / max(window, 1e-9)
    return RunRecord(
        config=p.config, model=p.model, hw=p.hw, n_chips=p.n_chips,
        quant=p.quant, engine=p.engine_kind, lam=spec.lam,
        io_shape=spec.io_shape, n_requests=spec.n_requests,
        n_completed=int(done.sum()), window_s=window,
        tps=tps, prompt_tps=in_toks / window if window else 0.0,
        ttft_p50_ms=_pct(first - arr, 50),
        ttft_p90_ms=_pct(first - arr, 90),
        ttft_p99_ms=_pct(first - arr, 99),
        tpot_p50_ms=_pct(tpot, 50),
        tpot_p99_ms=_pct(tpot, 99),
        e2e_p50_ms=_pct(finish - arr, 50),
        e2e_p99_ms=_pct(finish - arr, 99),
        mean_inflight=mean_inflight,
        price_per_hr=p.price_per_hr,
        c_eff=c_eff(p.price_per_hr, tps),
        seed=spec.seed,
        mttf=p.failure_spec.mttf if p.failure_spec is not None else 0.0,
        retry_max=p.retry.max_attempts if p.retry is not None else 0,
        n_shed=int(eng.cnt_shed[i]),
        n_timeout=int(eng.cnt_timeout[i]),
        n_retried=0,    # RetryPolicy lanes never reach the fleet
        n_abandoned=int(eng.cnt_abandoned[i]),
        n_class_shed=int(eng.cnt_class_shed[i]),
        n_browned=int(eng.cnt_browned[i]),
        browned_tokens=int(eng.cnt_browned_tokens[i]),
        n_slo_viol=int(eng.cnt_slo_viol[i]),
        interactive_tps=(
            int(toks[eng.cls_l[i][:n][done] == 0].sum()) / window
            if (spec.class_mix and window > 0) else 0.0))


def _needs_admission(p: FleetPoint) -> bool:
    """Points whose lanes run the explicit admission queue (shedding,
    deadlines, an overload controller or SLO monitor)."""
    eng = p.engine
    return (getattr(eng, "max_queue_depth", 0) > 0
            or getattr(eng, "deadline_s", 0.0) > 0.0
            or getattr(eng, "overload", None) is not None)


def _needs_scalar(p: FleetPoint) -> bool:
    """Lanes the SoA loop cannot express (retry feedback, stochastic
    failure streams, deterministic failures combined with admission
    control) run per-lane through the scalar engine — the explicitly
    sanctioned fallback, RNG streams identical to `run_point` by
    construction. Pure admission/brownout points are NOT on
    this list: they run vectorized through the fleet's explicit
    admission queue."""
    return ((p.failure_spec is not None and p.failure_spec.enabled)
            or (p.retry is not None and p.retry.enabled)
            or (bool(p.failure_times) and _needs_admission(p)))


def _stream(spec: ArrivalSpec):
    """(times, p_ins, p_outs, classes) — the same draws, in the same
    stream order, as the scalar `synth_requests`."""
    times, p_ins, p_outs = synth_arrays(spec)
    return times, p_ins, p_outs, synth_classes(spec, len(times))


def _scalar_point(p: FleetPoint) -> "RunRecord":
    from repro_torch.core.sweep import run_point
    return run_point(
        p.engine, p.arrivals, warmup=p.warmup, horizon=p.horizon,
        failure_times=p.failure_times, failure_spec=p.failure_spec,
        retry=p.retry, config=p.config, model=p.model, hw=p.hw,
        n_chips=p.n_chips, quant=p.quant, engine_kind=p.engine_kind,
        price_per_hr=p.price_per_hr)


def fleet_run_points(points: Sequence[FleetPoint],
                     on_result=None) -> List["RunRecord"]:
    """Run every point as one lane of one vectorized fleet; returns
    RunRecords equal (field-for-field, bit-for-bit) to running
    `core.sweep.run_point` on each point independently. Points with
    resilience features enabled (`_needs_scalar`) are executed through
    the scalar engine per lane, after the vectorized lanes.

    `on_result(index, record)` streams each lane's record the moment the
    lane finishes its measured phase — the store hook for per-cell
    resume granularity on in-process runs (lanes finish at different sim
    times; a killed 128-lane chunk loses only the lanes still in
    flight, not the whole chunk)."""
    if not points:
        return []
    scalar_ids = [i for i, p in enumerate(points) if _needs_scalar(p)]
    if scalar_ids:
        lane_ids = [i for i in range(len(points)) if i not in
                    set(scalar_ids)]
        out: List[Optional["RunRecord"]] = [None] * len(points)
        if lane_ids:
            sub = [points[i] for i in lane_ids]

            def _sub_result(j: int, rec):
                out[lane_ids[j]] = rec
                if on_result is not None:
                    on_result(lane_ids[j], rec)

            fleet_run_points(sub, on_result=_sub_result)
        for i in scalar_ids:
            out[i] = _scalar_point(points[i])
            if on_result is not None:
                on_result(i, out[i])
        return list(out)
    eng = FleetEngine([p.engine for p in points])
    # warmup phase (per-lane stream seed + 7777, no horizon/failures),
    # exactly run_point's protocol; warmup-free lanes sit it out
    if any(p.warmup for p in points):
        streams = []
        for p in points:
            if p.warmup:
                wspec = dataclasses.replace(p.arrivals,
                                            n_requests=p.warmup,
                                            seed=p.arrivals.seed + 7777)
                streams.append(_stream(wspec))
            else:
                z = np.zeros(0)
                zi = z.astype(np.int64)
                streams.append((z, zi, zi, zi))
        eng.load_phase(streams, [None] * len(points),
                       [()] * len(points))
        eng.run_phase()
        eng.reset_measurement()
    # measured phase
    eng.load_phase([_stream(p.arrivals) for p in points],
                   [p.horizon for p in points],
                   [p.failure_times for p in points])
    out: List[Optional["RunRecord"]] = [None] * len(points)

    def _on_dead(i: int):
        out[i] = _lane_record(eng, i, points[i])
        if on_result is not None:
            on_result(i, out[i])

    eng.run_phase(on_lane_dead=_on_dead)
    return list(out)
