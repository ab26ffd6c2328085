"""Execution tiers behind the engine: real PyTorch steps or a step-time model.

RealExecutor — counterpart of `repro.serving.executors.RealExecutor`, with
the same interface: `needs_tokens`, `reset_slot`, `prefill`, `decode` and
the per-step `decode_multi`. It owns the device state (KV pools, Mamba
states, seq_lens), runs the step functions of
`repro_torch.serving.runner`, and returns durations in wall-clock
seconds, each taken after `torch.cuda.synchronize()` on the card. torch
and the runner are imported lazily, so sim-only processes
(parallel_sweep workers) never load them.

SimExecutor — a copy of the reference's: same interface, zero compute:
durations come from a calibrated step-time model
(repro_torch.simulate.step_time) so the engine's scheduler/queueing
dynamics play out on a virtual clock. Token values are irrelevant to
cost metering (only counts and timing matter), so it emits zeros and
advertises `needs_tokens = False` (the engine then skips materialising
prompt token matrices).

`decode_multi(tokens, active, block_tables, context_lens, max_steps,
time_budget)` is the fast-forward hook: take up to `max_steps` decode
steps with a frozen batch, stopping after the first step whose cumulative
duration reaches `time_budget` (events are processed at the top of the
engine loop, i.e. *after* the step that crosses them — identical to the
per-token reference loop). SimExecutor answers in O(log k) closed-form
model evaluations; RealExecutor falls back to per-step execution because
wall-clock durations cannot be predicted.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.tracing import span


def resolve_device(device) -> "torch.device":
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when a CUDA device is asked for and none exists."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this entry point runs on the card; pass "
            "device='cpu' to run the plain versions on the CPU")
    return device


class RealExecutor:
    """Wall-clock tier: real logits, real latencies."""

    needs_tokens = True

    def __init__(self, cfg, params, *, num_pages: int, page_size: int,
                 max_batch: int, qcfg=None, device="cuda"):
        import torch
        from repro_torch.serving.runner import (init_pools, make_step_fns,
                                                set_matmul_precision)
        self._torch = torch
        self.device = resolve_device(device)
        set_matmul_precision()
        self.cfg = cfg
        self.params = params
        self.page_size = page_size
        self.pools = init_pools(cfg, num_pages, page_size, max_batch,
                                device=self.device)
        self.seq_lens = torch.zeros((max_batch,), dtype=torch.int32,
                                    device=self.device)
        self.prefill_fn, self.decode_fn = make_step_fns(cfg, page_size,
                                                        qcfg=qcfg)
        self.n_prefill_calls = 0
        self.n_decode_steps = 0

    def _sync(self):
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)

    def _t(self, a: np.ndarray) -> "torch.Tensor":
        return self._torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)

    def reset_slot(self, slot: int):
        self.seq_lens[slot] = 0

    def _call(self, fn, first, *host):
        """One step of `fn`: the host arrays copied to the device (h2d),
        the step dispatched (step), its tokens back on the host and the
        device drained (d2h); the tokens and the wall seconds."""
        self._sync()
        t0 = time.perf_counter()
        with span("executor.h2d"):
            bt, *args = [self._t(a) for a in (first,) + host]
        with span("executor.step"):
            out, self.seq_lens = fn(self.params, self.pools, bt,
                                    self.seq_lens, *args)
        with span("executor.d2h"):
            out = out.cpu().numpy()
            self._sync()
        return out, time.perf_counter() - t0

    def prefill(self, tokens: np.ndarray, lens: np.ndarray,
                do_mask: np.ndarray, block_tables: np.ndarray
                ) -> Tuple[np.ndarray, float]:
        with span("executor.prefill"):
            out = self._call(self.prefill_fn, block_tables, tokens, lens,
                             do_mask)
        self.n_prefill_calls += 1
        return out

    def decode(self, tokens: np.ndarray, active: np.ndarray,
               block_tables: np.ndarray) -> Tuple[np.ndarray, float]:
        with span("executor.decode"):
            out = self._call(self.decode_fn, block_tables, tokens, active)
        self.n_decode_steps += 1
        return out

    def decode_multi(self, tokens: np.ndarray, active: np.ndarray,
                     block_tables: np.ndarray, context_lens: np.ndarray,
                     max_steps: int, time_budget: Optional[float] = None
                     ) -> Tuple[np.ndarray, float, int]:
        """Per-step fallback: real logits cannot be fast-forwarded."""
        cur = np.array(tokens)
        total = 0.0
        steps = 0
        while steps < int(max_steps):
            nxt, dt = self.decode(cur, active, block_tables)
            cur[active] = nxt[active]
            total += dt
            steps += 1
            if time_budget is not None and total >= time_budget:
                break
        return cur, total, max(steps, 1)


class SimExecutor:
    """Virtual-clock tier: step durations from the step-time model."""

    needs_tokens = False

    def __init__(self, cfg, step_time_model, *, page_size: int = 16):
        self.cfg = cfg
        self.model = step_time_model
        self.page_size = page_size
        self._seq_lens: Optional[np.ndarray] = None

    def reset_slot(self, slot: int):
        pass

    def prefill(self, tokens: np.ndarray, lens: np.ndarray,
                do_mask: np.ndarray, block_tables: np.ndarray
                ) -> Tuple[np.ndarray, float]:
        n_tok = int(lens[do_mask].sum())
        dt = self.model.prefill_time(n_tok, int(do_mask.sum()))
        return np.zeros(tokens.shape[0], np.int32), dt

    def decode(self, tokens: np.ndarray, active: np.ndarray,
               block_tables: np.ndarray, context_lens=None
               ) -> Tuple[np.ndarray, float]:
        bs = int(active.sum())
        ctx = (float(np.mean(context_lens[active]))
               if context_lens is not None and bs else 0.0)
        dt = self.model.decode_time(bs, ctx)
        return np.zeros(tokens.shape[0], np.int32), dt

    def decode_multi(self, tokens: np.ndarray, active: np.ndarray,
                     block_tables: np.ndarray, context_lens: np.ndarray,
                     max_steps: int, time_budget: Optional[float] = None
                     ) -> Tuple[np.ndarray, float, int]:
        """Closed-form jump: every context grows by one token per step, so
        the k-step duration is `StepTimeModel.decode_time_multi`; the step
        count crossing `time_budget` is found by bisection on that O(1)
        sum (smallest k with S(k) >= budget, capped at max_steps)."""
        bs = int(active.sum())
        ctx0 = (float(np.mean(context_lens[active]))
                if context_lens is not None and bs else 0.0)
        k = max(int(max_steps), 1)
        m = self.model
        if (time_budget is not None and k > 1 and
                m.decode_time_multi(bs, ctx0, k) >= time_budget):
            lo, hi = 1, k
            while lo < hi:
                mid = (lo + hi) // 2
                if m.decode_time_multi(bs, ctx0, mid) >= time_budget:
                    hi = mid
                else:
                    lo = mid + 1
            k = lo
        dt = m.decode_time_multi(bs, ctx0, k)
        return np.zeros(tokens.shape[0], np.int32), dt, k
