"""The wall-clock execution tier behind the engine, on PyTorch.

Counterpart of `repro.serving.executors.RealExecutor`, with the same
interface: `needs_tokens`, `reset_slot`, `prefill`, `decode` and the
per-step `decode_multi`. It owns the device state (KV pools, seq_lens),
runs the step functions of `repro_torch.serving.runner`, and returns
durations in wall-clock seconds, each taken after
`torch.cuda.synchronize()` on the card. The sim tier waits for an H100
step-time model.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.runner import (init_pools, make_step_fns,
                                        set_matmul_precision)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when a CUDA device is asked for and none exists."""
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
        self.device = resolve_device(device)
        set_matmul_precision()
        self.cfg = cfg
        self.params = params
        self.page_size = page_size
        self.pools = init_pools(cfg, num_pages, page_size, device=self.device)
        self.seq_lens = torch.zeros((max_batch,), dtype=torch.int32,
                                    device=self.device)
        self.prefill_fn, self.decode_fn = make_step_fns(cfg, page_size,
                                                        qcfg=qcfg)
        self.n_prefill_calls = 0
        self.n_decode_steps = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def reset_slot(self, slot: int):
        self.seq_lens[slot] = 0

    def prefill(self, tokens: np.ndarray, lens: np.ndarray,
                do_mask: np.ndarray, block_tables: np.ndarray
                ) -> Tuple[np.ndarray, float]:
        self._sync()
        t0 = time.perf_counter()
        first, self.seq_lens = self.prefill_fn(
            self.params, self.pools, self._t(block_tables), self.seq_lens,
            self._t(tokens), self._t(lens), self._t(do_mask))
        first = first.cpu().numpy()
        self._sync()
        self.n_prefill_calls += 1
        return first, time.perf_counter() - t0

    def decode(self, tokens: np.ndarray, active: np.ndarray,
               block_tables: np.ndarray) -> Tuple[np.ndarray, float]:
        self._sync()
        t0 = time.perf_counter()
        nxt, self.seq_lens = self.decode_fn(
            self.params, self.pools, self._t(block_tables), self.seq_lens,
            self._t(tokens), self._t(active))
        nxt = nxt.cpu().numpy()
        self._sync()
        self.n_decode_steps += 1
        return nxt, time.perf_counter() - t0

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
