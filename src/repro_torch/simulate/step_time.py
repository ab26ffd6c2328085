"""Analytic TPU step-time model for the virtual-clock serving tier.

Three-term roofline per engine step (compute / HBM / ICI-collective), the
same decomposition as launch/roofline.py — the simulator is the dry-run
roofline turned into a clock. Calibration knobs (mfu, mbu, fixed overhead)
default to conservative public MaxText-era numbers and can be overridden
from measured dry-run terms via `from_roofline`.

Quantization semantics (paper §5.3 / §5.9 Result 2, TPU-adapted):
  int8          — native MXU path: 2x peak, 0.5x weight bytes.
  fp8 native    — v6e-class: 2x peak, 0.5x weight bytes.
  fp8 emulated  — v5e: 0.5x weight bytes (the HBM win survives) but the
                  matmul runs at bf16 peak with a dequant-overhead factor —
                  compute-bound dense models can INVERT, exactly the
                  paper's A100 finding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.simulate.hardware import HardwareGen

DEQUANT_OVERHEAD = 1.18      # fp8-emulation compute penalty (v5e path)


@dataclasses.dataclass
class StepTimeModel:
    cfg: ModelConfig
    hw: HardwareGen
    n_chips: int = 1             # TP degree (model sharded over ICI)
    quant: str = "bf16"          # bf16 | int8 | fp8
    mfu: float = 0.55            # prefill compute efficiency (fat GEMMs)
    mfu_decode: float = 0.28     # decode GEMMs are skinny (M = batch):
    #                              MXU utilization is structurally low —
    #                              the mechanism behind the paper's
    #                              active-params-dominate finding (§5.2).
    #                              Calibrated so dense-vs-ultra-sparse
    #                              saturation ordering matches §5.2-5.3:
    #                              dense wins bf16, sparse wins quantized.
    lowprec_decode_discount: float = 0.31  # skinny GEMMs capture ~1.31x of
    #                              the 2x low-precision MXU peak (the
    #                              paper's dense +31% fp8 gain)
    mbu: float = 0.75            # HBM bandwidth utilization
    fixed_overhead: float = 0.004   # s/step: dispatch + host + sampling
    moe_dispatch_overhead: float = 1.5e-6  # s per routed token

    # ---- derived ---------------------------------------------------------
    def __post_init__(self):
        # ModelConfig is frozen, so cfg-derived constants cannot go stale;
        # caching them here keeps the virtual-clock hot path (one
        # decode_time* call per scheduling event) free of the analytic
        # parameter walk. dataclasses.replace() re-runs this.
        self._total_params = self.cfg.param_count()
        self._active_params = self.cfg.active_param_count()
        self._kv_bytes_tok = self.cfg.kv_bytes_per_token()
        self._n_attn = sum(1 for k in self.cfg.block_pattern()
                           if k == "attn")

    @property
    def weight_bytes(self) -> float:
        per = 1 if self.quant in ("int8", "fp8") else 2
        return self._total_params * per

    @property
    def active_weight_bytes(self) -> float:
        per = 1 if self.quant in ("int8", "fp8") else 2
        return self._active_params * per

    @property
    def _peak(self) -> float:
        p = self.hw.peak(self.quant)
        if self.quant == "fp8" and not self.hw.native_fp8:
            p = self.hw.peak_flops_bf16 / DEQUANT_OVERHEAD
        return p

    def _collective_time(self, tokens: float) -> float:
        """Per-step TP all-reduce cost: 2 collectives/layer over d_model."""
        if self.n_chips <= 1:
            return 0.0
        bytes_ar = (2 * self.cfg.num_layers * tokens * self.cfg.d_model * 2
                    * 2 * (self.n_chips - 1) / self.n_chips)
        return bytes_ar / (self.n_chips * self.hw.ici_bw)

    @property
    def _peak_decode(self) -> float:
        base = self.hw.peak_flops_bf16
        if self.quant == "fp8" and not self.hw.native_fp8:
            return base / DEQUANT_OVERHEAD          # emulation penalty
        if self.quant in ("int8", "fp8"):
            return base * (1.0 + self.lowprec_decode_discount)
        return base

    # ---- decode ------------------------------------------------------------
    def _decode_terms(self, batch: int):
        """Shared per-step decode roofline terms at batch size `batch`:
        (compute_s, mem_base_s, mem_slope_s_per_ctx_token, const_s).
        Step time at context c is ``max(compute, mem_base + slope*c) +
        const``. Single source of truth for decode_time AND
        decode_time_multi — the fast-forward clock jump must never drift
        from the per-step reference, so any new roofline term belongs
        here, not in either caller. A third consumer mirrors this method
        op-for-op in vectorized numpy: `serving.fleet.FleetStepModel`
        (the multi-cell fleet backend) must stay bit-identical,
        and `tests/test_fleet.py` asserts exact equality — edit both
        together."""
        flops = 2.0 * self._active_params * batch
        compute = flops / (self.n_chips * self._peak_decode *
                           self.mfu_decode)
        bw = self.n_chips * self.hw.hbm_bw * self.mbu
        # dense weights + the touched expert subset stream once per step;
        # with large batches an MoE touches ~all experts, so interpolate
        touched = min(1.0, max(self.active_weight_bytes / self.weight_bytes,
                               batch * (self.cfg.moe.top_k /
                                        self.cfg.moe.num_experts)
                               if self.cfg.moe else 1.0))
        mem_base = self.weight_bytes * touched / bw
        mem_slope = batch * self._kv_bytes_tok / bw
        const = (self._collective_time(batch) +
                 (self.moe_dispatch_overhead * batch
                  if self.cfg.moe is not None else 0.0) +
                 self.fixed_overhead)
        return compute, mem_base, mem_slope, const

    def decode_time(self, batch: int, mean_ctx: float) -> float:
        """One decode step for `batch` in-flight sequences."""
        if batch == 0:
            return self.fixed_overhead
        compute, mem_base, mem_slope, const = self._decode_terms(batch)
        return max(compute, mem_base + mem_slope * mean_ctx) + const

    def decode_time_multi(self, batch: int, ctx0: float, k: int) -> float:
        """Closed-form sum of `k` consecutive decode steps.

        Between scheduling events the batch is frozen and every context
        grows by one token per step, so step i costs
        ``max(compute, mem0 + i*slope) + const`` with a single
        compute->memory crossover along the way — the k-step total
        collapses to one arithmetic series. This is the O(1) clock jump
        behind the engine's event-driven fast-forward path; both paths
        read the same `_decode_terms`, so the sum stays numerically
        equivalent (to float rounding) to summing
        ``decode_time(batch, ctx0 + i)`` for i in range(k).
        """
        if k <= 0:
            return 0.0
        if k == 1 or batch == 0:
            return k * self.decode_time(batch, ctx0)
        compute, mem_base, slope, const = self._decode_terms(batch)
        mem0 = mem_base + slope * ctx0
        if slope <= 0.0:
            return k * (max(compute, mem0) + const)
        # steps with memory below the compute roofline: i < (C - mem0)/slope
        m = min(max(int(math.ceil((compute - mem0) / slope)), 0), k)
        series = (k - m) * mem0 + slope * (m + k - 1) * (k - m) / 2.0
        return m * compute + series + k * const

    # ---- prefill -----------------------------------------------------------
    def prefill_time(self, n_tokens: int, n_reqs: int) -> float:
        if n_tokens == 0:
            return 0.0
        mean_len = n_tokens / max(n_reqs, 1)
        flops = 2.0 * self._active_params * n_tokens
        # quadratic attention term
        flops += (2 * 2 * self._n_attn * self.cfg.num_heads *
                  self.cfg.resolved_head_dim * n_tokens * mean_len)
        compute = flops / (self.n_chips * self._peak * self.mfu)
        mem_bytes = self.weight_bytes + \
            2 * n_tokens * self.cfg.d_model * 2 * self.cfg.num_layers
        memory = mem_bytes / (self.n_chips * self.hw.hbm_bw * self.mbu)
        coll = self._collective_time(n_tokens)
        moe_oh = (self.moe_dispatch_overhead * n_tokens
                  if self.cfg.moe is not None else 0.0)
        return max(compute, memory) + coll + moe_oh + self.fixed_overhead

    # ---- calibration -------------------------------------------------------
    @classmethod
    def from_roofline(cls, cfg: ModelConfig, hw: HardwareGen, terms: dict,
                      **kw) -> "StepTimeModel":
        """Override mfu/mbu from measured dry-run roofline terms: `terms`
        holds {"model_flops_ratio": useful/compiled} — compiled-graph waste
        directly discounts the achievable MFU."""
        ratio = float(terms.get("model_flops_ratio", 1.0))
        kw.setdefault("mfu", max(0.2, min(0.85, 0.62 * ratio)))
        return cls(cfg=cfg, hw=hw, **kw)

    def saturation_tps(self, mean_ctx: float = 640.0,
                       max_batch: int = 512) -> float:
        """Model-implied peak decode throughput (tokens/s)."""
        best = 0.0
        b = 1
        while b <= max_batch:
            tps = b / self.decode_time(b, mean_ctx)
            best = max(best, tps)
            b *= 2
        return best
