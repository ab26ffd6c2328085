"""Gradient compression for the DP all-reduce: int8 + error feedback.

Counterpart of `repro.training.compression`: transmit q = Q(g + e) in
int8 with a per-tensor scale, keep e' = (g + e) - deQ(q) locally. As the
compiled reference computes it: the scale `max(amax, 1e-12) / 127.0` is a
product by fl32(1/127) under `jax.jit` (`quant.INV_127`), and the codes
are the quotient by that scale, rounded half to even; the new error is
`fma(-q, scale, g + e)`, one rounding, as the compiled reference fuses
it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.adamw8bit.ref import fma32
from repro_torch.quant import INV_127


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    floor = torch.full((), 1e-12, dtype=torch.float32, device=gf.device)
    scale = torch.maximum(gf.abs().amax(), floor) * INV_127
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback_update(g: torch.Tensor, err: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Returns (q, scale, new_err) for one tensor."""
    corrected = g.float() + err
    q, scale = compress_int8(corrected)
    new_err = fma32(-q.float(), scale, corrected)
    return q, scale, new_err
