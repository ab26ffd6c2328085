"""Plain PyTorch grouped GEMM over int8 experts.

What the port's MoE computed before the kernel, and what the reference
computes: the stacked int8 weights dequantized to bf16 by
`quant.dequantize` (`bf16(q) * bf16(scale)`, rounded to bf16), then one
batched bf16 product over the experts.
"""
from __future__ import annotations

import torch

from repro_torch.quant import dequantize


def moe_gemm_ref(x, q, scale) -> torch.Tensor:
    """x: (E, M, K) bf16; q: (E, K, N) int8; scale: (E, 1, N) fp32.
    Returns (E, M, N) bf16."""
    return torch.einsum("emk,ekn->emn", x, dequantize(q, scale))
