"""Plain PyTorch int8 matmul with fused dequantization.

It computes what the Pallas kernel `repro.kernels.int8_matmul.kernel`
computes: the int8 x int8 product summed exactly, then once
`acc.float() * (x_scale * w_scale)`. The sum is exact on both devices:
on the CPU an int32 matmul; on the card, which has no int32 matmul, a
float64 one cast to int32, exact because every partial sum is an integer
below K * 128**2 < 2**31 < 2**53. `torch.matmul` reads strides, so the
weight may be row-major or stored K-major, as the model stores it.
"""
from __future__ import annotations

import torch


def int8_matmul_ref(x_q, w_q, x_scale, w_scale) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (K, N) int8, either layout; x_scale: (1,)
    fp32; w_scale: (1, N) fp32 per output channel. Returns (M, N) fp32."""
    if x_q.device.type == "cpu":
        acc = torch.matmul(x_q.to(torch.int32), w_q.to(torch.int32))
    else:
        acc = torch.matmul(x_q.double(), w_q.double()).to(torch.int32)
    return acc.float() * (x_scale.float() * w_scale.float())
