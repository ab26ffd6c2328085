"""Dispatch for the int8-expert grouped GEMM: the CUDA kernel for tensors
on the card, the plain version for tensors on the CPU. There is no
fallback: a CUDA tensor the kernel does not take raises."""
from __future__ import annotations

from repro_torch.kernels.moe_gemm.kernel import moe_gemm_kernel
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref


def moe_gemm(x, q, scale):
    """x: (E, M, K) bf16; q: (E, K, N) int8; scale: (E, 1, N) fp32.
    Returns (E, M, N) bf16: x[e] @ dequantize(q[e], scale[e])."""
    if x.device.type == "cpu":
        return moe_gemm_ref(x, q, scale)
    return moe_gemm_kernel(x, q, scale)
