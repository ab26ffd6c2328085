"""Dispatch for the int8 matmul: the CUDA kernel for tensors on the card,
the plain version for tensors on the CPU. There is no fallback: a CUDA
tensor the kernel does not take raises."""
from __future__ import annotations

from repro_torch.kernels.int8_matmul.kernel import int8_matmul_kernel
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref


def int8_matmul(x_q, w_q, x_scale, w_scale):
    """x_q: (M, K) int8; w_q: (K, N) int8 (stored K-major for the
    kernel); x_scale: (1,) fp32; w_scale: (1, N) fp32. Returns (M, N)
    fp32."""
    if x_q.device.type == "cpu":
        return int8_matmul_ref(x_q, w_q, x_scale, w_scale)
    return int8_matmul_kernel(x_q, w_q, x_scale, w_scale)
