"""Binding of the hand-written CUDA int8 matmul kernel.

The kernel is `csrc/int8_matmul.cu` (it replaces the Pallas
`repro.kernels.int8_matmul.kernel.int8_matmul_kernel`). The integer
tensor-core product takes both operands K-major, so the kernel reads the
weight as the model stores it: the reference's `(K, N)` shape and values,
stored K-major (the `.mT` view of a contiguous `(N, K)` tensor, strides
`(1, K)`; `repro_torch.quant.k_major`). It takes no other layout: copying
a row-major weight on every call would cost up to its whole size (526 MB
for llama31-8b's lm_head) and hide it. This wrapper checks its inputs,
allocates the output, launches on PyTorch's current stream and counts its
launches in `int8_matmul_kernel.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# TMA reads rows of x_q and of the K-major w_q (K bytes) and writes rows of
# the output (4 N bytes): their strides must be multiples of 16.
K_MULTIPLE, N_MULTIPLE = 16, 8


def _lib():
    lib = build.load("int8_matmul")
    fn = lib.int8_matmul_s8
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
    return lib


def int8_matmul_kernel(x_q, w_q, x_scale, w_scale) -> torch.Tensor:
    """x_q: (M, K) int8, contiguous; w_q: (K, N) int8 stored K-major
    (strides (1, K)); x_scale: (1,) fp32; w_scale: (1, N) or (N,) fp32;
    all on one card, x_q and w_q 16-byte aligned, K a multiple of 16 and N
    of 8; any M. Returns (M, N) fp32, `acc * (x_scale * w_scale)`."""
    tensors = (x_q, w_q, x_scale, w_scale)
    if any(t.device.type != "cuda" or t.device != x_q.device
           for t in tensors):
        raise ValueError("int8_matmul_kernel: all inputs must be on one "
                         "CUDA device")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("int8_matmul_kernel: x_q and w_q must be int8")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("int8_matmul_kernel: scales must be float32")
    if x_q.ndim != 2 or w_q.ndim != 2 or w_q.shape[0] != x_q.shape[1]:
        raise ValueError("int8_matmul_kernel: need x_q (M, K) and w_q "
                         "(K, N)")
    M, K = x_q.shape
    N = w_q.shape[1]
    if x_scale.numel() != 1 or w_scale.numel() != N or \
            w_scale.shape[-1] != N:
        raise ValueError("int8_matmul_kernel: need x_scale (1,) and "
                         "w_scale (1, N)")
    if K % K_MULTIPLE or N % N_MULTIPLE or K == 0 or N == 0:
        raise ValueError(f"int8_matmul_kernel: K {K} must be a positive "
                         f"multiple of {K_MULTIPLE} and N {N} of "
                         f"{N_MULTIPLE}")
    if not (x_q.is_contiguous() and x_scale.is_contiguous()
            and w_scale.is_contiguous()):
        raise ValueError("int8_matmul_kernel: x_q and the scales must be "
                         "contiguous")
    if w_q.stride() != (1, K):
        raise ValueError(f"int8_matmul_kernel: w_q must be stored K-major, "
                         f"strides (1, {K}), not {w_q.stride()} "
                         "(repro_torch.quant.k_major)")
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul_kernel: x_q and w_q must be 16-byte "
                         "aligned")
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    if M == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.int8_matmul_s8(
            x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), M, N, K, stream)
    build.check(lib, err, "int8_matmul_kernel")
    int8_matmul_kernel.launches += 1
    return out


int8_matmul_kernel.launches = 0
