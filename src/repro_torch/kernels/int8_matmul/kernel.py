"""Binding of the hand-written CUDA int8 matmul kernel.

The kernel is `csrc/int8_matmul.cu` (it replaces the Pallas
`repro.kernels.int8_matmul.kernel.int8_matmul_kernel`). The integer
tensor-core product takes both operands K-major, so the kernel reads the
weight as the model stores it: the reference's `(K, N)` shape and values,
stored K-major (the `.mT` view of the first K columns of a contiguous
`(N, ldw)` tensor, strides `(1, ldw)`; `repro_torch.quant.k_major`). It
takes no other layout: copying a row-major weight on every call would
cost up to its whole size (526 MB for llama31-8b's lm_head) and hide it.

Any K and N: TMA reads rows whose byte strides are multiples of 16, so a
K that is not a multiple of 16 (xlstm-350m's sLSTM down projection, K
1365) lives in rows padded to one (`ldw = ceil(K / 16) * 16`, and x_q's
rows alike: `pad_rows`), and the output, whose fp32 rows must be 16 bytes
apart, is allocated with its rows padded to a multiple of 4 floats and
returned as the `(M, N)` view. The kernel's tensor maps describe the true
K and N, so the padding is never read. This wrapper checks its inputs,
allocates the output, launches on PyTorch's current stream and counts its
launches in `int8_matmul_kernel.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# TMA reads rows of x_q and of the K-major w_q and writes rows of the fp32
# output: their strides must be multiples of 16 bytes.
ROW_BYTES = 16


def padded(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_rows(x_q: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) with rows a multiple of 16 bytes apart, as the kernel
    takes it: x_q itself if they are, else the first K columns of a zeroed
    `(M, ceil(K / 16) * 16)` copy."""
    M, K = x_q.shape
    if x_q.stride(1) == 1 and x_q.stride(0) % ROW_BYTES == 0 and \
            x_q.stride(0) >= K:
        return x_q
    buf = x_q.new_zeros((M, padded(K, ROW_BYTES)))
    buf[:, :K] = x_q
    return buf[:, :K]


def _lib():
    lib = build.load("int8_matmul")
    fn = lib.int8_matmul_s8
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
    return lib


def int8_matmul_kernel(x_q, w_q, x_scale, w_scale) -> torch.Tensor:
    """x_q: (M, K) int8, rows contiguous and a multiple of 16 bytes apart
    (`pad_rows`); w_q: (K, N) int8 stored K-major (strides (1, ldw), ldw a
    multiple of 16, at least K); x_scale: (1,) fp32; w_scale: (1, N) or
    (N,) fp32; all on one card, x_q and w_q 16-byte aligned; any M, K and
    N. Returns (M, N) fp32, `acc * (x_scale * w_scale)`: contiguous where
    N is a multiple of 4, else the first N columns of rows padded to
    one."""
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
    if K == 0 or N == 0:
        raise ValueError(f"int8_matmul_kernel: K {K} and N {N} must be "
                         "positive")
    if not (x_scale.is_contiguous() and w_scale.is_contiguous()):
        raise ValueError("int8_matmul_kernel: the scales must be "
                         "contiguous")
    ldx = x_q.stride(0)
    if x_q.stride(1) != 1 or (M > 1 and (ldx % ROW_BYTES or ldx < K)):
        raise ValueError(f"int8_matmul_kernel: x_q's rows must be "
                         f"contiguous and a multiple of {ROW_BYTES} bytes "
                         f"apart, not strides {x_q.stride()} "
                         "(kernel.pad_rows)")
    if M <= 1:
        ldx = padded(K, ROW_BYTES)
    ldw = w_q.stride(1)
    if w_q.stride(0) != 1 or ldw % ROW_BYTES or ldw < K:
        raise ValueError(f"int8_matmul_kernel: w_q must be stored K-major, "
                         f"strides (1, ldw) with ldw a multiple of "
                         f"{ROW_BYTES} and at least {K}, not {w_q.stride()} "
                         "(repro_torch.quant.k_major)")
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul_kernel: x_q and w_q must be 16-byte "
                         "aligned")
    ldo = padded(N, ROW_BYTES // 4)
    out = torch.empty((M, ldo), dtype=torch.float32,
                      device=x_q.device)[:, :N]
    if M == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.int8_matmul_s8(
            x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), M, N, K, ldx, ldw, ldo,
            stream)
    build.check(lib, err, "int8_matmul_kernel")
    int8_matmul_kernel.launches += 1
    return out


int8_matmul_kernel.launches = 0
