"""Binding of the hand-written CUDA grouped GEMM over int8 MoE experts.

The kernel is `csrc/moe_gemm.cu` (device symbol `moe_w8_gemm_kernel`).
It has no Pallas counterpart: it replaces the MoE's dequantization of
every int8 expert to a bf16 copy (`models.moe._w`) and the einsum that
read the copy. It reads the weights as the model stores a stack of
experts: `q` (E, K, N) int8 row-major and `scale` (E, 1, N) fp32
(`quant.quantize_weight`), and forms each bf16 weight in registers.

It takes N a multiple of 128 and K of 16 (every served MoE's expert
shapes: mixtral-8x7b, jamba-v0.1-52b, llama4-maverick-400b-a17b,
qwen3-30b-a3b, granite-moe-1b-a400m) and any E and M. This wrapper
checks its inputs, allocates the output, launches on PyTorch's current
stream and counts its launches in `moe_gemm_kernel.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

N_MULTIPLE, K_MULTIPLE = 128, 16


def _lib():
    lib = build.load("moe_gemm")
    fn = lib.moe_w8_gemm
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
    return lib


def moe_gemm_kernel(x, q, scale) -> torch.Tensor:
    """x: (E, M, K) bf16; q: (E, K, N) int8; scale: (E, 1, N) fp32; all
    contiguous, on one card, x and q 16-byte aligned; N a multiple of 128,
    K of 16. Returns (E, M, N) bf16."""
    tensors = (x, q, scale)
    if any(t.device.type != "cuda" or t.device != x.device
           for t in tensors):
        raise ValueError("moe_gemm_kernel: all inputs must be on one CUDA "
                         "device")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or \
            scale.dtype != torch.float32:
        raise TypeError(f"moe_gemm_kernel: need x bf16, q int8 and scale "
                        f"float32, not {x.dtype}, {q.dtype}, {scale.dtype}")
    if x.ndim != 3 or q.ndim != 3 or scale.ndim != 3:
        raise ValueError("moe_gemm_kernel: need x (E, M, K), q (E, K, N) "
                         "and scale (E, 1, N)")
    E, M, K = x.shape
    N = q.shape[2]
    if q.shape[:2] != (E, K) or tuple(scale.shape) != (E, 1, N):
        raise ValueError(f"moe_gemm_kernel: shapes {tuple(x.shape)}, "
                         f"{tuple(q.shape)}, {tuple(scale.shape)} are not "
                         "(E, M, K), (E, K, N), (E, 1, N)")
    if N % N_MULTIPLE or K % K_MULTIPLE or K == 0 or E > 65535:
        raise ValueError(f"moe_gemm_kernel: N {N} must be a positive "
                         f"multiple of {N_MULTIPLE}, K {K} of {K_MULTIPLE}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"moe_gemm_kernel: inputs must be contiguous, not "
                         f"strides {x.stride()}, {q.stride()}, "
                         f"{scale.stride()}")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("moe_gemm_kernel: x and q must be 16-byte aligned")
    out = torch.empty((E, M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0 or E == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moe_w8_gemm(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), E, M, K, N, stream)
    build.check(lib, err, "moe_gemm_kernel")
    moe_gemm_kernel.launches += 1
    return out


moe_gemm_kernel.launches = 0
