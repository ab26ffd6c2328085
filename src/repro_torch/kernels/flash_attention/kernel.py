"""Binding of the hand-written CUDA flash-attention forward kernel.

The kernel is `csrc/flash_attention.cu` (it replaces the Pallas
`repro.kernels.flash_attention.kernel.flash_attention_kernel`). It takes
the `(B, S, H, D)` layout of the model directly, so no transposes
surround it. This wrapper checks its inputs, allocates the output,
launches on PyTorch's current stream and counts its launches in
`flash_attention_kernel.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (128,)        # compiled for llama31-8b's head_dim


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
    return lib


def flash_attention_kernel(q, k, v, *, causal: bool = True,
                           kv_len=None) -> torch.Tensor:
    """q: (B, Sq, Hq, D) bf16; k, v: (B, Sk, Hkv, D) bf16; kv_len: None or
    (B,) int32 valid key counts; contiguous on one card. Any Sq and Sk;
    the causal mask is top-left (`col <= row`). Returns (B, Sq, Hq, D)
    bf16."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    tensors = (q, k, v) + (() if kv_len is None else (kv_len,))
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_attention_kernel: all inputs must be on one "
                         "CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_kernel: inputs must be contiguous")
    if any(t.dtype != torch.bfloat16 for t in tensors[:3]):
        raise TypeError("flash_attention_kernel: inputs must be bf16")
    if kv_len is not None and kv_len.dtype != torch.int32:
        raise TypeError("flash_attention_kernel: kv_len must be int32")
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D or \
            Hq % Hkv or Sk == 0 or \
            (kv_len is not None and kv_len.shape != (B,)):
        raise ValueError("flash_attention_kernel: inconsistent shapes")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel: head_dim {D} not compiled "
                         f"(have {HEAD_DIMS})")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            B, Sq, Sk, Hq, Hkv, D, int(causal), stream)
    build.check(lib, err, "flash_attention_kernel")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
