"""Binding of the hand-written CUDA paged-attention decode kernel.

The kernel is `csrc/paged_attention.cu` (it replaces the Pallas
`repro.kernels.paged_attention.kernel.paged_attention_kernel`). This
wrapper checks its inputs, allocates the output, launches on PyTorch's
current stream and counts its launches in `paged_attention_kernel.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# compiled for the served (head_dim, query heads per KV head): llama31-8b
# (128, 4), qwen3-30b-a3b (128, 8), codeqwen1.5-7b (128, 1),
# nemotron-4-15b (128, 6), qwen2-vl-7b (128, 7), llama4-maverick-400b-a17b
# (128, 5), granite-34b (128, 48) and granite-moe-1b-a400m (64, 2)
COMPILED = ((128, 4), (128, 8), (128, 1), (128, 6), (128, 7), (128, 5),
            (128, 48), (64, 2))


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
    return lib


def paged_attention_kernel(q, k_pool, v_pool, block_tables, seq_lens
                           ) -> torch.Tensor:
    """q: (B, Hq, D) bf16; pools: (P, page, Hkv, D) bf16; block_tables:
    (B, max_pages) int32; seq_lens: (B,) int32. All contiguous on one card,
    q and the pools 16-byte aligned. Returns (B, Hq, D) bf16; a row with
    seq_len 0 gets the mean of V over every position its block-table row
    gathers, as `ref.paged_attention_ref` gives it."""
    B, Hq, D = q.shape
    P, page, Hkv, Dk = k_pool.shape
    max_pages = block_tables.shape[1]
    tensors = (q, k_pool, v_pool, block_tables, seq_lens)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("paged_attention_kernel: all inputs must be on one "
                         "CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_kernel: inputs must be contiguous")
    if q.dtype != torch.bfloat16 or k_pool.dtype != torch.bfloat16 or \
            v_pool.dtype != torch.bfloat16:
        raise TypeError("paged_attention_kernel: q and pools must be bf16")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention_kernel: block_tables and seq_lens "
                        "must be int32")
    if v_pool.shape != k_pool.shape or Dk != D or Hq % Hkv or \
            block_tables.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("paged_attention_kernel: inconsistent shapes")
    if max_pages < 1:
        raise ValueError("paged_attention_kernel: a block table needs at "
                         "least one page")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention_kernel: q and the pools must be "
                         "16-byte aligned")
    if (D, Hq // Hkv) not in COMPILED:
        raise ValueError(f"paged_attention_kernel: (head_dim, group) "
                         f"{(D, Hq // Hkv)} not compiled (have {COMPILED})")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, page, max_pages, stream)
    build.check(lib, err, "paged_attention_kernel")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
