"""Dispatch for paged attention: the CUDA kernel for tensors on the card,
the plain version for tensors on the CPU. There is no fallback: a CUDA
tensor the kernel does not take raises."""
from __future__ import annotations

from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens):
    """q: (B, Hq, D); pools: (P, page, Hkv, D); block_tables: (B, max_pages)
    int32 page ids; seq_lens: (B,) int32. Returns (B, Hq, D)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens)
    return paged_attention_kernel(q, k_pool, v_pool, block_tables, seq_lens)
