"""Dispatch for flash attention: the CUDA kernel for tensors on the card,
the plain version for tensors on the CPU. There is no fallback: a CUDA
tensor the kernel does not take raises.

Layout `(B, S, H, D)`, as the model zoo's.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    return flash_attention_kernel(q, k, v, causal=causal)
