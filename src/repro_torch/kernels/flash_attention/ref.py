"""Plain PyTorch attention forward, the flash kernel's arithmetic in fp32.

It computes what the Pallas kernel `repro.kernels.flash_attention.kernel`
computes: GQA (query head h reads KV head h // G), scores in fp32 scaled
by 1/sqrt(D), a top-left causal mask (`col <= row`) or none, fp32
softmax and fp32 PV product, the output in q's dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with Hq % Hkv == 0.
    Returns (B, Sq, Hq, D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / (D ** 0.5)
    if causal:
        valid = (torch.arange(Sk, device=q.device)[None, :]
                 <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(valid, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
