"""Plain PyTorch attention forward, the flash kernel's arithmetic in fp32.

It computes what the Pallas kernel `repro.kernels.flash_attention.kernel`
computes: GQA (query head h reads KV head h // G), scores in fp32 scaled
by 1/sqrt(D), a top-left causal mask (`col <= row`) or none, fp32
softmax and fp32 PV product, the output in q's dtype. With `kv_len` (B,)
keys at or past `kv_len[b]` are masked too, as the reference model's
`causal_attention(kv_len=)` masks them; a row left with no key (a slot
with `kv_len` 0) gets, as there, the softmax of all-equal masked scores:
the mean of V over all Sk keys.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        kv_len=None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with Hq % Hkv == 0;
    kv_len: optional (B,) int. Returns (B, Sq, Hq, D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / (D ** 0.5)
    cols = torch.arange(Sk, device=q.device)
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid = cols[None, :] <= torch.arange(Sq, device=q.device)[:, None]
    valid = valid[None, None, None]                       # (1,1,1,Sq,Sk)
    if kv_len is not None:
        valid = valid & (cols < kv_len.to(q.device)[:, None]
                         )[:, None, None, None, :]
    # masked scores underflow to exactly 0; a row with no key left keeps
    # all of them equal, hence uniform
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
