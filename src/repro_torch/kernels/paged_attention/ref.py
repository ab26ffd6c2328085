"""Plain PyTorch paged attention: gather the pages, then dense decode.

It computes what the reference's served decode computes
(`repro.kernels.paged_attention.ref.paged_attention_ref`, which
`repro.serving.runner` runs), in fp32 throughout: scores scaled by
1/sqrt(D), positions at or past `seq_len` masked to a finite -1e30, then a
softmax. So a slot with `seq_len == 0` (an idle decode slot) gets the mean
of V over all `max_pages * page` positions that its block-table row
gathers: every score is the same -1e30. The Pallas kernel
`repro.kernels.paged_attention.kernel` differs from the reference's served
path at exactly this point: it gives such a slot 0. The port follows the
served path, because an idle row's value flows on into the MoE capacity
queues that it shares with real tokens.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gather_kv(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """pool: (P, page, Hkv, D); block_tables: (B, max_pages) ->
    contiguous (B, max_pages*page, Hkv, D)."""
    g = pool[block_tables.long()]             # (B, max_pages, page, Hkv, D)
    B, n, pg, H, D = g.shape
    return g.reshape(B, n * pg, H, D)


def paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens
                        ) -> torch.Tensor:
    """q: (B, Hq, D); pools: (P, page, Hkv, D); block_tables: (B, max_pages)
    int32; seq_lens: (B,) int32 valid context lengths. Returns (B, Hq, D)
    in q's dtype."""
    B, Hq, D = q.shape
    k = gather_kv(k_pool, block_tables).float()   # (B, S, Hkv, D)
    v = gather_kv(v_pool, block_tables).float()
    Hkv, S = k.shape[2], k.shape[1]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) / (D ** 0.5)
    valid = (torch.arange(S, device=q.device)[None]
             < seq_lens.to(q.device)[:, None])[:, None, None]  # (B,1,1,S)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v) / l      # l >= 1
    return o.reshape(B, Hq, D).to(q.dtype)
