"""GQA/MQA attention: projections, RoPE and M-RoPE, and the attention
math of the training and contiguous-cache paths.

Counterpart of `repro.models.attention`, all of it. Layouts as the
reference: q `(B, S, Hq, D)`, k/v `(B, S, Hkv, D)`, a contiguous decode
cache `(B, Hkv, S_max, D)` a layer. The served paths (`serving.runner`,
and `models.model.prefill` and `encode`) run their attention in the
kernels of `repro_torch.kernels`; the functions here are plain PyTorch,
as the reference computes them in `jnp` outside any Pallas kernel, with
its roundings: scores in q's dtype, then fp32 for the softmax, and the
probabilities rounded to q's dtype before P V. `models.model.forward`
and `train_loss` use them because they need autograd, which the kernels
do not have; `decode_step` uses `decode_attention` on the contiguous
cache, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.layers import dense_init, linear
from repro_torch.parallel.sharding import (constrain, einsum, softmax,
                                           split_last, unflatten, write_rows)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Split-half rotary embedding in fp32. x: (B, S, H, D); positions:
    (B, S) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)            # (D/2,)
    ang = positions[..., None].float() * freqs                # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_sections(half: int, sections=(2, 1, 1)) -> torch.Tensor:
    """The section (0 t, 1 h, 2 w) of each of the `half` rotary channels.
    The reference draws it with `jnp.digitize(chan, bounds)`, whose bins
    are closed on the left: channel 32 of a 128-wide head opens section 1.
    `torch.bucketize` matches that only with `right=True`."""
    tot = sum(sections)
    bounds, acc = [], 0
    for s in sections:
        acc += (half * s) // tot
        bounds.append(acc)
    bounds[-1] = half
    return torch.bucketize(torch.arange(half), torch.tensor(bounds[:-1]),
                           right=True)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(2, 1, 1)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head_dim/2 rotary channels split into (t, h,
    w) sections (ratio 2:1:1), each rotated by its own position row;
    positions3: (3, B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(d, theta, device=x.device)            # (half,)
    sec = mrope_sections(half, sections).to(x.device)
    pos = positions3[sec].movedim(0, -1).float()             # (B, S, half)
    ang = pos * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def positions_for(rope_kind: str, batch: int, seq: int, device=None):
    base = torch.arange(seq, dtype=torch.int32,
                        device=device)[None].expand(batch, seq)
    if rope_kind == "mrope":
        return base[None].expand(3, batch, seq)
    return base


def rotate(rope_kind: str, x, positions, theta):
    if rope_kind == "rope":
        return apply_rope(x, positions, theta)
    if rope_kind == "mrope":
        return apply_mrope(x, positions, theta)
    if rope_kind == "none":
        return x
    raise NotImplementedError(f"unknown rope kind {rope_kind!r}")


def init_attention(d_model: int, n_q: int, n_kv: int, head_dim: int, *,
                   device, generator: torch.Generator,
                   dtype=torch.bfloat16):
    kw = dict(device=device, generator=generator, dtype=dtype)
    return {
        "wq": dense_init(d_model, n_q * head_dim, **kw),
        "wk": dense_init(d_model, n_kv * head_dim, **kw),
        "wv": dense_init(d_model, n_kv * head_dim, **kw),
        "wo": dense_init(n_q * head_dim, d_model, **kw),
    }


def qkv(p, x: torch.Tensor, n_q: int, n_kv: int, head_dim: int, qcfg=None):
    q = split_last(linear(x, p["wq"], qcfg), n_q, head_dim)
    k = split_last(linear(x, p["wk"], qcfg), n_kv, head_dim)
    v = split_last(linear(x, p["wv"], qcfg), n_kv, head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# Attention math (GQA-aware), plain PyTorch
# ---------------------------------------------------------------------------

NEG_INF = -1e30
CHUNKED_THRESHOLD = 2048    # use online-softmax blocks above this seq len


def _root(d: int, dtype) -> torch.Tensor:
    """sqrt(d) in fp32, rounded to `dtype`, as the reference's
    `jnp.sqrt(D).astype(q.dtype)`."""
    return torch.tensor(math.sqrt(d), dtype=torch.float32).to(dtype)


def _gqa_scores(q, k):
    """q: (B,Sq,Hq,D), k: (B,Sk,Hkv,D) -> scores (B,Hkv,G,Sq,Sk) in q's
    dtype."""
    Hq, D = q.shape[2], q.shape[3]
    Hkv = k.shape[2]
    qg = unflatten(q, 2, (Hkv, Hq // Hkv))
    return einsum("bqhgd,bkhd->bhgqk", qg, k) / _root(D, q.dtype).to(
        q.device)


def _softmax_pv(s, v, q):
    """fp32 softmax of the masked scores, rounded to q's dtype, times V:
    (B,Hkv,G,Sq,Sk) x (B,Sk,Hkv,D) -> (B,Sq,Hq,D)."""
    B, Sq, Hq, D = q.shape
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(B, Sq, Hq, D)


def causal_attention(q, k, v, *, q_offset: int = 0,
                     kv_len: Optional[torch.Tensor] = None):
    """Full (training/prefill) causal attention, fp32 softmax.

    q_offset: absolute position of q[0] (for chunked prefill).
    kv_len:   optional (B,) valid KV lengths (padding mask)."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = _gqa_scores(q, k).float()                        # (B,Hkv,G,Sq,Sk)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]                # (Sq, Sk)
    if kv_len is not None:
        mask = mask[None] & (kpos[None, None, :]
                             < kv_len.to(q.device)[:, None, None])
        mask = mask[:, None, None]                       # (B,1,1,Sq,Sk)
    s = torch.where(mask, s, NEG_INF)
    return _softmax_pv(s, v, q)


def causal_attention_chunked(q, k, v, *, block_q: int = 1024,
                             block_k: int = 1024):
    """Flash-style causal attention over q and KV blocks with an online
    softmax, in the reference's order of operations."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    block_q, block_k = min(block_q, S), min(block_k, S)
    assert S % block_q == 0 and S % block_k == 0
    scale = 1.0 / (D ** 0.5)
    qb = unflatten(unflatten(q, 2, (Hkv, G)), 1, (S // block_q, block_q))
    kb = unflatten(k, 1, (S // block_k, block_k))
    vb = unflatten(v, 1, (S // block_k, block_k))
    outs = []
    for qi in range(S // block_q):
        rows = qi * block_q + torch.arange(block_q, device=q.device)
        # (B,Hkv,G,bq,D) like q's block, so a sharded q shards them too
        acc = torch.zeros_like(qb[:, qi].permute(0, 2, 3, 1, 4),
                               dtype=torch.float32,
                               memory_format=torch.contiguous_format)
        m = torch.full_like(acc[..., :1], NEG_INF)
        l = torch.zeros_like(acc[..., :1])
        for ki in range(S // block_k):
            kblk, vblk = kb[:, ki], vb[:, ki]
            s = (einsum("bqhgd,bkhd->bhgqk", qb[:, qi], kblk)
                 * scale).float()                        # (B,Hkv,G,bq,bk)
            cols = ki * block_k + torch.arange(block_k, device=q.device)
            s = torch.where(cols[None, :] <= rows[:, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + einsum(
                "bhgqk,bkhd->bhgqd", p.to(vblk.dtype), vblk).float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)).to(q.dtype))
    # each (B,Hkv,G,bq,D) -> (B,S,Hq,D)
    o = torch.stack(outs, dim=1)                         # (B,nq,Hkv,G,bq,D)
    return o.permute(0, 1, 4, 2, 3, 5).reshape(B, S, Hq, D)


def bidirectional_attention(q, k, v):
    """Attention without a mask (the encoder's, and cross-attention)."""
    return _softmax_pv(_gqa_scores(q, k).float(), v, q)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode: q (B,1,Hq,D) against a contiguous cache
    (B,Hkv,S_max,D); cache_len (B,) valid lengths, the new token already
    written."""
    B, _, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = unflatten(q, 2, (Hkv, Hq // Hkv))
    s = einsum("bqhgd,bhkd->bhgqk", qg, k_cache) / _root(
        D, q.dtype).to(q.device)
    s = s.float()                                        # (B,Hkv,G,1,S)
    mask = torch.arange(S, device=q.device)[None, :] < \
        cache_len.to(q.device)[:, None]                  # (B,S)
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = softmax(s, dim=-1).to(q.dtype)
    o = einsum("bhgqk,bhkd->bqhgd", p, v_cache)
    return o.reshape(B, 1, Hq, D)


def decode_attention_partial(q, k_cache, v_cache, valid_mask):
    """Flash-decoding partial softmax over one shard of a sequence-sharded
    cache: q (B,1,Hq,D); caches (B,Hkv,S_shard,D); valid_mask
    (B,S_shard). Returns (numerator (B,1,Hq,D) fp32, denominator
    (B,1,Hq,1) fp32, running max (B,1,Hq,1) fp32, -inf where the shard
    holds no valid key), for an exact combine across shards."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[1]
    qg = unflatten(q, 2, (Hkv, Hq // Hkv))
    s = einsum("bqhgd,bhkd->bhgqk", qg, k_cache) / _root(
        D, q.dtype).to(q.device)
    s = s.float()                                        # (B,Hkv,G,1,S)
    s = torch.where(valid_mask[:, None, None, None, :], s, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(s - m_safe) * torch.isfinite(s)
    num = einsum("bhgqk,bhkd->bqhgd", e.to(q.dtype), v_cache)
    denom = e.sum(dim=-1, keepdim=True)                  # (B,Hkv,G,1,1)
    num = num.float().reshape(B, 1, Hq, D)
    denom = denom.permute(0, 3, 1, 2, 4).reshape(B, 1, Hq, 1)
    m_out = m_safe.permute(0, 3, 1, 2, 4).reshape(B, 1, Hq, 1)
    m_out = torch.where(denom > 0, m_out, -math.inf)
    return num, denom, m_out


def update_cache(k_cache, v_cache, k_new, v_new, index):
    """Write one decode step into (B,Hkv,S,D) caches at per-slot `index`
    (B,); returns new caches, the given ones untouched
    (`parallel.sharding.write_rows`)."""
    index = index.long().to(k_cache.device)
    return (write_rows(k_cache, k_new, index),
            write_rows(v_cache, v_new, index))


def fill_cache(k_cache, v_cache, k, v):
    """Write a full prefill (B,S,Hkv,D) into (B,Hkv,S_max,D) caches;
    returns new caches."""
    S = k.shape[1]
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    k_cache[:, :, :S] = k.transpose(1, 2).to(k_cache.dtype)
    v_cache[:, :, :S] = v.transpose(1, 2).to(v_cache.dtype)
    return k_cache, v_cache


def init_cross_attention(d_model: int, n_q: int, n_kv: int, head_dim: int,
                         **kw):
    return init_attention(d_model, n_q, n_kv, head_dim, **kw)


def cross_attention(p, x, enc_k, enc_v, n_q, n_kv, head_dim, qcfg=None,
                    attend=None):
    """x: (B,Sq,d); enc_k/enc_v precomputed (B,Se,Hkv,D). `attend(q, k,
    v)`: the attention without a mask, `bidirectional_attention` unless
    given (the prefill passes the flash op)."""
    B, Sq, _ = x.shape
    q = split_last(linear(x, p["wq"], qcfg), n_q, head_dim)
    o = (attend or bidirectional_attention)(q, enc_k, enc_v)
    o = constrain(o, "batch", "seq", "qheads", None)
    return linear(o.reshape(B, Sq, n_q * head_dim), p["wo"], qcfg)
