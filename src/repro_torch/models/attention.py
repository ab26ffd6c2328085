"""GQA attention projections and rotary embeddings.

Counterpart of `repro.models.attention`, dense decoder subset. Layouts as
the reference: q `(B, S, Hq, D)`, k/v `(B, S, Hkv, D)`. The attention
itself runs in the kernels of `repro_torch.kernels`; M-RoPE and the
other variants arrive with the slices that need them.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init
from repro_torch.quant import linear


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


def rotate(rope_kind: str, x, positions, theta):
    if rope_kind == "rope":
        return apply_rope(x, positions, theta)
    if rope_kind == "none":
        return x
    raise NotImplementedError(
        f"rope kind {rope_kind!r} is not ported yet (ROADMAP Queue A)")


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
    B, S, _ = x.shape
    q = linear(x, p["wq"], qcfg).reshape(B, S, n_q, head_dim)
    k = linear(x, p["wk"], qcfg).reshape(B, S, n_kv, head_dim)
    v = linear(x, p["wv"], qcfg).reshape(B, S, n_kv, head_dim)
    return q, k, v
