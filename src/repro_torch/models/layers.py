"""Shared building blocks: norms, MLPs, softcap, initialisers, the loss.

Counterpart of `repro.models.layers`. Parameters are plain dictionaries
of tensors in the reference's layout; matmuls go through
`linear` (`repro_torch.quant.linear`, a DTensor's contraction aligned
first).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import quant
from repro_torch.parallel.sharding import (align_contraction, constrain,
                                           take_last)

INIT_STD = 0.02


def linear(x: torch.Tensor, w, qcfg=None) -> torch.Tensor:
    """`quant.linear(x, w, qcfg)`, a DTensor x's contraction first aligned
    to a weight sharded on it (`parallel.sharding.align_contraction`); a
    plain x goes as it is."""
    return quant.linear(align_contraction(x, w), w, qcfg)


def dense_init(d_in: int, d_out: int, *, device, generator: torch.Generator,
               dtype=torch.bfloat16) -> torch.Tensor:
    """normal(0, 1) × 0.02 drawn in fp32, then cast (as `layers.py:19-20`)."""
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32)
    return (w * INIT_STD).to(dtype)


def embed_init(vocab: int, d: int, *, device, generator: torch.Generator,
               dtype=torch.bfloat16) -> torch.Tensor:
    return dense_init(vocab, d, device=device, generator=generator,
                      dtype=dtype)


def init_norm(kind: str, d: int, *, device, dtype=torch.bfloat16):
    p = {"scale": torch.ones((d,), device=device, dtype=dtype)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=device, dtype=dtype)
    return p


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    """RMSNorm or LayerNorm computed in fp32, result in x's dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def init_mlp(d: int, ff: int, kind: str, *, device,
             generator: torch.Generator, dtype=torch.bfloat16):
    if ff == 0:
        return None
    kw = dict(device=device, generator=generator, dtype=dtype)
    if kind == "swiglu":
        return {"gate": dense_init(d, ff, **kw), "up": dense_init(d, ff, **kw),
                "down": dense_init(ff, d, **kw)}
    return {"up": dense_init(d, ff, **kw), "down": dense_init(ff, d, **kw)}


def apply_mlp(p, x: torch.Tensor, kind: str, qcfg=None) -> torch.Tensor:
    if p is None:
        return torch.zeros_like(x)
    if kind == "swiglu":
        h = F.silu(linear(x, p["gate"], qcfg)) * linear(x, p["up"], qcfg)
    elif kind == "relu2":
        h = torch.relu(linear(x, p["up"], qcfg)).square()
    else:  # gelu, tanh approximation as the reference's approximate=True
        h = F.gelu(linear(x, p["up"], qcfg), approximate="tanh")
    return linear(h, p["down"], qcfg)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask=None) -> torch.Tensor:
    """Token-mean cross entropy in fp32; with `mask`, the mean over the
    tokens it keeps (at least one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = take_last(logits, labels.long())
    # held to the batch's sharding, the gradient too: the mean's backward
    # would otherwise hand every rank the whole batch's gradient
    nll = constrain(logz - ll, "batch", "seq")
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
