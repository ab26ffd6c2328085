"""Mamba-style selective SSM block: prefill over a sequence and the
O(1)-state decode step.

Counterpart of `repro.models.ssm`. State carried between decode steps:
  conv: (B, d_conv-1, d_inner) bf16  last inputs of the causal depthwise conv
  h:    (B, d_inner, d_state)  fp32  SSM hidden state

The recurrence runs in this package's selective-scan kernel
(`kernels.ssm_scan`) at prefill, from a zero state, and at decode, from
the carried `h`; the reference model calls its plain `mamba_scan_ref`
instead. The conv state is stored in bf16 whatever the parameters' dtype,
as the reference stores it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models.layers import dense_init, linear
from repro_torch.quant import dequantize


def _dims(d_model: int, cfg: SSMConfig) -> Tuple[int, int]:
    di = cfg.expand * d_model
    dtr = cfg.dt_rank or -(-d_model // 16)
    return di, dtr


def init_mamba(d_model: int, cfg: SSMConfig, *, device,
               generator: torch.Generator, dtype=torch.bfloat16) -> Dict:
    """Projections normal × 0.02 as the reference draws them; A_log =
    log(1..N) per channel, D = 1 and dt_bias = 0, all fp32."""
    di, dtr = _dims(d_model, cfg)
    kw = dict(device=device, generator=generator, dtype=dtype)
    A = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                     device=device).expand(di, cfg.d_state).contiguous()
    return {
        "in_proj": dense_init(d_model, 2 * di, **kw),
        "conv_w": dense_init(di, cfg.d_conv, **kw),
        "x_proj": dense_init(di, dtr + 2 * cfg.d_state, **kw),
        "dt_proj": dense_init(dtr, di, **kw),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=device),
        "A_log": torch.log(A),                     # (di, N) fp32
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(di, d_model, **kw),
    }


def _weight(wp, dtype):
    if isinstance(wp, dict):
        q, s = wp["q"], wp["scale"]
        return q.to(dtype) if s is None else dequantize(q, s).to(dtype)
    return wp.to(dtype)


def _ssm_inputs(p, xz, cfg: SSMConfig, conv_state=None, qcfg=None):
    """Shared front half: split, causal conv, input-dependent discretization.

    xz: (B, S, 2*di). Returns (u, dt, Bm, Cm, z, new_conv_state) where
      u (B,S,di), dt (B,S,di) fp32, Bm/Cm (B,S,N) fp32, z gate (B,S,di).
    """
    di = xz.shape[-1] // 2
    x, z = xz[..., :di], xz[..., di:]
    k, S = cfg.d_conv, xz.shape[1]
    # causal depthwise conv along S with state from previous steps
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, di), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                          # (B, S+k-1, di)
    new_conv = xp[:, -(k - 1):, :]
    w = _weight(p["conv_w"], x.dtype)                        # (di, k)
    u = 0
    for i in range(k):        # the reference's sum(), left to right
        u = u + xp[:, i:i + S, :] * w[:, i]
    u = F.silu(u)

    proj = linear(u, p["x_proj"], qcfg).float()              # (B,S,dtr+2N)
    N = cfg.d_state
    dtr = proj.shape[-1] - 2 * N
    dt_r, Bm, Cm = proj[..., :dtr], proj[..., dtr:dtr + N], proj[..., dtr + N:]
    v = linear(dt_r.to(x.dtype), p["dt_proj"], qcfg).float() + p["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros_like(v))             # jax softplus
    return u, dt, Bm.contiguous(), Cm.contiguous(), z, new_conv


def _scan(p, u, dt, Bm, Cm, h0=None):
    A = -torch.exp(p["A_log"])
    return ssm_scan(u.float().contiguous(), dt, Bm, Cm, A, p["D"], h0)


def apply_mamba(p, x: torch.Tensor, cfg: SSMConfig, qcfg=None):
    """Prefill path from a zero state. x: (B,S,d) -> (y (B,S,d), state)."""
    xz = linear(x, p["in_proj"], qcfg)
    u, dt, Bm, Cm, z, conv = _ssm_inputs(p, xz, cfg, None, qcfg)
    y, h = _scan(p, u, dt, Bm, Cm)
    y = y.to(x.dtype) * F.silu(z)
    out = linear(y, p["out_proj"], qcfg)
    return out, {"conv": conv.to(torch.bfloat16), "h": h}


def mamba_decode_step(p, x: torch.Tensor, state, cfg: SSMConfig, qcfg=None):
    """Single-token decode. x: (B,1,d); state {conv (B,k-1,di), h (B,di,N)}."""
    xz = linear(x, p["in_proj"], qcfg)
    u, dt, Bm, Cm, z, conv = _ssm_inputs(p, xz, cfg, state["conv"], qcfg)
    y, h = _scan(p, u, dt, Bm, Cm, h0=state["h"])
    y = y.to(x.dtype) * F.silu(z)
    out = linear(y, p["out_proj"], qcfg)
    return out, {"conv": conv.to(torch.bfloat16), "h": h}


def init_mamba_state(batch: int, d_model: int, cfg: SSMConfig, *, device):
    di, _ = _dims(d_model, cfg)
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, di),
                                dtype=torch.bfloat16, device=device),
            "h": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                             device=device)}
