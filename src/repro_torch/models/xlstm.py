"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar
memory), each with stabilized exponential gating, over a sequence from a
given or a fresh state.

Counterpart of `repro.models.xlstm`, with the same parameter names. The
reference runs time in `lax.scan`; the port runs it in a Python loop, one
step at a time in the same order of operations, so the two round alike
(a chunkwise-parallel form would not). No hand-written kernel: the
reference has no Pallas kernel for these recurrences either.

mLSTM state: C (B, H, Dk, Dv) matrix memory, n (B, H, Dk) normalizer,
             m (B, H) gate stabilizer (-inf before the first step).
sLSTM state: c, n (B, d) scalar cells, m (B, d) stabilizer,
             h (B, d) recurrent output.
All states fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMConfig
from repro_torch.models.layers import (apply_norm, dense_init, init_norm,
                                      linear)
from repro_torch.quant import dequantize

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(d: int, n_heads: int, cfg: XLSTMConfig, *, device,
               generator: torch.Generator, dtype=torch.bfloat16) -> Dict:
    di = int(cfg.mlstm_proj_factor * d)
    kw = dict(device=device, generator=generator, dtype=dtype)
    return {
        "mlstm_up": dense_init(d, 2 * di, **kw),
        "mlstm_q": dense_init(di, di, **kw),
        "mlstm_k": dense_init(di, di, **kw),
        "mlstm_v": dense_init(di, di, **kw),
        "mlstm_if": dense_init(di, 2 * n_heads, **kw),      # i, f gates
        "mlstm_norm": init_norm("rmsnorm", di, device=device, dtype=dtype),
        "mlstm_down": dense_init(di, d, **kw),
    }


def init_mlstm_state(batch: int, d: int, n_heads: int, cfg: XLSTMConfig, *,
                     device) -> Dict[str, torch.Tensor]:
    dh = int(cfg.mlstm_proj_factor * d) // n_heads
    return _mlstm_zeros(batch, n_heads, dh, device)


def _mlstm_zeros(batch: int, n_heads: int, dh: int, device):
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, n_heads, dh, dh), **kw),
            "n": torch.zeros((batch, n_heads, dh), **kw),
            "m": torch.full((batch, n_heads), -math.inf, **kw)}


def mlstm_seq(p, x: torch.Tensor, n_heads: int, cfg: XLSTMConfig,
              state=None, qcfg=None) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d). Returns (y (B, S, d), new state); `state` is read,
    never written."""
    B, S, d = x.shape
    u, z = linear(x, p["mlstm_up"], qcfg).chunk(2, dim=-1)      # (B,S,di)
    di = u.shape[-1]
    dh = di // n_heads
    q = linear(u, p["mlstm_q"], qcfg).reshape(B, S, n_heads, dh)
    # the reference divides by a weakly typed scalar: the divisor is first
    # rounded to k's dtype, and the quotient stays in it
    root = torch.tensor(math.sqrt(dh), dtype=torch.float32).to(x.dtype)
    k = linear(u, p["mlstm_k"], qcfg).reshape(B, S, n_heads, dh) / root
    v = linear(u, p["mlstm_v"], qcfg).reshape(B, S, n_heads, dh)
    gf = linear(u, p["mlstm_if"], qcfg).float()                 # (B,S,2H)
    logi, logf = gf.chunk(2, dim=-1)
    logf = F.logsigmoid(logf)

    if state is None:
        state = _mlstm_zeros(B, n_heads, dh, x.device)
    C, n, m = state["C"], state["n"], state["m"]

    hs = []
    for t in range(S):
        li, lf = logi[:, t], logf[:, t]                         # (B, H)
        m_new = torch.maximum(lf + m, li)
        i_g = torch.exp(li - m_new)
        f_g = torch.exp(lf + m - m_new)
        kf, vf = k[:, t].float(), v[:, t].float()               # (B,H,dh)
        C = f_g[..., None, None] * C + i_g[..., None, None] * (
            kf[..., :, None] * vf[..., None, :])                # (B,H,dk,dv)
        n = f_g[..., None] * n + i_g[..., None] * kf
        qf = q[:, t].float()
        num = torch.einsum("bhkv,bhk->bhv", C, qf)
        den = torch.einsum("bhk,bhk->bh", n, qf).abs()
        den = torch.maximum(den, torch.exp(-m_new))   # max(|n q|, e^-m)
        hs.append(num / den[..., None])
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, di).to(x.dtype)
    h = apply_norm(p["mlstm_norm"], h, "rmsnorm")
    y = linear(h * F.silu(z), p["mlstm_down"], qcfg)
    return y, {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(d: int, cfg: XLSTMConfig, *, device,
               generator: torch.Generator, dtype=torch.bfloat16) -> Dict:
    ff = int(cfg.slstm_proj_factor * d)
    kw = dict(device=device, generator=generator, dtype=dtype)
    return {
        "slstm_wx": dense_init(d, 4 * d, **kw),    # i, f, z, o from input
        "slstm_wr": dense_init(d, 4 * d, **kw),    # recurrent
        "slstm_up": dense_init(d, ff, **kw),
        "slstm_down": dense_init(ff, d, **kw),
    }


def init_slstm_state(batch: int, d: int, *, device
                     ) -> Dict[str, torch.Tensor]:
    kw = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **kw),
            "n": torch.ones((batch, d), **kw),
            "m": torch.zeros((batch, d), **kw),
            "h": torch.zeros((batch, d), **kw)}


def slstm_seq(p, x: torch.Tensor, cfg: XLSTMConfig, state=None, qcfg=None
              ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (y (B, S, d), new state); `state` is read, never
    written. The recurrent product runs in fp32 on the fp32 cast of
    `slstm_wr` (a quantized one dequantized to bf16 first, as the
    reference does)."""
    B, S, d = x.shape
    wx = linear(x, p["slstm_wx"], qcfg).float()                 # (B,S,4d)
    if state is None:
        state = init_slstm_state(B, d, device=x.device)
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]

    wr = p["slstm_wr"]
    if isinstance(wr, dict):
        wr = wr["q"] if wr["scale"] is None else dequantize(wr["q"],
                                                            wr["scale"])
    wrf = wr.float()

    hs = []
    for t in range(S):
        g = wx[:, t] + h @ wrf                                  # (B, 4d)
        gi, gf, gz, go = g.chunk(4, dim=-1)
        m_new = torch.maximum(gf + m, gi)                       # log-space f
        i_g = torch.exp(gi - m_new)
        f_g = torch.exp(gf + m - m_new)
        c = f_g * c + i_g * torch.tanh(gz)
        n = f_g * n + i_g
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)                      # (B,S,d)
    ff = F.gelu(linear(y, p["slstm_up"], qcfg), approximate="tanh")
    out = linear(ff, p["slstm_down"], qcfg)
    return out, {"c": c, "n": n, "m": m, "h": h}
