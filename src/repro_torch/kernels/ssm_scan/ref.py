"""Plain PyTorch selective scan (the Mamba recurrence), sequential over S.

It computes what the Pallas kernel `repro.kernels.ssm_scan.kernel`
computes, op for op as `repro.kernels.ssm_scan.ref.ssm_scan_ref`, all in
fp32:
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
    y_t = h_t . C_t + D * u_t
The dot product over N is an elementwise product and a sum, not the
reference's einsum: on the CPU, PyTorch's einsum goes to a batched GEMM
whose result changed from run to run by up to 1.6e-4 on unit-normal
inputs, the order of the tests' own tolerance.
"""
from __future__ import annotations

import torch


def ssm_scan_ref(u, dt, Bm, Cm, A, D, h0=None):
    """u/dt: (B, S, di); Bm/Cm: (B, S, N); A: (di, N); D: (di,); h0:
    (B, di, N) or None for a zero state. Returns (y (B, S, di) fp32,
    h_final (B, di, N) fp32)."""
    Bsz, S, di = u.shape
    u, dt, Bm, Cm = (a.float() for a in (u, dt, Bm, Cm))
    h = (torch.zeros((Bsz, di, A.shape[1]), dtype=torch.float32,
                     device=u.device) if h0 is None else h0.float())
    ys = []
    for t in range(S):
        u_t, dt_t = u[:, t], dt[:, t]
        dA = torch.exp(dt_t[..., None] * A)
        h = dA * h + (dt_t * u_t)[..., None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(dim=-1) + D * u_t)
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((Bsz, 0, di), dtype=torch.float32, device=u.device))
    return y, h
