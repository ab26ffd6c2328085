"""Dispatch for the selective scan: the CUDA kernel for tensors on the
card, the plain version for tensors on the CPU. There is no fallback: a
CUDA tensor the kernel does not take raises."""
from __future__ import annotations

from repro_torch.kernels.ssm_scan.kernel import ssm_scan_kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


def ssm_scan(u, dt, Bm, Cm, A, D, h0=None):
    """u/dt: (B, S, di) fp32; Bm/Cm: (B, S, N) fp32; A: (di, N) fp32; D:
    (di,) fp32; h0: (B, di, N) fp32 or None for a zero state. Returns
    (y (B, S, di) fp32, h_final (B, di, N) fp32)."""
    if u.device.type == "cpu":
        return ssm_scan_ref(u, dt, Bm, Cm, A, D, h0)
    return ssm_scan_kernel(u, dt, Bm, Cm, A, D, h0)
