"""Dispatch for the fleet's event loop: the CUDA kernel for tensors on the
card, the plain version for tensors on the CPU. There is no fallback: a
tensor on any other device, or a CUDA input the kernel does not take,
raises."""
from __future__ import annotations

from repro_torch.kernels.fleet_loop.kernel import fleet_loop_kernel
from repro_torch.kernels.fleet_loop.ref import fleet_loop_ref


def fleet_loop(md, ec, r_arr, cap: int) -> dict:
    """Run every lane's event loop to its end (or `cap` rounds). See
    `fleet_loop_ref` for the arguments and the returned dict."""
    if r_arr.device.type == "cpu":
        return fleet_loop_ref(md, ec, r_arr, cap)
    if r_arr.device.type == "cuda":
        return fleet_loop_kernel(md, ec, r_arr, cap)
    raise ValueError(f"fleet_loop: no version for device {r_arr.device}")
