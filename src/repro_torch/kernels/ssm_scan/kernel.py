"""Binding of the hand-written CUDA selective-scan kernel.

The kernel is `csrc/ssm_scan.cu` (it replaces the Pallas
`repro.kernels.ssm_scan.kernel.ssm_scan_kernel`): a chunked prefill scan
and, for S == 1, a one-step decode kernel, chosen inside the library (one
launch a call). This wrapper checks its inputs, allocates the outputs,
launches on PyTorch's current stream and counts its launches in
`ssm_scan_kernel.launches`. `layout(N)` reads the prefill kernel's chunk,
ring and grid from the library.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# compiled for these state sizes: jamba-v0.1-52b's 16 and `reduced()`'s 4
D_STATES = (4, 16)


def _lib():
    lib = build.load("ssm_scan")
    fn = lib.ssm_scan_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
    return lib


LAYOUT_KEYS = ("chunk", "stages", "lanes", "channels_per_block", "threads",
               "smem_bytes", "resident_blocks_per_sm")


def layout(N: int = 16, lib=None) -> dict:
    """The prefill kernel's layout for d_state N, as the built library (or
    `lib`, another build of `csrc/ssm_scan.cu`) reports it: time steps a
    chunk, ring stages, lanes a channel, channels and threads a block,
    shared memory a block, and the blocks an SM holds at once
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    lib = lib or _lib()
    out = (ctypes.c_int * len(LAYOUT_KEYS))()
    lib.ssm_scan_layout.restype = ctypes.c_int
    lib.ssm_scan_layout.argtypes = [ctypes.c_int, ctypes.c_void_p]
    build.check(lib, lib.ssm_scan_layout(N, out), "ssm_scan layout")
    if out[-1] < 0:
        build.check(lib, -out[-1], "ssm_scan occupancy")
    return dict(zip(LAYOUT_KEYS, out))


def ssm_scan_kernel(u, dt, Bm, Cm, A, D, h0=None):
    """u/dt: (B, S, di) fp32; Bm/Cm: (B, S, N) fp32; A: (di, N) fp32; D:
    (di,) fp32; h0: (B, di, N) fp32, or None for a zero state (then not
    read). All contiguous on one card; any S and di. Returns (y (B, S, di)
    fp32, h_final (B, di, N) fp32)."""
    tensors = [t for t in (u, dt, Bm, Cm, A, D, h0) if t is not None]
    if any(t.device.type != "cuda" or t.device != u.device
           for t in tensors):
        raise ValueError("ssm_scan_kernel: all inputs must be on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssm_scan_kernel: inputs must be float32")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("ssm_scan_kernel: inputs must be contiguous")
    if u.ndim != 3 or A.ndim != 2:
        raise ValueError("ssm_scan_kernel: need u (B, S, di) and A (di, N)")
    B, S, di = u.shape
    N = A.shape[1]
    if dt.shape != u.shape or Bm.shape != (B, S, N) or \
            Cm.shape != (B, S, N) or A.shape != (di, N) or \
            D.shape != (di,) or (h0 is not None and h0.shape != (B, di, N)):
        raise ValueError("ssm_scan_kernel: inconsistent shapes")
    if N not in D_STATES:
        raise ValueError(f"ssm_scan_kernel: d_state {N} not compiled (have "
                         f"{D_STATES})")
    if A.data_ptr() % 16 or (h0 is not None and h0.data_ptr() % 16):
        raise ValueError("ssm_scan_kernel: A and h0 must be 16-byte aligned")
    y = torch.empty((B, S, di), dtype=torch.float32, device=u.device)
    h_final = torch.empty((B, di, N), dtype=torch.float32, device=u.device)
    if B == 0 or di == 0:
        return y, h_final
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssm_scan_f32(
            u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), D.data_ptr(), 0 if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), B, S, di, N, stream)
    build.check(lib, err, "ssm_scan_kernel")
    ssm_scan_kernel.launches += 1
    return y, h_final


ssm_scan_kernel.launches = 0
