"""Binding of the hand-written CUDA fleet-loop kernel.

The kernel is `csrc/fleet_loop.cu` (+ `csrc/fleet_loop.cuh`); it replaces
the jit fleet's compiled phase, `repro.serving.fleet_jit._compiled_phase`
(one XLA `lax.while_loop`): one thread runs one lane's event loop to its
end. This wrapper checks its inputs, stacks the per-lane constants into
the kernel's two tables, allocates the outputs (the cohort logs zeroed),
launches on PyTorch's current stream and counts its launches in
`fleet_loop_kernel.launches`. `fleet_loop_kernel.skip_budget_cut = True`
plants the checks' fault: the budget cut is skipped, so a decode burst is
not clipped at the next arrival.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fleet_loop.ref import EC_FIELDS, MODEL_FIELDS


def _lib():
    lib = build.load("fleet_loop")
    fn = lib.fleet_loop_f64
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 16 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
    return lib


def fleet_loop_kernel(md, ec, r_arr, cap: int) -> dict:
    """md: {field: (B,) float64 (`is_moe` bool)}; ec: {`EC_FIELDS`: (B,)
    int64, "horizon": (B,) float64}; r_arr: (B, W) float64, rows sorted and
    +inf padded; all on one card. Returns what `fleet_loop_ref` returns,
    except that the dump column W - 1 of the logs stays 0."""
    r_arr = r_arr.contiguous()
    dev = r_arr.device
    B, W = r_arr.shape
    tensors = [md[k] for k in MODEL_FIELDS] + [ec[k] for k in EC_FIELDS] \
        + [ec["horizon"], r_arr]
    if any(x.device.type != "cuda" or x.device != dev for x in tensors):
        raise ValueError("fleet_loop_kernel: all inputs must be on one CUDA "
                         "device")
    if r_arr.dtype != torch.float64 or ec["horizon"].dtype != torch.float64 \
            or any(ec[k].dtype != torch.int64 for k in EC_FIELDS) \
            or any(md[k].dtype != torch.float64 for k in MODEL_FIELDS
                   if k != "is_moe") or md["is_moe"].dtype != torch.bool:
        raise TypeError("fleet_loop_kernel: md float64 (is_moe bool), ec "
                        "int64, horizon and r_arr float64")
    if any(x.shape != (B,) for x in tensors[:-1]) or W < 1:
        raise ValueError("fleet_loop_kernel: inconsistent shapes")
    # the integer quotients of the round need these (C truncates where
    # the reference floors; with these signs the two agree)
    if bool((ec["uplen"] < 1).any()) or bool((ec["uneed"] < 1).any()) \
            or bool((ec["pf_budget"] < 0).any()):
        raise ValueError("fleet_loop_kernel: uplen and uneed must be >= 1 "
                         "and pf_budget >= 0")
    mdt = torch.stack([md[k].to(torch.float64) for k in MODEL_FIELDS])
    ect = torch.stack([ec[k] for k in EC_FIELDS])
    horizon = ec["horizon"].contiguous()
    i64, f64 = torch.int64, torch.float64
    out = {"live": torch.empty(B, dtype=torch.bool, device=dev),
           "stall": torch.empty(B, dtype=torch.bool, device=dev),
           "t": torch.empty(B, dtype=f64, device=dev),
           "area": torch.empty(B, dtype=f64, device=dev)}
    for k in ("ncomp", "crd", "ne", "rounds"):
        out[k] = torch.empty(B, dtype=i64, device=dev)
    for k, dt in (("KadmE", i64), ("QadmE", i64), ("TfirstE", f64),
                  ("TfinE", f64)):
        out[k] = torch.zeros((B, W), dtype=dt, device=dev)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fleet_loop_f64(
            mdt.data_ptr(), ect.data_ptr(), horizon.data_ptr(),
            r_arr.data_ptr(),
            *(out[k].data_ptr() for k in (
                "live", "stall", "t", "area", "ncomp", "crd", "ne", "rounds",
                "KadmE", "QadmE", "TfirstE", "TfinE")),
            B, W, int(cap), int(bool(fleet_loop_kernel.skip_budget_cut)),
            stream)
    build.check(lib, err, "fleet_loop_kernel")
    fleet_loop_kernel.launches += 1
    return out


fleet_loop_kernel.launches = 0
fleet_loop_kernel.skip_budget_cut = False
