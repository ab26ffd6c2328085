"""Binding of the hand-written CUDA 8-bit AdamW update.

The kernel is `csrc/adamw8bit.cu`: one launch updates one parameter leaf
in place (p, the int8 codes of both moments and their block scales). It
replaces no Pallas kernel; it is the counterpart of the XLA fusion that
the reference's jitted `adamw8bit` update compiles to, so that no fp32
copy of a leaf lands in device memory. This wrapper checks its inputs,
launches on PyTorch's current stream without synchronising (graph
capture allowed) and counts its launches in `adamw8bit_kernel.launches`.
`adamw8bit_kernel.skip_last_block = True` plants the checks' fault: the
last 256-wide block of every row keeps its old codes and scales.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.adamw8bit.ref import BLOCK, INV_127, f32, num_blocks

G_DTYPES = (torch.bfloat16, torch.float32)   # p is bf16


def _lib():
    lib = build.load("adamw8bit")
    fn = lib.adamw8bit_update
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + \
            [ctypes.c_float] * 8 + [ctypes.c_longlong] * 2 + \
            [ctypes.c_int, ctypes.c_void_p]
    return lib


def adamw8bit_kernel(g, p, m_q, m_scale, v_q, v_scale, bc1, bc2,
                     grad_scale=None, *, lr: float, b1: float, b2: float,
                     eps: float, weight_decay: float = 0.0,
                     block: int = BLOCK):
    """See `adamw8bit_update_ref` for the arguments; all on one card,
    contiguous. Writes p, m_q, m_scale, v_q and v_scale in place."""
    scalars = [bc1, bc2] + ([grad_scale] if grad_scale is not None else [])
    tensors = [g, p, m_q, m_scale, v_q, v_scale] + scalars
    if any(t.device.type != "cuda" or t.device != p.device for t in tensors):
        raise ValueError("adamw8bit_kernel: all inputs must be on one CUDA "
                         "device")
    if g.dtype not in G_DTYPES or p.dtype != torch.bfloat16 or \
            m_q.dtype != torch.int8 or v_q.dtype != torch.int8 or \
            any(t.dtype != torch.float32 for t in [m_scale, v_scale]
                + scalars):
        raise TypeError("adamw8bit_kernel: p bf16, g bf16 or fp32, codes "
                        "int8, scales and the step's scalars fp32")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("adamw8bit_kernel: inputs must be contiguous")
    if block != BLOCK:
        raise ValueError(f"adamw8bit_kernel: compiled for blocks of {BLOCK}")
    if p.ndim < 1 or any(t.shape != p.shape for t in (g, m_q, v_q)) or \
            any(t.shape != p.shape[:-1] + (num_blocks(p.shape[-1]),)
                for t in (m_scale, v_scale)) or \
            any(t.ndim != 0 for t in scalars):
        raise ValueError("adamw8bit_kernel: inconsistent shapes")
    last = p.shape[-1]
    rows = p.numel() // last if last else 0
    if rows == 0:
        return
    lib = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.adamw8bit_update(
            int(g.dtype == torch.bfloat16), g.data_ptr(), p.data_ptr(), m_q.data_ptr(), m_scale.data_ptr(),
            v_q.data_ptr(), v_scale.data_ptr(), bc1.data_ptr(),
            bc2.data_ptr(), 0 if grad_scale is None else grad_scale.data_ptr(),
            f32(lr), f32(b1), f32(1 - b1), f32(b2), f32(1 - b2),
            f32(eps * eps), f32(weight_decay), INV_127, rows, last,
            int(bool(adamw8bit_kernel.skip_last_block)), stream)
    build.check(lib, err, "adamw8bit_kernel")
    adamw8bit_kernel.launches += 1


adamw8bit_kernel.launches = 0
adamw8bit_kernel.skip_last_block = False
