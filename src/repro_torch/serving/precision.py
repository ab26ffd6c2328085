"""Numeric-precision policy for the jit fleet backend.

The numpy fleet (`serving.fleet`) is float64 by construction and its
RunRecords are *bitwise* commitments (the committed stores). The jit
backend (`serving.fleet_jit`) runs the same float64 event loop as one
CUDA kernel (`kernels.fleet_loop`), or through that kernel's plain
PyTorch version on the CPU. float64 is native to both, so there is no
switch to flip; this module keeps the reference's API so that callers
and tests read one policy:

* `enable_x64()` — idempotent; returns True (64-bit mode is always
  active in the port).
* `active_x64()` — True once `enable_x64` has run.
* `jit_tolerance()` — the documented jit-vs-numpy RunRecord agreement
  bound as ``(rtol, atol)``. The kernel is compiled without mul+add
  contraction (`kernels/build.py`), so it should replay the numpy
  fleet's float64 op sequence bit for bit; the gate stays the
  reference's tolerance, and the count of inexact fields is reported
  beside it. The float32 bound is the reference's, kept for callers
  that read it.

The numpy path never reads this module, so enabling it cannot move a
single bit of the committed stores.
"""
from __future__ import annotations

from typing import Tuple

# documented jit-vs-numpy RunRecord agreement (rtol, atol): the x64 bound
# absorbs FMA contraction over ~1e5-step clock accumulations; the f32
# bound is the honest precision of a float32 event clock
X64_TOLERANCE = (1e-9, 1e-12)
F32_TOLERANCE = (2e-3, 1e-4)

_STATE = {"enabled": None}


def enable_x64() -> bool:
    """Idempotently enable 64-bit mode; returns True (float64 is native
    to torch, on the CPU and on the card)."""
    if _STATE["enabled"] is None:
        _STATE["enabled"] = True
    return _STATE["enabled"]


def active_x64() -> bool:
    """True iff `enable_x64` has run and 64-bit mode is active."""
    return bool(_STATE["enabled"])


def jit_tolerance() -> Tuple[float, float]:
    """(rtol, atol) for jit-vs-numpy RunRecord comparisons under the
    currently active precision (call `enable_x64` first)."""
    return X64_TOLERANCE if active_x64() else F32_TOLERANCE
