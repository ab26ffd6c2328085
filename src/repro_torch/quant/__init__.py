"""Quantization substrate — the paper's Q axis; this slice ports bf16 only.

Counterpart of `repro.quant`. `linear` is `x @ w` with weights in the
reference's `(d_in, d_out)` layout, accumulated in fp32 and cast back to
x's dtype. The int8 and fp8 paths arrive with their own slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

VALID_MODES = ("bf16", "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "bf16"            # bf16 | int8 | fp8
    native: bool = True           # does the target silicon have native support?
    act_quant: bool = True        # quantize activations too (int8 path)

    def __post_init__(self):
        if self.mode not in VALID_MODES:
            raise ValueError(f"unknown quant mode {self.mode!r}")

    @property
    def weight_bytes(self) -> int:
        return 2 if self.mode == "bf16" else 1


def linear(x: torch.Tensor, w, qcfg: Optional[QuantConfig] = None
           ) -> torch.Tensor:
    """x @ w with fp32 accumulation, result in x's dtype.

    `w` is a raw `(d_in, d_out)` tensor. The card's bf16 GEMM accumulates
    in fp32; the runner turns off reduced-precision split-K reduction so
    partial sums are not rounded to bf16 either.
    """
    if isinstance(w, dict) or (qcfg is not None and qcfg.mode != "bf16"):
        raise NotImplementedError(
            "int8/fp8 linear is not ported yet (ROADMAP Queue A item 6)")
    return torch.matmul(x, w.to(x.dtype))
