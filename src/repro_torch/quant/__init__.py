"""Quantization substrate — the paper's Q axis.

Counterpart of `repro.quant`, all of it:

  * bf16  — the baseline.
  * int8  — per-output-channel int8 weights and dynamic per-tensor int8
            activations; the int8 x int8 -> int32 product runs in the
            hand-written CUDA kernel of `repro_torch.kernels.int8_matmul`
            (the plain version on the CPU).
  * fp8   — e4m3 weights, dequantized to bf16 before a bf16 matmul, both
            under `fp8` (emulated) and `fp8_native`, exactly as the
            reference does: it has no native fp8 GEMM either.

`QuantConfig` routes every matmul of the model. `quantize_tree` converts a
bf16 parameter tree into quantized storage: each weight matrix becomes
`{"q": (..., d_in, d_out) int8 or float8_e4m3fn, "scale": (..., 1, d_out)
fp32}`, with the reference's shapes and values.

Storage: the int8 kernel's tensor-core product takes the weight K-major,
so every int8 *matrix* (2-D: the attention projections, dense MLPs, the
Mamba and xLSTM projections and the lm_head, all of which `linear` reads)
is stored K-major, once: `q` is the `.mT` view of the first `d_in`
columns of a contiguous `(d_out, ceil(d_in / 16) * 16)` tensor, strides
`(1, ceil(d_in / 16) * 16)` (`k_major`): the kernel's TMA reads rows a
multiple of 16 bytes apart, and a zero tail past `d_in` (xlstm-350m's
sLSTM down projection, d_in 1365) is never read. Shapes and values stay
the reference's. Stacked int8 weights (3-D and
more: the MoE experts `(E, d, f)`, which on the card go to the grouped
GEMM of `kernels.moe_gemm`, not to this kernel, and which it reads
row-major) and fp8 weights keep the row-major layout.
The number of dimensions tells the two apart, since `linear` takes 2-D
weights only. `stored` is that rule; `quantize_weight` and
`weights.params_from_jax` both apply it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.int8_matmul.kernel import (ROW_BYTES, pad_rows,
                                                    padded)

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


BF16 = QuantConfig("bf16")
INT8 = QuantConfig("int8", native=True)
FP8_EMULATED = QuantConfig("fp8", native=False)
FP8_NATIVE = QuantConfig("fp8", native=True)

BY_NAME = {"bf16": BF16, "int8": INT8, "fp8": FP8_EMULATED,
           "fp8_native": FP8_NATIVE}

# Leaves that are not consumed by `linear` (lookups, convs, SSM tensors).
SKIP = {"embed", "pos_embed", "enc_pos_embed", "scale", "bias", "conv",
        "conv_w", "A_log", "D", "router", "dt_bias", "gates"}


# fl32(1/127). The served reference runs `linear` under `jax.jit`, where
# XLA turns `xamax / 127.0` into `xamax * 0.00787401572`: the activation
# scale is this product, not the quotient.
INV_127 = float(torch.tensor(1.0) / 127)


def _per_channel_scale(w: torch.Tensor, qmax: float) -> torch.Tensor:
    # Reduce over the contraction axis (-2) so stacked (..., d_in, d_out)
    # weights quantize per output channel of each matrix. The reference
    # quantizes eagerly, so it divides exactly. A tensor divisor keeps the
    # division exact on the card too: ATen divides a CUDA tensor by a
    # Python number as a product by the number's float32 reciprocal.
    amax = w.float().abs().amax(dim=-2, keepdim=True)
    return torch.clamp(amax, min=1e-8) / torch.tensor(qmax,
                                                      device=amax.device)


def k_major(q: torch.Tensor) -> torch.Tensor:
    """The same (K, N) matrix stored K-major: the `.mT` view of the first
    K columns of a contiguous (N, K_pad) tensor, K_pad = ceil(K / 16) * 16,
    strides (1, K_pad), its tail zeros. Copies unless it is stored so
    already."""
    K, N = q.shape
    ld = padded(K, ROW_BYTES)
    if q.stride() == (1, ld):
        return q
    buf = q.new_zeros((N, ld))
    buf[:, :K] = q.mT
    return buf[:, :K].mT


def stored(q: torch.Tensor) -> torch.Tensor:
    """A quantized weight in the layout the model keeps it in: an int8
    matrix K-major, anything else (stacked experts, fp8) as it is."""
    return k_major(q) if q.dtype == torch.int8 and q.ndim == 2 else q


def _quantized(w: torch.Tensor, mode: str):
    """(codes, per-channel scale) of `w` in `mode`, the codes row-major."""
    if mode == "int8":
        scale = _per_channel_scale(w, 127.0)
        q = torch.clamp(torch.round(w.float() / scale), -127, 127)
        return q.to(torch.int8), scale
    if mode not in ("fp8", "fp8_native"):
        raise ValueError(f"unknown quant mode {mode!r}")
    # fp8 e4m3 (both fp8 modes store the same bytes): max normal 448
    scale = _per_channel_scale(w, 448.0)
    return (w.float() / scale).to(torch.float8_e4m3fn), scale


# elements of a stack of matrices quantized at a time: fp32 temporaries of
# 4 GiB each (llama4-maverick's experts, (128, 5120, 8192), would need 21.5
# GB each at once, beside the layer's 32 GB of bf16 weights)
QUANT_CHUNK = 2 ** 30


def quantize_weight(w: torch.Tensor, mode: str):
    """-> dict(q=storage tensor, scale=(..., 1, d_out) fp32). bf16 passes
    through with scale None. An int8 matrix (2-D) is stored K-major; a
    stack of matrices (MoE experts) row-major, quantized a few whole
    matrices at a time (`QUANT_CHUNK`): the scales are per matrix, so the
    values are those of the whole stack at once."""
    if mode == "bf16":
        return {"q": w, "scale": None}
    if w.ndim <= 2:
        q, scale = _quantized(w, mode)
        return {"q": stored(q), "scale": scale}
    mats = w.reshape(-1, *w.shape[-2:])
    n = max(1, QUANT_CHUNK // mats[0].numel())
    q = torch.empty(mats.shape, device=w.device,
                    dtype=torch.int8 if mode == "int8"
                    else torch.float8_e4m3fn)
    scale = torch.empty((len(mats), 1, w.shape[-1]), device=w.device)
    for i in range(0, len(mats), n):
        q[i:i + n], scale[i:i + n] = _quantized(mats[i:i + n], mode)
    return {"q": q.reshape(w.shape),
            "scale": scale.reshape(*w.shape[:-2], 1, w.shape[-1])}


def act_scale(xf: torch.Tensor) -> torch.Tensor:
    """The int8 path's per-tensor activation scale of fp32 `xf`, 0-dim:
    amax * fl32(1/127), as the served (jitted) reference forms it, on
    either device."""
    return torch.clamp(xf.abs().amax(), min=1e-8) * INV_127


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The reference's `q.astype(bf16) * scale.astype(bf16)`, in bf16."""
    return q.to(torch.bfloat16) * scale.to(torch.bfloat16)


def linear(x: torch.Tensor, w, qcfg: Optional[QuantConfig] = None
           ) -> torch.Tensor:
    """x @ w with the configured quantization, result in x's dtype. `w` is
    a raw `(d_in, d_out)` tensor (bf16 path) or a `quantize_weight` dict.

    bf16: the card's GEMM accumulates in fp32 (the runner turns off
    reduced-precision split-K reduction). int8 native: dynamic per-tensor
    activation quantization in plain PyTorch, as the reference does it
    outside any kernel, then the int8 kernel on `x.reshape(-1, K)` (its
    rows padded to a multiple of 16 bytes where K is not one).
    fp8 and non-native int8: dequantize to bf16, then a bf16 matmul."""
    if isinstance(w, dict):
        q, scale = w["q"], w["scale"]
    else:
        q, scale = w, None
    if qcfg is None or qcfg.mode == "bf16" or scale is None:
        return torch.matmul(x, q.to(x.dtype))

    if qcfg.mode == "int8" and qcfg.native:
        xf = x.float()
        xs = act_scale(xf)
        xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
        K, N = q.shape
        out = int8_matmul(pad_rows(xq.reshape(-1, K)), q, xs.reshape(1),
                          scale)
        return out.reshape(*x.shape[:-1], N).to(x.dtype)

    return torch.matmul(x, dequantize(q, scale).to(x.dtype))


def quantize_tree(params, mode: str):
    """Quantize every 2D+ bf16 weight in a parameter tree (dicts and lists
    of tensors); norms, embeddings, the router and 1D vectors stay as they
    are. Returns a tree where those weights become `quantize_weight`
    dicts (int8 matrices stored K-major, stacked experts row-major)."""
    if mode == "bf16":
        return params

    def visit(p, name=""):
        if isinstance(p, dict):
            return {k: visit(v, k) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(visit(v, name) for v in p)
        if (isinstance(p, torch.Tensor) and p.ndim >= 2
                and p.dtype == torch.bfloat16 and name not in SKIP):
            return quantize_weight(p, mode)
        return p

    return visit(params)
