"""Plain PyTorch version of the fused 8-bit AdamW update of one leaf.

The function of `repro.training.optimizer.adamw8bit`'s `upd` as the
jitted reference computes it (`jax.jit(opt.update)`'s fused HLO), in
torch ops in the same order, each rounded to fp32 as XLA rounds it:

    g  = g · s                       (the clip scale s in g's dtype; optional)
    m̂  = (sign(y) · y·y) · scale_m   with y = fp32(q_m) · fl32(1/127)
    m  = fma(g, 1 - b1, m̂ · b1)
    v  = fma(g · (1 - b2), g, v̂ · b2)
    u  = (m / bc1) · (1 / sqrt(v / bc2 + eps²))
    u  = fma(p, wd, u)               (only where wd != 0)
    p  = fma(-u, lr, p)              (in fp32, then p's dtype)
    scale = max(max|block|, 1e-12);  q = clip(round(sign(x) · sqrt(|x| /
    scale) · 127), ±127)             (blocks along the last axis; a ragged
                                      tail's pad lanes hold 0)

Where the source reads `x · c + y` (`b1 * m + (1 - b1) * g`, and the
products before the other sums) the compiled reference rounds once, as a
fused multiply-add (`fma(a, b, c)` above: a · b + c rounded once); which
product it fuses was read off the CPU's results (`fma32` reproduces the
reference's new moments bit for bit, the unfused form does not). The
source's `/ 127.0` is a product by fl32(1/127) under jit, and its
`a / sqrt(b)` is `a · rsqrt(b)`. XLA's CPU `rsqrt` is not correctly
rounded, and `torch.rsqrt` is approximate on the card, so both this
version and the kernel take the correctly rounded `1 / sqrt(b)`: the same
bits on the CPU and on the card, within one fp32 ulp of the reference's
factor. Products by the update's constants multiply by their fp32
roundings (as the kernel does); every quotient is a quotient of two
tensors, which ATen divides exactly on both devices. The bias
corrections `bc1 = 1 - b1**t`, `bc2 = 1 - b2**t` are 0-dim fp32 tensors
that the caller forms once a step, so the kernel and this version read
the same bits.

Every call writes the new `p`, codes and scales into its arguments, as
the kernel does, a chunk of whole rows at a time (blocks never cross a
row), so a leaf's temporaries stay small.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256
# fl32(1/127): the jitted reference's `q / 127.0`
INV_127 = float(torch.tensor(1.0) / 127)


# rows a chunk of the plain update holds at most this many elements
CHUNK = 1 << 24


def f32(x: float) -> float:
    """x rounded to fp32, as the compiled reference holds a Python
    constant."""
    return float(torch.tensor(x, dtype=torch.float32))


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """fp32 a · b + c rounded once, as a fused multiply-add (fp32 `a`,
    `c`; `b` a tensor or a Python float holding an fp32 value). a · b is
    exact in float64; the float64 sum is rounded to odd (TwoSum's error
    decides its last bit), and an odd float64 rounds to the nearest fp32
    as the exact sum would (53 >= 24 + 2 bits)."""
    a, c = a.double(), c.double()
    p = a * (b.double() if isinstance(b, torch.Tensor) else b)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, away), s).float()


def num_blocks(last: int, block: int = BLOCK) -> int:
    return -(-last // block)


def dequantize(q: torch.Tensor, scale: torch.Tensor, block: int = BLOCK
               ) -> torch.Tensor:
    """int8 codes (..., n) and block scales (..., nb) -> fp32 (..., n)."""
    *lead, last = q.shape
    nb = scale.shape[-1]
    y = F.pad(q, (0, nb * block - last)).reshape(*lead, nb, block).float() \
        * INV_127
    x = torch.sign(y) * (y * y) * scale[..., None]
    return x.reshape(*lead, nb * block)[..., :last]


def quantize(x: torch.Tensor, block: int = BLOCK):
    """fp32 (..., n) -> (int8 codes (..., n), fp32 block scales (..., nb))."""
    *lead, last = x.shape
    nb = num_blocks(last, block)
    blk = F.pad(x, (0, nb * block - last)).reshape(*lead, nb, block)
    floor = torch.full((), 1e-12, dtype=torch.float32, device=x.device)
    absmax = torch.maximum(blk.abs().amax(dim=-1, keepdim=True), floor)
    y = torch.sign(blk) * torch.sqrt(blk.abs() / absmax)
    q = torch.clamp(torch.round(y * 127.0), -127, 127).to(torch.int8)
    return q.reshape(*lead, nb * block)[..., :last], absmax[..., 0]


def adamw8bit_update_ref(g, p, m_q, m_scale, v_q, v_scale, bc1, bc2,
                         grad_scale=None, *, lr: float, b1: float, b2: float,
                         eps: float, weight_decay: float = 0.0,
                         block: int = BLOCK):
    """One leaf's update, in place. g: bf16 or fp32; p: bf16 or fp32;
    m_q/v_q: int8 of p's shape; m_scale/v_scale: fp32 (*p.shape[:-1], nb);
    bc1/bc2: 0-dim fp32; grad_scale: 0-dim fp32 (the clip scale, applied
    as `g * grad_scale.to(g.dtype)`) or None."""
    if grad_scale is not None:
        grad_scale = grad_scale.to(g.dtype)
    last = p.shape[-1]
    rows = max(1, CHUNK // max(last, 1))
    views = [t.reshape(-1, t.shape[-1]) for t in (g, p, m_q, m_scale, v_q,
                                                   v_scale)]
    for r in range(0, views[1].shape[0], rows):
        _update_rows(*(t[r:r + rows] for t in views), bc1, bc2, grad_scale,
                     lr=f32(lr), b1=f32(b1), c1=f32(1 - b1), b2=f32(b2),
                     c2=f32(1 - b2), eps2=f32(eps * eps),
                     wd=f32(weight_decay), block=block)


def _update_rows(g, p, m_q, m_scale, v_q, v_scale, bc1, bc2, grad_scale, *,
                 lr, b1, c1, b2, c2, eps2, wd, block):
    if grad_scale is not None:
        g = g * grad_scale
    g = g.float()
    one = torch.ones((), dtype=torch.float32, device=p.device)
    m = fma32(g, c1, dequantize(m_q, m_scale, block) * b1)
    v = fma32(g * c2, g, dequantize(v_q, v_scale, block) * b2)
    u = (m / bc1) * (one / torch.sqrt(v / bc2 + eps2))
    pf = p.float()
    if wd:
        u = fma32(pf, wd, u)
    p.copy_(fma32(-u, lr, pf))
    for q, s, x in ((m_q, m_scale, m), (v_q, v_scale, v)):
        nq, ns = quantize(x, block)
        q.copy_(nq)
        s.copy_(ns)
