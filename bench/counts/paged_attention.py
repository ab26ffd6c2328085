"""Paged decode attention (`kernels/paged_attention`): one launch an
attention layer a decode step, over the (B,) slots' pages.

Per launch, what these inputs need: each slot with a context reads its K
and V (2 x context x Hkv x D bf16) once; q and the output (B x Hq x D
bf16) are read and written once; QK and PV take 4 x Hq x D x context
operations. A slot of length 0 (idle) is counted as needing nothing."""
from bench.counts import HBM, PEAK_BF16


def bound_s(cfg, lens_after) -> float:
    hd, hq, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    ctx = [int(n) for n in lens_after if n > 0]
    nbytes = sum(2 * n * hkv * hd * 2 for n in ctx) + 2 * len(lens_after) \
        * hq * hd * 2
    ops = sum(4 * hq * hd * n for n in ctx)
    return max(ops / PEAK_BF16, nbytes / HBM)
