"""Flash attention at prefill (`kernels/flash_attention`): one launch an
attention layer a prefill call, causal over (B, Lp) rows with `kv_len`.

Per launch, only the work the admitted prompts need (not the padded rows
or the slots that were not admitted): for a prompt of L tokens, the
causal QK and PV take 4 x Hq x D x L(L+1)/2 operations, and q, k, v and
the output are read or written once (2 bytes x L x (2 Hq + 2 Hkv) x D)."""
from bench.counts import HBM, PEAK_BF16


def ops(cfg, L: int) -> int:
    return 4 * cfg.num_heads * cfg.resolved_head_dim * L * (L + 1) // 2


def nbytes(cfg, L: int) -> int:
    return 2 * L * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) \
        * cfg.resolved_head_dim


def bound_s(cfg, prompt_lens) -> float:
    o = sum(ops(cfg, int(L)) for L in prompt_lens)
    b = sum(nbytes(cfg, int(L)) for L in prompt_lens)
    return max(o / PEAK_BF16, b / HBM)
