"""The int8 experts' grouped GEMM (`kernels/moe_gemm`): x (E, M, K) bf16
times every expert's int8 weights (E, K, N), dequantized in registers, ->
(E, M, N) bf16; one launch an expert product (up, gate where SwiGLU,
down) a MoE layer an engine call, M the experts' capacity rows.

Per launch: 2 E M K N operations (every expert's M rows, as the kernel
computes them); bytes: the int8 weights (E K N) and fp32 scales (4 E N)
read once, the bf16 rows in (2 E M K) and out (2 E M N) once."""
import math

from bench.counts import HBM, PEAK_BF16


def ops(E: int, M: int, K: int, N: int) -> int:
    return 2 * E * M * K * N


def nbytes(E: int, M: int, K: int, N: int) -> int:
    return E * K * N + 4 * E * N + 2 * E * M * (K + N)


def bound_s(E: int, M: int, K: int, N: int) -> float:
    return max(ops(E, M, K, N) / PEAK_BF16, nbytes(E, M, K, N) / HBM)


def rows(moe, tokens: int) -> int:
    """Capacity rows an expert for `tokens` tokens, as
    `models.moe.apply_moe` forms them: groups of `group_size`, each
    expert taking ceil(group x top_k / experts x capacity_factor)."""
    sg = min(moe.group_size, tokens)
    cap = max(moe.top_k, int(math.ceil(sg * moe.top_k / moe.num_experts
                                       * moe.capacity_factor)))
    return tokens // sg * cap


def launches(cfg, call, batch: int):
    """(E, M, K, N) of every launch one engine call makes, for a model
    whose experts are int8: the expert products of each MoE layer."""
    moe = cfg.moe
    if moe is None:
        return []
    tokens = call.tokens.size if call.kind == "prefill" else batch
    E, M, d, f = moe.num_experts, rows(moe, tokens), cfg.d_model, \
        moe.expert_ff
    layer = [(E, M, d, f), (E, M, f, d)]
    if cfg.mlp_kind == "swiglu":
        layer.insert(0, (E, M, d, f))
    return layer * sum(cfg.moe_layer_mask())
