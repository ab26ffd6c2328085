"""The int8 GEMM (`kernels/int8_matmul`): (M, K) int8 x (K, N) int8 ->
(M, N) fp32 `acc * (x_scale * w_scale)`, one launch a `linear`.

Per launch: 2MKN operations; bytes: x (MK) and w (KN) read once, the fp32
output (4MN) written once, the scales (4N + 4) read once."""
from bench.counts import HBM, PEAK_INT8


def ops(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


def nbytes(M: int, K: int, N: int) -> int:
    return M * K + K * N + 4 * M * N + 4 * N + 4


def bound_s(M: int, K: int, N: int) -> float:
    return max(ops(M, K, N) / PEAK_INT8, nbytes(M, K, N) / HBM)


def launches(cfg, call, batch: int):
    """(M, K, N) of every launch one engine call makes, for a model whose
    2-D weights are int8: each attention projection of each layer, a
    dense MLP's matrices, and the lm_head over one row a slot."""
    rows = call.tokens.size if call.kind == "prefill" else batch
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    layer = [(rows, d, q), (rows, d, kv), (rows, d, kv), (rows, q, d)]
    if cfg.moe is None:
        f = cfg.d_ff
        mlp = [(rows, d, f), (rows, f, d)]
        if cfg.mlp_kind == "swiglu":
            mlp.insert(0, (rows, d, f))
        layer += mlp
    out = layer * cfg.num_layers
    if not cfg.tie_embeddings:
        out.append((batch, d, cfg.vocab_size))
    return out
