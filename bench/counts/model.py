"""Model FLOPs of an engine call, the numerator of an MFU.

2 x the active non-embedding parameters per useful token (a prompt token
of an admitted slot, or the token of an active decode slot): the
attention projections, and the MoE's router and top-k experts or the
dense MLP; plus attention over each token's own context (4 x Hq x D x
context a layer: QK and PV); plus the lm_head (2 x d x V) where its
logits are used: one row an admitted prompt, one an active decode slot.
Padded rows, idle slots and slots not admitted are not useful work."""
import numpy as np


def active_params(cfg) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd \
        + cfg.num_heads * hd * d
    n_mats = 3 if cfg.mlp_kind == "swiglu" else 2
    if cfg.moe is not None:
        ff = cfg.moe.top_k * n_mats * d * cfg.moe.expert_ff \
            + d * cfg.moe.num_experts
    else:
        ff = n_mats * d * cfg.d_ff
    return (attn + ff) * cfg.num_layers


def call_flops(cfg, call) -> float:
    """FLOPs of one prefill or decode call (`clock.Call` with `context`)."""
    attn_unit = 4 * cfg.num_heads * cfg.resolved_head_dim * cfg.num_layers
    head = 0 if cfg.tie_embeddings else 2 * cfg.d_model * cfg.vocab_size
    if call.kind == "prefill":
        L = call.lens[call.mask].astype(np.float64)
        tokens = L.sum()
        attn = attn_unit * float((L * (L + 1) / 2).sum())
        rows = len(L)
    else:
        act = call.mask
        tokens = float(act.sum())
        attn = attn_unit * float((call.context[act] + 1).sum())
        rows = tokens
    return 2.0 * active_params(cfg) * tokens + attn + head * rows
