"""Architecture registry: --arch <id> -> ModelConfig.

Counterpart of `repro.configs`. The port holds the configurations it
serves: the paper's three models, the dense llama31-8b, the ultra-sparse
MoE qwen3-30b-a3b and the sparse MoE mixtral-8x7b; the hybrid Mamba +
attention + MoE jamba-v0.1-52b; xlstm-350m, of mLSTM and sLSTM blocks
with tied embeddings; the dense phi3-medium-14b, codeqwen1.5-7b (full
multi-head attention), nemotron-4-15b (squared-ReLU MLP, layernorm) and
granite-34b (multi-query attention, 88 layers); the MoE
granite-moe-1b-a400m (head_dim 64, 32 experts, tied embeddings); the
encoder-decoder whisper-base (learned positions, stubbed audio frames,
tied embeddings); the VLM qwen2-vl-7b (M-RoPE, stubbed vision
patches); and llama4-maverick-400b-a17b (128 experts, top-1, a shared
expert, MoE on every other layer; one card holds its 2-layer unit, not
its 48 layers).

`reduced(name)` returns a tiny same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    XLSTMConfig,
)
from repro_torch.configs import (  # noqa: E402
    codeqwen1_5_7b, granite_34b, granite_moe_1b_a400m, jamba_v0_1_52b,
    llama31_8b, llama4_maverick_400b_a17b, mixtral_8x7b, nemotron_4_15b,
    phi3_medium_14b, qwen2_vl_7b, qwen3_30b_a3b, whisper_base, xlstm_350m)

_MODULES = (
    whisper_base, jamba_v0_1_52b, granite_moe_1b_a400m,
    llama4_maverick_400b_a17b, nemotron_4_15b, codeqwen1_5_7b,
    phi3_medium_14b, granite_34b, qwen2_vl_7b, xlstm_350m,
    llama31_8b, qwen3_30b_a3b, mixtral_8x7b,
)

_REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ASSIGNED_ARCHS = (
    "whisper-base", "jamba-v0.1-52b", "granite-moe-1b-a400m",
    "llama4-maverick-400b-a17b", "nemotron-4-15b", "codeqwen1.5-7b",
    "phi3-medium-14b", "granite-34b", "qwen2-vl-7b", "xlstm-350m",
)
PAPER_ARCHS = ("llama31-8b", "qwen3-30b-a3b", "mixtral-8x7b")
ALL_ARCHS = ASSIGNED_ARCHS + PAPER_ARCHS


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return list(_REGISTRY)


def reduced(name: str, *, layers: int = 2, d_model: int = 64,
            vocab: int = 256, ff: int = 128) -> ModelConfig:
    """A tiny same-family config for CPU tests and the CPU real tier."""
    cfg = get_config(name)
    heads = max(2, min(4, cfg.num_heads))
    kv = 1 if cfg.num_kv_heads == 1 else max(1, heads // max(1, cfg.q_per_kv))
    kv = min(kv, heads)
    changes = dict(
        name=f"{cfg.name}-reduced",
        num_layers=max(layers, cfg.attn_every if cfg.attn_every > 1 else layers),
        d_model=d_model, num_heads=heads, num_kv_heads=kv,
        d_ff=0 if cfg.d_ff == 0 else ff, vocab_size=vocab, head_dim=0,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_len=min(cfg.frontend_len, 16),
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(2, cfg.moe.top_k),
            expert_ff=ff, group_size=16,
            shared_expert_ff=ff if cfg.moe.shared_expert_ff else 0)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=4)
    return dataclasses.replace(cfg, **changes)


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "XLSTMConfig", "ShapeConfig",
    "ALL_SHAPES", "SHAPES_BY_NAME", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "ASSIGNED_ARCHS", "PAPER_ARCHS", "ALL_ARCHS",
    "get_config", "list_archs", "reduced",
]
