"""Architecture registry: --arch <id> -> ModelConfig.

Counterpart of `repro.configs`. The port holds the configurations it
serves: the paper's dense reference model, llama31-8b, its ultra-sparse
MoE, qwen3-30b-a3b, and the hybrid Mamba + attention + MoE
jamba-v0.1-52b; the others arrive with the slices that serve them.

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
    jamba_v0_1_52b, llama31_8b, qwen3_30b_a3b)

_MODULES = (llama31_8b, qwen3_30b_a3b, jamba_v0_1_52b)

_REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


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
    "LONG_500K", "get_config", "reduced",
]
