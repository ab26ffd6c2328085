"""Model assembly for attention decoders, dense or MoE: parameters,
embedding, unembedding, the feed-forward half of a block.

Counterpart of `repro.models.model`, the served subset. The reference stacks
each layer's parameters over the R repeats of its superblock and scans
them; PyTorch runs eagerly, so the port keeps one parameter dictionary per
layer in `params["layers"]` and loops over them in order.

  init_params(cfg, device=..., generator=..., quant=...) -> params
  embed_tokens / unembed / _apply_ff            -> used by serving.runner

`forward`, `prefill` and `decode_step` on the contiguous cache are not on
the served path and arrive with a later slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, embed_init, init_mlp, init_norm,
    softcap)
from repro_torch.quant import linear, quantize_tree


def unit_size(cfg: ModelConfig) -> int:
    u = 1
    if cfg.attn_every > 1:
        u = math.lcm(u, cfg.attn_every)
    if cfg.moe is not None and cfg.moe.interleave > 1:
        u = math.lcm(u, cfg.moe.interleave)
    if cfg.xlstm is not None:
        u = math.lcm(u, cfg.xlstm.slstm_every)
    if cfg.num_layers % u:
        u = cfg.num_layers     # degenerate: no repetition -> single scan step
    return u


def unit_pattern(cfg: ModelConfig) -> Tuple[Tuple[str, bool], ...]:
    """(block_kind, is_moe) for each of the first U layers."""
    u = unit_size(cfg)
    kinds = cfg.block_pattern()
    moes = cfg.moe_layer_mask()
    return tuple((kinds[i], moes[i]) for i in range(u))


def check_served(cfg: ModelConfig):
    """Raise for a configuration the port does not serve yet: it serves
    attention decoders, dense or MoE, with untied embeddings."""
    kinds = {kind for kind, _ in unit_pattern(cfg)}
    if cfg.family == "encdec" or kinds != {"attn"}:
        raise NotImplementedError(
            f"{cfg.name}: only attention decoders (dense or MoE) are ported "
            "so far (ROADMAP Queue A items 8-9)")
    if cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: tied embeddings not ported")


def init_params(cfg: ModelConfig, *, device, generator: torch.Generator,
                dtype=torch.bfloat16, quant: str = "bf16") -> Dict[str, Any]:
    """Random parameters, normal × 0.02 as the reference draws them.

    With `quant` int8 or fp8 each layer is quantized (`quantize_tree`) as
    soon as it is drawn, and so is the lm_head, so a model whose bf16
    weights would not fit the card never holds them all at once.

    The numbers differ from the reference's (another generator); tests
    that compare the two frameworks initialise in JAX and convert with
    `repro_torch.weights.params_from_jax`."""
    check_served(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(device=device, generator=generator, dtype=dtype)
    layers = []
    for is_moe in cfg.moe_layer_mask():
        p = {"ln1": init_norm(cfg.norm_kind, d, device=device, dtype=dtype),
             "attn": attn.init_attention(d, cfg.num_heads, cfg.num_kv_heads,
                                         hd, **kw)}
        if is_moe:
            p["ln2"] = init_norm(cfg.norm_kind, d, device=device, dtype=dtype)
            p["moe"] = moe_lib.init_moe(d, cfg.moe, cfg.mlp_kind, **kw)
        elif cfg.d_ff:
            p["ln2"] = init_norm(cfg.norm_kind, d, device=device, dtype=dtype)
            p["mlp"] = init_mlp(d, cfg.d_ff, cfg.mlp_kind, **kw)
        layers.append(quantize_tree(p, quant))
    return {
        "embed": embed_init(cfg.vocab_size, d, **kw),
        "final_norm": init_norm(cfg.norm_kind, d, device=device, dtype=dtype),
        "layers": layers,
        "lm_head": quantize_tree(dense_init(d, cfg.vocab_size, **kw), quant),
    }


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    # F.embedding raises on an id outside the vocabulary, where the
    # reference's jnp.take would fill NaN.
    return F.embedding(tokens.long(), params["embed"])


def unembed(params, cfg: ModelConfig, x: torch.Tensor, qcfg=None
            ) -> torch.Tensor:
    """fp32 logits, then the optional softcap."""
    logits = linear(x, params["lm_head"], qcfg).float()
    return softcap(logits, cfg.logit_softcap)


def _positions(cfg: ModelConfig, batch: int, seq: int, offset=None,
               device=None) -> torch.Tensor:
    base = torch.arange(seq, dtype=torch.int32, device=device)[None]
    if offset is not None:
        return base + offset[:, None].to(torch.int32)
    return base.expand(batch, seq)


def _apply_ff(p, cfg: ModelConfig, x: torch.Tensor, is_moe: bool,
              qcfg=None) -> torch.Tensor:
    """The feed-forward half of a block; the MoE aux loss is dropped, as
    the reference's serving runner drops it."""
    if is_moe and "moe" in p:
        h = apply_norm(p["ln2"], x, cfg.norm_kind)
        mo, _ = moe_lib.apply_moe(p["moe"], h, cfg.moe, cfg.mlp_kind, qcfg)
        x = x + mo
    elif "mlp" in p:
        h = apply_norm(p["ln2"], x, cfg.norm_kind)
        x = x + apply_mlp(p["mlp"], h, cfg.mlp_kind, qcfg)
    return x
