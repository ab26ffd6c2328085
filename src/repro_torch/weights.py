"""Convert the reference's parameter pytree into the port's parameters.

The reference stacks each unit position's parameters over the R repeats
of its superblock (`repro.models.model.init_params`); the port keeps one
dictionary per layer. Layer `r * U + j` is repeat r of unit position j.
Weights keep their `(d_in, d_out)` layout, so converting is a copy, and
every leaf travels bit for bit: numpy holds bf16 as a 2-byte type named
"bfloat16", viewed here as uint16 and then as `torch.bfloat16`, and fp8
e4m3 as "float8_e4m3fn", viewed as uint8 and then as
`torch.float8_e4m3fn`. Quantized weights (`{"q", "scale"}` dicts of
`quantize_tree`), MoE blocks (experts `(R, E, d, f)`, router `(R, d,
E)` fp32, a shared expert's `moe/shared/{gate,up,down}`; with
`interleave` 2 the unit holds a dense and a MoE position, so layer r * 2
+ j takes repeat r of position j) and Mamba blocks (projections, `conv_w (R, di, k)`, and the
fp32 `A_log (R, di, N)`, `D (R, di)` and `dt_bias (R, di)`) are cut per
layer like any other leaf; an int8 matrix that `linear` reads (2-D once
cut) is then stored K-major, as `quant.quantize_weight` stores it
(`quant.stored`: one transposing copy, the same values). xLSTM blocks
keep the reference's flat names (`mlstm_up`, ..., `slstm_down`), so they
need no renaming; with tied embeddings the reference has no `lm_head`,
and neither has the port. An encoder-decoder's decoder layers carry
`ln_x` and `xattn` like any other leaf; its stacked `encoder` (E, ...) is
cut into one dict an encoder layer, and `pos_embed`, `enc_pos_embed` and
`enc_final_norm` come across as they are. `pools_from_jax` cuts the
reference's serving state (K/V pools, Mamba states `conv` and `h`, mLSTM
states `C`, `n` and `m`, sLSTM states `c`, `n`, `m` and `h`, all stacked
the same way) per layer, and `cache_from_jax` its contiguous decode cache
(`{"len", "blocks"}`, cross-attention `xk`/`xv` included) into the
port's `{"len", "layers"}`. `opt_state_from_jax` cuts an optimizer state
of the reference's `adamw` or `adamw8bit` the same way (its moments'
int8 codes keep their row-major layout: only `linear` reads K-major).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.quant import stored


def to_torch(a, device="cpu") -> torch.Tensor:
    a = np.array(a)           # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _stored(tree):
    """Every quantized weight `{"q", "scale"}` of a tree in the layout the
    model keeps it in (`quant.stored`: int8 matrices K-major)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _stored(v) for k, v in tree.items()}
    if isinstance(out.get("q"), torch.Tensor) and "scale" in out:
        out["q"] = stored(out["q"])
    return out


def _params_like(tree, cfg: ModelConfig, device):
    """A tree shaped as the reference's params (`blocks` stacked per unit
    position, `encoder` stacked; any other key, such as `embed`, as it is)
    cut into the port's, leaves converted as they are."""
    U = model_lib.unit_size(cfg)
    conv = lambda t: _map(t, lambda a: to_torch(a, device))
    out = {k: conv(v) for k, v in tree.items()
           if k not in ("blocks", "encoder")}
    out["layers"] = [_map(tree["blocks"][i % U],
                          lambda a, r=i // U: to_torch(a[r], device))
                     for i in range(cfg.num_layers)]
    if "encoder" in tree:
        out["encoder"] = [_map(tree["encoder"],
                               lambda a, r=r: to_torch(a[r], device))
                          for r in range(cfg.encoder_layers)]
    return out


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig, *,
                    device="cpu") -> Dict[str, Any]:
    """np_params: the reference's params with every leaf as a numpy array
    (e.g. `jax.tree.map(np.asarray, params)`)."""
    model_lib.check_served(cfg)
    return {k: [_stored(x) for x in v] if isinstance(v, list) else _stored(v)
            for k, v in _params_like(np_params, cfg, device).items()}


def pools_from_jax(np_pools, cfg: ModelConfig, *, device="cpu"):
    """The reference's `runner.init_pools` state (one dict per unit
    position, each leaf `(R, ...)`, as numpy arrays: K/V pools, Mamba,
    mLSTM and sLSTM states) as the port's list of one dict per layer."""
    U = model_lib.unit_size(cfg)
    return [_map(np_pools[i % U], lambda a, r=i // U: to_torch(a[r], device))
            for i in range(cfg.num_layers)]


def cache_from_jax(np_cache, cfg: ModelConfig, *, device="cpu"):
    """The reference's contiguous cache (`models.model.init_cache` or
    `prefill`: `{"len": (B,), "blocks": [per unit position, each leaf (R,
    ...)]}` as numpy arrays) as the port's `{"len", "layers": [per
    layer]}`."""
    U = model_lib.unit_size(cfg)
    blocks = np_cache["blocks"]
    return {"len": to_torch(np_cache["len"], device),
            "layers": [_map(blocks[i % U],
                            lambda a, r=i // U: to_torch(a[r], device))
                       for i in range(cfg.num_layers)]}


def opt_state_from_jax(np_state, cfg: ModelConfig, *, device="cpu"):
    """The reference's `adamw` or `adamw8bit` state (`{"step", "m", "v"}`,
    every leaf a numpy array; a moment is an fp32 array or `{"q",
    "scale"}`) as the port's, whose moments mirror `params_from_jax`'s
    tree. Blocks of the 8-bit moments run along the last axis, so cutting
    the stacked leaves changes none."""
    return {"step": to_torch(np_state["step"], device),
            "m": _params_like(np_state["m"], cfg, device),
            "v": _params_like(np_state["v"], cfg, device)}
