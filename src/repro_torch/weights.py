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
E)` fp32) and Mamba blocks (projections, `conv_w (R, di, k)`, and the
fp32 `A_log (R, di, N)`, `D (R, di)` and `dt_bias (R, di)`) are cut per
layer like any other leaf. `pools_from_jax` cuts the reference's serving
state (K/V pools and Mamba states, stacked the same way) per layer.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


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


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig, *,
                    device="cpu") -> Dict[str, Any]:
    """np_params: the reference's params with every leaf as a numpy array
    (e.g. `jax.tree.map(np.asarray, params)`)."""
    model_lib.check_served(cfg)
    U = model_lib.unit_size(cfg)
    blocks = np_params["blocks"]
    layers = [_map(blocks[i % U], lambda a, r=i // U: to_torch(a[r], device))
              for i in range(cfg.num_layers)]
    return {
        "embed": to_torch(np_params["embed"], device),
        "final_norm": _map(np_params["final_norm"],
                           lambda a: to_torch(a, device)),
        "layers": layers,
        "lm_head": _map(np_params["lm_head"], lambda a: to_torch(a, device)),
    }


def pools_from_jax(np_pools, cfg: ModelConfig, *, device="cpu"):
    """The reference's `runner.init_pools` state (one dict per unit
    position, each leaf `(R, ...)`, as numpy arrays) as the port's list of
    one dict per layer."""
    U = model_lib.unit_size(cfg)
    return [_map(np_pools[i % U], lambda a, r=i // U: to_torch(a[r], device))
            for i in range(cfg.num_layers)]
