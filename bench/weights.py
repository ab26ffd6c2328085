"""Random weights from the run's seed, made on the device.

The weights are the benchmark's input, as the traffic is: made here, in
bf16 (normal x 0.02, as the port's initialisers draw them), handed to the
program, and made again, the same, by the reference. Each layer, the
embedding and the lm_head has a generator of its own, seeded from the
run's seed and its index, and draws all its matrices in one call; the
reference can so remake layer i alone. Norm scales are ones and biases
zeros, as the port initialises them. The router is drawn in bf16 and
kept in fp32, as the port keeps it.

The trees have the port's layout (`repro_torch.models.model.init_params`):
`{"ln1", "attn": {"wq", "wk", "wv", "wo"}, "ln2", "moe": {"router",
"experts_up", "experts_down", "experts_gate"} | "mlp": {"up", "down"
[, "gate"]}}` a layer, with (d_in, d_out) matrices.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

INIT_STD = 0.02
EMBED, LM_HEAD = -1, -2


def generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of layer `index` (EMBED, LM_HEAD for those)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7 * index + 29) % 2 ** 63)
    return g


def layer_matrices(cfg) -> List[Tuple[Tuple[str, str], Tuple[int, ...]]]:
    """((group, name), shape) of every random matrix of one layer, in the
    order they are drawn."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    out = [(("attn", "wq"), (d, cfg.num_heads * hd)),
           (("attn", "wk"), (d, cfg.num_kv_heads * hd)),
           (("attn", "wv"), (d, cfg.num_kv_heads * hd)),
           (("attn", "wo"), (cfg.num_heads * hd, d))]
    if cfg.moe is not None:
        E, f = cfg.moe.num_experts, cfg.moe.expert_ff
        out += [(("moe", "router"), (d, E)),
                (("moe", "experts_up"), (E, d, f)),
                (("moe", "experts_down"), (E, f, d))]
        if cfg.mlp_kind == "swiglu":
            out.append((("moe", "experts_gate"), (E, d, f)))
    else:
        f = cfg.d_ff
        if cfg.mlp_kind == "swiglu":
            out.append((("mlp", "gate"), (d, f)))
        out += [(("mlp", "up"), (d, f)), (("mlp", "down"), (f, d))]
    return out


def _draw(shapes, seed: int, index: int, device) -> List[torch.Tensor]:
    n = sum(int(torch.Size(s).numel()) for s in shapes)
    flat = torch.randn(n, generator=generator(seed, index, device),
                       device=device, dtype=torch.bfloat16).mul_(INIT_STD)
    out, at = [], 0
    for s in shapes:
        k = int(torch.Size(s).numel())
        out.append(flat[at:at + k].view(s))
        at += k
    return out


def norm(cfg, device) -> Dict[str, torch.Tensor]:
    p = {"scale": torch.ones(cfg.d_model, device=device,
                             dtype=torch.bfloat16)}
    if cfg.norm_kind == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, device=device,
                                dtype=torch.bfloat16)
    return p


def layer(cfg, seed: int, index: int, device) -> dict:
    """Layer `index`'s bf16 tree (the router fp32)."""
    mats = layer_matrices(cfg)
    tree = {"ln1": norm(cfg, device), "ln2": norm(cfg, device)}
    for ((group, name), _), w in zip(mats, _draw([s for _, s in mats], seed,
                                                 index, device)):
        tree.setdefault(group, {})[name] = (w.float() if name == "router"
                                            else w)
    return tree


def embed(cfg, seed: int, device) -> torch.Tensor:
    return _draw([(cfg.vocab_size, cfg.d_model)], seed, EMBED, device)[0]


def lm_head(cfg, seed: int, device) -> torch.Tensor:
    return _draw([(cfg.d_model, cfg.vocab_size)], seed, LM_HEAD, device)[0]


def program_params(cfg, quant: str, seed: int, device) -> dict:
    """The program's parameter tree: each layer made, then quantized by
    the program's own `quant.quantize_tree`, before the next is made."""
    from repro_torch.quant import quantize_tree
    layers = [quantize_tree(layer(cfg, seed, i, device), quant)
              for i in range(cfg.num_layers)]
    params = {"embed": embed(cfg, seed, device),
              "final_norm": norm(cfg, device), "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = quantize_tree(lm_head(cfg, seed, device), quant)
    return params
