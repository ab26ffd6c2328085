"""Abstract inputs and sharding specs for every dry-run cell.

Counterpart of `repro.launch.specs`. `input_specs(cfg, shape)` gives the
model's inputs as `meta` tensors of the reference's shapes and dtypes, and
`abstract_params(cfg)` the parameters the same way: `init_params` on the
`meta` device, so nothing is allocated. The sharding functions return the
port's `P` spec trees on an `AbstractMesh` or a `DeviceMesh`, element for
element the reference's `NamedSharding` specs; `placements_tree` turns a
spec tree into DTensor placements (`parallel.sharding.placements`).

The port keeps one parameter dict a layer where the reference stacks each
layer's parameters over the repeats of its superblock. ZeRO-1 and FSDP
(`zero1_spec`) take the first free divisible dimension; where that is the
reference's stacked dimension, the port's layer has none, and its spec
takes the next free one: the bytes a device holds are the same.

The step builders return `(fn, args, specs, donate)`: the step, its
abstract arguments, their spec trees, and the indices of the arguments
the step updates in place (the reference's `donate_argnums`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as model_lib
from repro_torch.parallel.sharding import (
    P, logical_spec, mesh_axes, param_spec_tree, placements, zero1_spec)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract model inputs for one (arch x shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out = {"tokens": _meta((B, S), torch.int32),
               "labels": _meta((B, S), torch.int32)}
    elif shape.kind == "prefill":
        out = {"tokens": _meta((B, S), torch.int32)}
    else:  # decode: one new token against a seq_len cache
        out = {"tokens": _meta((B, 1), torch.int32)}
    if cfg.encoder_layers and shape.kind != "decode":
        out["frames"] = _meta((B, cfg.frontend_len or 1500, cfg.d_model),
                              torch.bfloat16)
    if cfg.frontend == "vision_patches" and shape.kind != "decode":
        out["patches"] = _meta((B, model_lib.VLM_PATCHES, cfg.d_model),
                               torch.bfloat16)
    return out


def batch_shardings(batch: Dict[str, Any], mesh) -> Dict[str, P]:
    out = {}
    for k, v in batch.items():
        names = ["batch"] + [None] * (len(v.shape) - 1)
        out[k] = logical_spec(v.shape, names, mesh)
    return out


def abstract_params(cfg: ModelConfig) -> Any:
    """bf16 parameters on `meta`, as the reference's `eval_shape` of its
    `init_params`: a quantized cell runs `linear` on them with its
    `qcfg`, as the reference's dry-run does."""
    return model_lib.init_params(cfg, device="meta",
                                 generator=torch.Generator())


def _shard_factor(spec: P, mesh) -> int:
    sizes = mesh_axes(mesh)
    f = 1
    for part in spec:
        for ax in ((part,) if isinstance(part, str) else (part or ())):
            f *= sizes[ax]
    return f


# the port's per-layer subtrees, whose leaves the reference stacks over a
# leading repeat dimension
STACKED = ("layers", "encoder")


def _map2(fn, specs, tree, stacked: bool = False):
    """fn(spec, leaf, stacked) over a spec tree and the tensor tree it
    describes (a `{"q", "scale"}` node's spec is a dict too; None stays
    None); `stacked` is whether the reference stacks the leaf."""
    if isinstance(specs, dict):
        return {k: _map2(fn, specs[k], tree[k], stacked or k in STACKED)
                for k in specs}
    if isinstance(specs, list):
        return [_map2(fn, s, t, stacked) for s, t in zip(specs, tree)]
    if specs is None:
        return None
    return fn(specs, tree, stacked)


def _leaves2(specs, tree):
    out = []
    _map2(lambda s, a, _: out.append((s, a)), specs, tree)
    return out


FSDP_THRESHOLD_BYTES = 4e9   # per-device weight budget before FSDP kicks in


def param_shardings(cfg: ModelConfig, params_abs, mesh, fsdp: str = "auto"):
    """TP weight sharding, upgraded to 2D FSDPxTP when the TP-only layout
    would exceed the per-device budget (llama4-maverick: 50 GB -> 3.1 GB)."""
    specs = param_spec_tree(params_abs, mesh,
                            tied_embeddings=cfg.tie_embeddings)
    if fsdp == "auto":
        per_dev = sum(a.numel() * a.element_size() / _shard_factor(s, mesh)
                      for s, a in _leaves2(specs, params_abs))
        fsdp = "on" if per_dev > FSDP_THRESHOLD_BYTES else "off"
    if fsdp == "on":
        # the reference's test is on its stacked leaf's rank
        specs = _map2(lambda s, a, stacked: zero1_spec(s, a.shape, mesh)
                      if a.ndim + stacked >= 2 else s, specs, params_abs)
    return specs


def opt_shardings(cfg: ModelConfig, opt_state_abs, mesh):
    """Optimizer-state shardings: parameter rules + ZeRO-1 over `data`."""
    specs = param_spec_tree(opt_state_abs, mesh,
                            tied_embeddings=cfg.tie_embeddings)
    return _map2(lambda s, a, _: zero1_spec(s, a.shape, mesh), specs,
                 opt_state_abs)


# cache leaf logical names (mirrors model_lib.constrain_cache; the
# reference's without its stacked repeat dimension)
def _cache_names(name: str, ndim: int):
    if name in ("k", "v"):
        return ("batch", "kvheads", "kv_seq_tp", None)
    if name in ("xk", "xv"):
        return ("batch", None, "kvheads", None)
    names = ["batch"] + [None] * (ndim - 1)
    if name in ("h", "C") and ndim >= 2:
        names[1] = "ssm_inner"
    return tuple(names)


def cache_shardings(cfg: ModelConfig, cache_abs, mesh):
    layers = []
    for blk in cache_abs["layers"]:
        layers.append({name: logical_spec(a.shape,
                                          _cache_names(name, a.ndim), mesh)
                       for name, a in blk.items()})
    return {"len": logical_spec(cache_abs["len"].shape, ("batch",), mesh),
            "layers": layers}


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes a device holds of `tree` (a tensor tree, or a tuple of them,
    as a builder's arguments) laid out at `specs`: each leaf's bytes over
    the product of the mesh axes its spec shards it over."""
    if isinstance(tree, tuple) and not isinstance(specs, P):
        return sum(shard_bytes(t, s, mesh) for t, s in zip(tree, specs))
    if isinstance(specs, P):
        return tree.numel() * tree.element_size() // _shard_factor(specs,
                                                                   mesh)
    return sum(a.numel() * a.element_size() // _shard_factor(s, mesh)
               for s, a in _leaves2(specs, tree))


def placements_tree(specs, mesh):
    """The DTensor placements of every spec of a spec tree."""
    if isinstance(specs, P):
        return placements(specs, mesh)
    if isinstance(specs, dict):
        return {k: placements_tree(v, mesh) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(placements_tree(v, mesh) for v in specs)
    return specs


# ---------------------------------------------------------------------------
# Step builders per shape kind
# ---------------------------------------------------------------------------

def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, qcfg=None,
                     optimizer: str = "adamw8bit",
                     accum_steps: Optional[int] = None):
    """Returns (step_fn, args_abs, specs, donate)."""
    from repro_torch.training import adamw, adamw8bit, build_train_step
    if accum_steps is None:
        # deeper microbatching for 100B+ (MoE dispatch buffers dominate)
        accum_steps = 16 if cfg.param_count() > 1e11 else 8
    opt = adamw8bit(1e-3) if optimizer == "adamw8bit" else adamw(1e-3)
    step = build_train_step(cfg, opt, qcfg=qcfg, remat=True,
                            accum_steps=accum_steps)
    params_abs = abstract_params(cfg)
    opt_abs = opt.init(params_abs)
    batch = input_specs(cfg, shape)
    specs = (param_shardings(cfg, params_abs, mesh),
             opt_shardings(cfg, opt_abs, mesh),
             batch_shardings(batch, mesh))
    # params + opt state are updated in place
    return step, (params_abs, opt_abs, batch), specs, (0, 1)


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       qcfg=None):
    params_abs = abstract_params(cfg)
    batch = input_specs(cfg, shape)

    def prefill_step(params, batch):
        return model_lib.prefill(params, cfg, batch, qcfg=qcfg)

    specs = (param_shardings(cfg, params_abs, mesh),
             batch_shardings(batch, mesh))
    return prefill_step, (params_abs, batch), specs, ()


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      qcfg=None):
    """serve_step: one new token with a KV cache of seq_len."""
    params_abs = abstract_params(cfg)
    B = shape.global_batch
    enc_len = cfg.frontend_len or 1500 if cfg.encoder_layers else 0
    cache_abs = model_lib.abstract_cache(cfg, B, shape.seq_len, enc_len)
    tok = _meta((B, 1), torch.int32)

    def serve_step(params, token, cache):
        return model_lib.decode_step(params, cfg, token, cache, qcfg=qcfg)

    specs = (param_shardings(cfg, params_abs, mesh),
             logical_spec((B, 1), ("batch", None), mesh),
             cache_shardings(cfg, cache_abs, mesh))
    # the KV cache: decode updates it (the reference donates it)
    return serve_step, (params_abs, tok, cache_abs), specs, (2,)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, qcfg=None, **kw):
    """Returns (step_fn, abstract_args, specs, donate)."""
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh, qcfg, **kw)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh, qcfg)
    return build_decode_cell(cfg, shape, mesh, qcfg)
