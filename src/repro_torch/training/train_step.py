"""The train step: loss + grads + optimizer update, remat-aware.

Counterpart of `repro.training.train_step`. Gradients come from
`torch.autograd.grad` over every floating-point leaf of the parameters
(leaves the loss does not reach get zeros, as under `jax.grad`); they
have their leaf's dtype (bf16 for bf16 parameters). With `accum_steps >
1` the batch is cut into that many micro-batches along its first axis,
their gradients summed in fp32 and multiplied by 1 / accum_steps, so they
stay fp32, as in the reference. The global norm is the square root of
the sum of per-leaf fp32 sums of squares (the reference sums per stacked
leaf, the port per layer's leaf: another order of the same fp32 sum).
The clip scale `min(1, grad_clip / (norm + 1e-6))` goes to the
optimizer, which applies it as `g * scale.to(g.dtype)`: in the fused
update on the card, so no clipped copy of the gradients is made.
The optimizer updates the parameters and its state in place
(`training.optimizer`); `step` returns them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import train_loss
from repro_torch.parallel.sharding import micro_batch
from repro_torch.training.optimizer import Optimizer, tree_leaves, tree_map


def _sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    x = g.to(torch.float32, copy=True)        # one fp32 copy of the leaf
    return torch.sum(x.mul_(x))


def build_train_step(cfg: ModelConfig, opt: Optimizer, qcfg=None,
                     remat: bool = True, grad_clip: Optional[float] = 1.0,
                     accum_steps: int = 1):
    """Returns step(params, opt_state, batch) -> (params, opt_state, stats),
    stats {"loss", "grad_norm", "ce", "aux"} as 0-dim fp32 tensors.

    remat=True recomputes each layer in the backward pass
    (`torch.utils.checkpoint`), as the reference checkpoints its scan
    body. Gradients are clipped by global norm before the update."""

    def loss_and_grads(params, leaves, batch):
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, aux = train_loss(params, cfg, batch, qcfg=qcfg,
                                       remat=remat)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def grads_of(params, leaves, batch):
        if accum_steps <= 1:
            return loss_and_grads(params, leaves, batch)
        n = next(iter(batch.values())).shape[0] // accum_steps
        gsum = [torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
                for p in leaves]
        z = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        lsum, ce, aux_ = z, z, z
        for i in range(accum_steps):
            micro = {k: micro_batch(v, i, n, accum_steps)
                     for k, v in batch.items()}
            loss, aux, grads = loss_and_grads(params, leaves, micro)
            for a, g in zip(gsum, grads):
                a.add_(g.float())
            lsum, ce, aux_ = lsum + loss, ce + aux["ce"], aux_ + aux["aux"]
            del grads
        inv = 1.0 / accum_steps
        return (lsum * inv, {"ce": ce * inv, "aux": aux_ * inv},
                [g.mul_(inv) for g in gsum])

    def step(params, opt_state, batch):
        leaves = [p for p in tree_leaves(params) if p.is_floating_point()]
        loss, aux, grads = grads_of(params, leaves, batch)
        total = torch.zeros((), dtype=torch.float32, device=loss.device)
        for g in grads:
            total = total + _sum_of_squares(g)
        gnorm = torch.sqrt(total)
        scale = None
        if grad_clip:
            # a quotient of tensors: `number / tensor` would be a
            # reciprocal times the number, another rounding
            clip = torch.full_like(gnorm, grad_clip)
            scale = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
        by_leaf = dict(zip(map(id, leaves), grads))
        grad_tree = tree_map(lambda p: by_leaf.get(id(p)), params)
        del grads, by_leaf
        params, opt_state = opt.update(grad_tree, opt_state, params,
                                       grad_scale=scale)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "ce": aux["ce"], "aux": aux["aux"]}

    return step
