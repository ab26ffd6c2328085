"""Optimizers: AdamW and block-wise 8-bit AdamW.

Counterpart of `repro.training.optimizer`, with its optax-style API:
    opt = adamw(lr=...); state = opt.init(params)
    params, state = opt.update(grads, state, params)

A state mirrors the port's parameter tree (`layers` is a list, one dict
a layer): `{"step": 0-dim int32, "m": tree, "v": tree}`. adamw8bit keeps
each moment as int8 codes of the parameter's shape with fp32 absmax
scales per 256-wide block of the last axis (`{"q", "scale"}`), about 2
bytes a parameter for both moments against adamw's 8. Blocks run along
the last axis, so cutting the reference's stacked leaves into layers
changes no block (`weights.opt_state_from_jax`).

Unlike the reference, `update` writes in place: the parameters and the
moments it is given are overwritten with their new values and returned
(the step counter is a new tensor). That is what lets llama31-8b train
on one card: its bf16 parameters and gradients and adamw8bit's state
take 48.4 GB, and an out-of-place update would add a copy of each.
adamw8bit's update is one launch of the fused kernel per leaf on the
card (`kernels.adamw8bit`), the plain version on the CPU. `grad_scale`
(a 0-dim fp32 tensor, or None) is the train step's clip scale: each
gradient is taken as `g * grad_scale.to(g.dtype)`, as the reference's
`train_step` scales it, inside the kernel on the card, so the clipped
gradients never land in device memory.

Both updates compute as the compiled reference does (`jax.jit` of its
update), not as its source reads: a product added to a sum is one fused
multiply-add (`fma32`; in adamw the decay's product is the fused one, in
adamw8bit the gradient's, as the reference's CPU results show), and
`/ 127.0` a product by fl32(1/127); see `kernels/adamw8bit/ref.py`. The
bias corrections `1 - b**t` are formed once a step in fp32 on the
state's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.kernels.adamw8bit.ops import adamw8bit_update
from repro_torch.kernels.adamw8bit.ref import f32, fma32, num_blocks
from repro_torch.parallel.sharding import is_dtensor


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (dicts and lists; None stays None),
    with the nodes of `rest` at the same paths (a leaf of `tree` may face a
    subtree there, as a parameter faces its `{"q", "scale"}`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _step_and_corrections(state, b1, b2):
    step = state["step"] + 1
    t = step.to(torch.float32)

    def bc(b):
        return 1 - torch.pow(torch.full((), b, dtype=torch.float32,
                                        device=t.device), t)
    return step, bc(b1), bc(b2)


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=tree_leaves(params)[0].device),
                "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, grad_scale=None):
        step, bc1, bc2 = _step_and_corrections(state, b1, b2)

        def upd(p, g, m, v):
            if grad_scale is not None:
                g = g * grad_scale.to(g.dtype)
            g = g.float()
            m.copy_(fma32(m, f32(b1), g * f32(1 - b1)))
            v.copy_(fma32(v, f32(b2), (g * f32(1 - b2)) * g))
            u = m / (bc1 * (torch.sqrt(v / bc2) + f32(eps)))
            pf = p.float()
            if weight_decay:
                u = fma32(pf, f32(weight_decay), u)
            p.copy_(fma32(-u, f32(lr), pf))

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update)


def _block_placements(p, m_q, block: int):
    """One placement for a leaf's gradient, parameter, codes and scales
    under which every 256-wide block of the last axis lies on one rank:
    the codes' (the parameter rules plus ZeRO-1), with each mesh axis that
    shards the last axis into pieces that are no whole number of blocks
    replicated. The scales (..., nb) take the same placement: a shard of
    whole blocks holds their scales."""
    from torch.distributed.tensor import Replicate, Shard
    last = p.ndim - 1
    sizes = m_q.device_mesh.shape
    f = math.prod(sizes[i] for i, pl in enumerate(m_q.placements)
                  if isinstance(pl, Shard) and pl.dim == last)
    whole = p.shape[-1] % (f * block) == 0
    return tuple(Replicate() if isinstance(pl, Shard) and pl.dim == last
                 and not whole else pl for pl in m_q.placements)


def _sharded_update8(g, p, m_q, m_scale, v_q, v_scale, bc1, bc2,
                     grad_scale, *, block: int, **hyper):
    """The 8-bit update of a DTensor leaf, rank by rank: every tensor is
    redistributed to `_block_placements` (the collectives this takes are
    the update's own), the plain update runs on the local shards in place,
    and each updated tensor is written back at its own placement."""
    from torch.distributed.tensor import DTensor
    mesh = p.device_mesh
    target = _block_placements(p, m_q, block)

    def local(t):
        if not isinstance(t, DTensor):
            return t
        if t.ndim == 0:
            return t.full_tensor()
        if tuple(t.placements) != target:
            t = t.redistribute(mesh, target)
        return t.to_local()

    locs = [local(t) for t in (g, p, m_q, m_scale, v_q, v_scale, bc1, bc2,
                               grad_scale)]
    adamw8bit_update(locs[0].contiguous(), *locs[1:], block=block, **hyper)
    for t, lt in zip((p, m_q, m_scale, v_q, v_scale), locs[1:6]):
        if tuple(t.placements) != target:
            full = DTensor.from_local(lt, mesh, target, run_check=False,
                                      shape=t.shape, stride=t.stride())
            t.copy_(full.redistribute(mesh, t.placements))


def adamw8bit(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 0.0,
              block_size: int = 256) -> Optimizer:
    def init(params):
        def zq(p):
            nb = num_blocks(p.shape[-1], block_size) if p.ndim else 1
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.full(p.shape[:-1] + (nb,), 1e-12,
                                        dtype=torch.float32,
                                        device=p.device)}
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=tree_leaves(params)[0].device),
                "m": tree_map(zq, params),
                "v": tree_map(zq, params)}

    @torch.no_grad()
    def update(grads, state, params, grad_scale=None):
        step, bc1, bc2 = _step_and_corrections(state, b1, b2)

        def upd(p, g, mq, vq):
            args = (g, p, mq["q"], mq["scale"], vq["q"], vq["scale"], bc1,
                    bc2, grad_scale)
            hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, block=block_size)
            if is_dtensor(p):
                _sharded_update8(*args, **hyper)
            else:
                adamw8bit_update(g.contiguous(), *args[1:], **hyper)

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update)
