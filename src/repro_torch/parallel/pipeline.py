"""GPipe-style pipeline parallelism over a `stage` mesh axis.

Counterpart of `repro.parallel.pipeline`, whose `shard_map` region
becomes one call on every rank of a `DeviceMesh`: stage s holds layers
[s*L/S, (s+1)*L/S); microbatches stream from each stage to the next
through point-to-point sends; the bubble is (S-1)/(S-1+n_micro).

Forward only. The reference scans its ticks so that the pipeline is
reverse-differentiable, but no entry point of the reference trains
through it (its dry-run runs the data x model mesh with the pipeline
off), and the port's sends carry no gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import mesh_axes
from repro_torch.training.optimizer import tree_map


def pipeline_apply(stage_fn, stacked_params, micro_x: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run microbatches through pipeline stages.

    stage_fn(params_slice, x) -> y, same shape as x.
    stacked_params: tree, leading dim = n_stages; every rank passes the
        whole of it and keeps its own stage's slice.
    micro_x: (n_micro, mb, ...) input microbatches, the same on every rank.
    mesh: a `DeviceMesh` with the axis `axis`.
    Returns (n_micro, mb, ...) outputs, the same on every rank.
    """
    if not hasattr(mesh, "get_group"):
        raise TypeError("pipeline_apply needs a DeviceMesh (an abstract "
                        "mesh has no devices to run stages on)")
    n_stages = mesh_axes(mesh)[axis]
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    n_micro = micro_x.shape[0]
    is_first, is_last = sid == 0, sid == n_stages - 1
    nxt = None if is_last else dist.get_global_rank(group, sid + 1)
    prv = None if is_first else dist.get_global_rank(group, sid - 1)
    p = tree_map(lambda a: a[sid], stacked_params)

    state = torch.zeros_like(micro_x[0])
    outs = torch.zeros_like(micro_x)
    for t in range(n_micro + n_stages - 1):
        inp = micro_x[min(t, n_micro - 1)] if is_first else state
        h = stage_fn(p, inp)
        out_idx = t - (n_stages - 1)
        if is_last and out_idx >= 0:
            outs[out_idx] = h
        # each stage hands h to the next one; the first receives nothing
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, h.contiguous(), nxt, group))
        if prv is not None:
            state = torch.empty_like(h)
            ops.append(dist.P2POp(dist.irecv, state, prv, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        else:
            state = torch.zeros_like(h)
    # broadcast the last stage's outputs (zeros elsewhere) to every stage
    dist.all_reduce(outs, group=group)
    return outs
