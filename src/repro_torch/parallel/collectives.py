"""Collective helpers on `torch.distributed` process groups.

Counterpart of `repro.parallel.collectives`, whose functions run inside
`shard_map` regions over a named mesh axis; here each takes the process
group of that axis (`DeviceMesh.get_group(name)`), and every rank of the
group calls it. The flash-decoding combine merges partial-softmax
attention results computed on sequence shards of a KV cache: each shard
holds (numerator, denominator, running max); the merge rescales by
exp(m_local - m_global) and sums. Each function raises where no process
group is initialised: there is no silent single-rank identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _require_group():
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group is "
                           "initialised; a collective needs one "
                           "(init_process_group)")


def combine_partial_softmax(num: torch.Tensor, den: torch.Tensor,
                            m: torch.Tensor, group=None) -> torch.Tensor:
    """Merge flash-decoding partials across `group`.

    num: (..., D) fp32 partial numerator   sum_j e^{s_j - m_local} v_j
    den: (..., 1) fp32 partial denominator sum_j e^{s_j - m_local}
    m:   (..., 1) fp32 local running max (-inf where the shard saw no keys)
    Returns the exact softmax-weighted value combine, fp32, on every rank.
    """
    _require_group()
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    m_safe = torch.where(torch.isfinite(m_glob), m_glob,
                         torch.zeros_like(m_glob))
    scale = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                        torch.zeros_like(m))
    num = num * scale
    den = den * scale
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    return num / torch.clamp(den, min=1e-30)


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-gather over `group` through a ring of point-to-point hops,
    stacking the ranks' shards on a new leading axis: at hop i a rank
    holds the shard of the rank i places before it and writes it at
    `(idx - i) % n`, then passes it on to the next rank."""
    _require_group()
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    buf = x.new_zeros((n,) + tuple(x.shape))
    cur = x.contiguous()
    for i in range(n):
        buf[(idx - i) % n] = cur
        if i == n - 1:
            break                   # the last hop would bring back x
        recv = torch.empty_like(cur)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)]):
            req.wait()
        cur = recv
    return buf
