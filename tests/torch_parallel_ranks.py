"""Run `repro_torch.parallel` and the mesh half of `repro_torch.models.model`
on 4 CPU processes (`gloo`, rendezvous through a file), for
`tests/test_torch_parallel.py`.

    python tests/torch_parallel_ranks.py INPUTS REFERENCE OUT

INPUTS and REFERENCE are pickles of numpy trees that the test wrote (the
inputs, drawn from numpy seeds, and the reference's parameters and cache);
rank 0 writes the results to OUT, a pickle of numpy arrays and flags.
Imports no JAX.
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().float().numpy()


def _count_combines(model_lib):
    """Wrap the model's `combine_partial_softmax` to count its calls."""
    calls = [0]
    inner = model_lib.combine_partial_softmax

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    model_lib.combine_partial_softmax = counted
    return calls


def _same_on_every_rank(t) -> bool:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(torch.equal(p, parts[0]) for p in parts)


def _combine(inp, ranks):
    """Flash-decoding over `len(ranks)` sequence shards: each rank's partial
    softmax over its slice of the keys, merged by `combine_partial_softmax`
    over a group of those ranks."""
    from repro_torch.models import attention as attn
    from repro_torch.parallel.collectives import combine_partial_softmax
    group = dist.new_group(ranks)          # every rank takes part in this
    rank = dist.get_rank()
    if rank not in ranks:
        return None
    q, kc, vc, cl = (_t(inp[k]) for k in ("q", "kc", "vc", "cache_len"))
    n, i = len(ranks), ranks.index(rank)
    s_loc = kc.shape[2] // n
    pos = i * s_loc + torch.arange(s_loc)
    valid = pos[None, :] < cl[:, None]
    sl = slice(i * s_loc, (i + 1) * s_loc)
    num, den, m = attn.decode_attention_partial(q, kc[:, :, sl],
                                                vc[:, :, sl], valid)
    return _np(combine_partial_softmax(num, den, m, group))


def run(rank, rdzv, inputs_path, ref_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=WORLD)
    try:
        _checks(rank, inputs_path, ref_path, out_path)
    finally:
        dist.destroy_process_group()


def _checks(rank, inputs_path, ref_path, out_path):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import decode_step
    from repro_torch.models import model as model_lib
    from repro_torch.parallel import constrain, shardctx
    from repro_torch.parallel.collectives import ring_all_gather
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.weights import cache_from_jax, params_from_jax

    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    out = {}

    # the combine on 2 and on 4 ranks
    out["combine"] = {n: _combine(inp["combine"], list(range(n)))
                      for n in (2, 4)}

    # the ring all-gather against all_gather, on every rank
    x = _t(inp["ring"]) + rank
    ring = ring_all_gather(x)
    parts = [torch.empty_like(x) for _ in range(WORLD)]
    dist.all_gather(parts, x)
    ok = torch.tensor([float(torch.equal(ring, torch.stack(parts)))])
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    out["ring_equal"] = bool(ok.item())

    # the pipeline over a 4-stage mesh, tanh stages
    stage = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("stage",))
    pp = inp["pipeline"]
    got = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]),
                         {"w": _t(pp["w"])}, _t(pp["x"]), stage)
    out["pipeline"] = _np(got)
    out["pipeline_same_on_every_rank"] = _same_on_every_rank(got)

    mesh22 = make_host_mesh(model=2)
    data4 = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    out["host_mesh"] = (tuple(mesh22.mesh_dim_names),
                        tuple(mesh22.mesh.shape))

    # the four gates of `_flash_decode_attention`, and the case past them
    calls = _count_combines(model_lib)
    out["gates"] = {}
    for name, case in inp["gates"].items():
        mesh = data4 if case["mesh"] == "data4" else mesh22
        q, kc, vc, cl = (_t(case[k]) for k in ("q", "kc", "vc",
                                                "cache_len"))
        before = calls[0]
        with shardctx(mesh):
            o = model_lib._flash_decode_attention(q, kc, vc, cl)
        out["gates"][name] = {
            "sharded": calls[0] > before, "out": _np(o),
            "plain": _np(attn.decode_attention(q, kc, vc, cl)),
            "same_on_every_rank": _same_on_every_rank(o)}

    # reduced llama31-8b's decode_step under the (2, 2) mesh, from the
    # reference's parameters and prefilled cache
    cfg = reduced("llama31-8b", vocab=1024)
    params = params_from_jax(ref["params"], cfg)
    cache = cache_from_jax(ref["cache"], cfg)
    token = _t(ref["token"])
    model_lib.PERF.flash_decode = True
    before = calls[0]
    logits = []
    with shardctx(mesh22):
        for _ in range(2):
            lg, cache = decode_step(params, cfg, token, cache)
            logits.append(_np(lg))
            token = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
    model_lib.PERF.flash_decode = False
    out["decode"] = {"logits": logits, "sharded_calls": calls[0] - before,
                     "k": [_np(c["k"]) for c in cache["layers"]],
                     "v": [_np(c["v"]) for c in cache["layers"]],
                     "same_on_every_rank": _same_on_every_rank(
                         torch.from_numpy(logits[-1]))}

    # `_local_batch_shard_map`: a Mamba block on the rank's batch shard
    # equals the block on the whole batch; at batch 1 it falls back
    jcfg = reduced("jamba-v0.1-52b", vocab=1024)
    from repro_torch.models import init_params
    from repro_torch.models import ssm as ssm_lib
    lp = init_params(jcfg, device="cpu", dtype=torch.float32,
                     generator=torch.Generator().manual_seed(3))
    mp_ = next(p["mamba"] for p in lp["layers"] if "mamba" in p)
    fn = lambda p_, h_: ssm_lib.apply_mamba(p_, h_, jcfg.ssm)
    h = _t(inp["mamba_x"])
    whole = fn(mp_, h)
    with shardctx(mesh22):
        split = model_lib._local_batch_shard_map(fn, mp_, h)
        one = model_lib._local_batch_shard_map(fn, mp_, h[:1])
    flat = lambda r: [r[0], r[1]["conv"], r[1]["h"]]
    out["local_batch"] = {
        "max_diff": max(float((a - b).abs().max())
                        for a, b in zip(flat(whole), flat(split))),
        "shapes_equal": all(a.shape == b.shape
                            for a, b in zip(flat(whole), flat(split))),
        "fallback_equal": all(torch.equal(a, b) for a, b in zip(
            flat(one), flat(fn(mp_, h[:1]))))}

    # constrain: a DTensor is redistributed to the resolved placements,
    # a plain tensor is left as it is
    y = _t(inp["ring"]).reshape(4, -1)
    dt = distribute_tensor(y, mesh22, [Replicate(), Replicate()])
    with shardctx(mesh22):
        c = constrain(dt, "batch", "ff")
        plain = constrain(y, "batch", "ff")
    out["constrain"] = {
        "placements": tuple(c.placements) == (Shard(0), Shard(1)),
        "values": torch.equal(c.full_tensor(), y), "plain": plain is y}

    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


def main():
    inputs_path, ref_path, out_path = sys.argv[1:4]
    rdzv = os.path.join(os.path.dirname(os.path.abspath(out_path)), "rdzv")
    mp.spawn(run, args=(rdzv, inputs_path, ref_path, out_path),
             nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
