"""Run `repro_torch.parallel` and the mesh half of `repro_torch.models.model`
on 4 CPU processes (`gloo`, rendezvous through a file), for
`tests/test_torch_parallel.py`.

    python tests/torch_parallel_ranks.py INPUTS REFERENCE OUT
    python tests/torch_parallel_ranks.py --restore WORLD OUT

INPUTS and REFERENCE are pickles of numpy trees that the test wrote (the
inputs, drawn from numpy seeds, and the reference's parameters and cache);
rank 0 writes the results to OUT, a pickle of numpy arrays and flags.
`--restore` runs only the sharded checkpoint restore, on WORLD ranks.
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

    out["dtensor"] = _dtensor_checks(ref, mesh22)

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


def _as_dtensors(tree, placements, mesh):
    """Every tensor of `tree` distributed at its placements (None:
    replicated)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    if isinstance(tree, dict):
        return {k: _as_dtensors(v, placements[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Tensor):
        return type(tree)(_as_dtensors(v, p, mesh)
                          for v, p in zip(tree, placements))
    if tree is None:
        return None
    pl = placements or (Replicate(),) * mesh.ndim
    return distribute_tensor(tree, mesh, pl)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _max_rel(a, b):
    a, b = _full(a).float(), _full(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _decode_pair(cfg, params, cache, token, mesh):
    """Two decode steps on plain tensors and on DTensors at
    `launch.specs`' placements: the largest differences of the logits and
    of the K/V caches relative to the plain ones' largest magnitudes."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import specs
    from repro_torch.models import decode_step
    from repro_torch.parallel import shardctx
    from repro_torch.parallel.sharding import logical_spec, placements
    pl = specs.placements_tree(specs.param_shardings(cfg, params, mesh),
                               mesh)
    cpl = specs.placements_tree(specs.cache_shardings(cfg, cache, mesh),
                                mesh)
    tpl = placements(logical_spec(tuple(token.shape), ("batch", None), mesh),
                     mesh)
    want, wc = decode_step(params, cfg, token, cache)
    want2, wc2 = decode_step(params, cfg, token, wc)
    with shardctx(mesh), implicit_replication():
        dp = _as_dtensors(params, pl, mesh)
        dc = _as_dtensors(cache, cpl, mesh)
        dt = _as_dtensors(token, tpl, mesh)
        got, gc = decode_step(dp, cfg, dt, dc)
        got2, gc2 = decode_step(dp, cfg, dt, gc)
    return {"dtensor": hasattr(got2, "placements"),
            "logits": max(_max_rel(got, want), _max_rel(got2, want2)),
            "kv": max(_max_rel(g[n], w[n])
                      for g, w in zip(gc2["layers"], wc2["layers"])
                      for n in ("k", "v"))}


def _dtensor_checks(ref, mesh):
    """Reduced llama31-8b (f32, one KV head) with its arguments as
    DTensors at `launch.specs`' placements on the (2, 2) mesh, as the
    dry-run runs a cell, against the same functions on plain tensors:
    two decode steps (the sharded cache update, the head splits, the
    row-parallel products; with and without `PERF.flash_decode`), the
    same for reduced codeqwen1.5-7b (its 4 KV heads split over the model
    axis), and one adamw8bit train step of 2 micro-batches (the loss's label pick, the
    shard-local micro-batches, the 8-bit update on each leaf's shards).
    Returns the largest differences relative to the plain results'
    largest magnitudes."""
    import copy
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import reduced
    from repro_torch.launch import specs
    from repro_torch.models import init_params, prefill
    from repro_torch.models import model as model_lib
    from repro_torch.parallel import shardctx
    from repro_torch.training import adamw8bit, build_train_step
    from repro_torch.weights import cache_from_jax, params_from_jax

    cfg = reduced("llama31-8b", vocab=1024)
    params = params_from_jax(ref["params"], cfg)
    pl = specs.placements_tree(specs.param_shardings(cfg, params, mesh),
                               mesh)
    out = {}
    for flash in (False, True):
        model_lib.PERF.flash_decode = flash
        out[f"decode flash={flash}"] = _decode_pair(
            cfg, params, cache_from_jax(ref["cache"], cfg), _t(ref["token"]),
            mesh)
    model_lib.PERF.flash_decode = False
    # 4 KV heads, split over the model axis while the batch is split over
    # the data axis: attention's einsums take the batch-local path
    qcfg = reduced("codeqwen1.5-7b", vocab=1024)
    qparams = init_params(qcfg, device="cpu", dtype=torch.float32,
                          generator=torch.Generator().manual_seed(12))
    toks = torch.randint(0, 1000, (4, 12), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(13))
    lg, qcache = prefill(qparams, qcfg, {"tokens": toks}, max_len=16)
    out["decode codeqwen"] = _decode_pair(
        qcfg, qparams, qcache,
        torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None], mesh)

    g = torch.Generator().manual_seed(11)
    batch = {"tokens": torch.randint(0, 1000, (4, 16), generator=g,
                                     dtype=torch.int32)}
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    opt = adamw8bit(1e-3)
    step = build_train_step(cfg, opt, accum_steps=2)
    p0, s0 = copy.deepcopy(params), opt.init(params)
    state_pl = specs.placements_tree(specs.opt_shardings(cfg, s0, mesh),
                                     mesh)
    bpl = specs.placements_tree(specs.batch_shardings(batch, mesh), mesh)
    with shardctx(mesh), implicit_replication():
        dp = _as_dtensors(copy.deepcopy(params), pl, mesh)
        ds = _as_dtensors(copy.deepcopy(s0), state_pl, mesh)
        db = _as_dtensors(batch, bpl, mesh)
        dp, ds, dstats = step(dp, ds, db)
    wp, ws, wstats = step(p0, s0, batch)
    leaves = lambda t: [x for x in _leaves(t) if x is not None]
    out["train"] = {
        "loss": _max_rel(dstats["loss"], wstats["loss"]),
        "grad_norm": _max_rel(dstats["grad_norm"], wstats["grad_norm"]),
        "params": max(_max_rel(a, b) for a, b in zip(leaves(dp),
                                                      leaves(wp))),
        "m_codes_equal_share": float(np.mean([
            float((_full(a["q"]) == b["q"]).float().mean())
            for a, b in zip(_qs(ds["m"]), _qs(ws["m"]))])),
        "step": int(_full(ds["step"])) == int(ws["step"]) == 1}
    return out


def _leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _qs(t):
    """The {"q", "scale"} nodes of an 8-bit moment tree."""
    if isinstance(t, dict):
        if set(t) == {"q", "scale"}:
            return [t]
        return [x for v in t.values() for x in _qs(v)]
    if isinstance(t, list):
        return [x for v in t for x in _qs(v)]
    return []


def run_restore(rank, world, rdzv, out_path):
    """Rank 0 saves reduced llama31-8b's bf16 parameters and adamw8bit
    state (step 1) and a step 2 whose arrays it then corrupts; every rank
    restores step 1 with `shardings` on a (world // 2 or 2, ...) mesh and
    unsharded, and `restore_latest` with `shardings`."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world)
    try:
        _restore_checks(rank, world, out_path)
    finally:
        dist.destroy_process_group()


def _restore_checks(rank, world, out_path):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.configs import reduced
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.parallel import shardctx
    from repro_torch.training import CheckpointManager, adamw8bit

    cfg = reduced("llama31-8b", vocab=1024, d_model=512, ff=1024)
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    state = adamw8bit(1e-3).init(params)
    for q in _qs(state["m"]) + _qs(state["v"]):
        q["q"].random_(-127, 128, generator=torch.Generator().manual_seed(
            q["q"].numel()))
    tree = {"params": params, "opt": state}
    ckdir = os.path.join(os.path.dirname(os.path.abspath(out_path)),
                         f"ckpt{world}")
    cm = CheckpointManager(ckdir, keep=5, async_save=False)
    if rank == 0:
        cm.save(1, tree, extra={"world": world})
        cm.save(2, tree)
        with open(os.path.join(ckdir, "step_000000002", "arrays.npz"),
                  "r+b") as f:
            f.seek(200)
            f.write(b"\x00" * 64)
    dist.barrier()
    mesh = make_host_mesh(model=2 if world == 4 else 1)
    shardings = {
        "params": specs.placements_tree(
            specs.param_shardings(cfg, params, mesh, fsdp="on"), mesh),
        "opt": specs.placements_tree(specs.opt_shardings(cfg, state, mesh),
                                     mesh)}
    with shardctx(mesh):
        got, extra = cm.restore(1, tree, shardings)
        latest = cm.restore_latest(tree, shardings)
    plain, _ = cm.restore(1, tree)
    flags = {"equal": True, "dtensors": 0, "sharded": 0, "leaves": 0}

    def bits(t):
        return t.view(torch.uint16) if t.dtype == torch.bfloat16 else t

    def check(g, p):
        flags["leaves"] += 1
        if not isinstance(g, DTensor):
            flags["equal"] &= torch.equal(bits(g), bits(p))
            return
        flags["dtensors"] += 1
        shape, off = compute_local_shape_and_global_offset(
            p.shape, mesh, g.placements)
        want = p[tuple(slice(o, o + n) for o, n in zip(off, shape))]
        flags["sharded"] += int(tuple(shape) != tuple(p.shape))
        flags["equal"] &= torch.equal(bits(g.to_local()), bits(want))

    for g, p in zip(_leaves(got), _leaves(plain)):
        check(g, p)
    flags["extra"] = extra == {"world": world}
    flags["latest_step"] = latest[0]
    flags["latest_equal"] = all(
        torch.equal(bits(a.to_local() if isinstance(a, DTensor) else a),
                    bits(b.to_local() if isinstance(b, DTensor) else b))
        for a, b in zip(_leaves(latest[1]), _leaves(got)))
    every = [None] * world
    dist.all_gather_object(every, flags)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(every, f)


def main():
    if sys.argv[1] == "--restore":
        world, out_path = int(sys.argv[2]), sys.argv[3]
        rdzv = os.path.join(os.path.dirname(os.path.abspath(out_path)),
                            f"rdzv{world}")
        mp.spawn(run_restore, args=(world, rdzv, out_path), nprocs=world,
                 join=True)
        return
    inputs_path, ref_path, out_path = sys.argv[1:4]
    rdzv = os.path.join(os.path.dirname(os.path.abspath(out_path)), "rdzv")
    mp.spawn(run, args=(rdzv, inputs_path, ref_path, out_path),
             nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
