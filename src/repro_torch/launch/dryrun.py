"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on fake
tensors over a fake process group, and count what each device would do.

Counterpart of `repro.launch.dryrun`, which lowers and compiles each cell
for 256 or 512 placeholder host devices and reads XLA's cost and memory
analyses and its HLO. The port has no compiler to ask, so it runs the
step itself, as rank 0 of a `fake` process group of 256 or 512 ranks
(`torch.testing._internal.distributed.fake_pg`, no communication), on a
`DeviceMesh` named as `launch.mesh.make_production_mesh`'s:

  * arguments (parameters, optimizer state, batch, cache) are DTensors at
    the placements `launch.specs` gives, each made with
    `DTensor.from_local(..., run_check=False)` from a fake local shard:
    no memory, no collective;
  * the step runs under `FakeTensorMode` (shapes and dtypes, no data),
    `shardctx(mesh, rules)` and `implicit_replication()` (a plain tensor
    the step makes, a constant or an index, is replicated, as a traced
    constant is under GSPMD);
  * `OpCounter`, a dispatch mode, sees the ops DTensor runs on the local
    shards and the collectives it issues. It counts FLOPs a device
    (`torch.utils.flop_counter`'s formulas on the local ops), bytes
    accessed (each local op's operand and result bytes, unfused, as
    XLA:CPU's count is), collective operand bytes by the reference's kinds
    (what `hlo_analysis.collective_bytes` counts), and the peak of the live
    bytes the step's ops make (`temp_size_in_bytes`).

Ops on DTensors themselves, and the tensor-meta propagation DTensor runs
on fake tensors of the global shape, are not counted: a device does the
local ops only. `compute_roofline` is then called unchanged. A record
keeps every key of the reference's; `hlo_bytes` and
`generated_code_size_in_bytes` have no counterpart (there is no HLO and
no compiled code) and are null or absent, and `measured_by` says how each
number was obtained. A cell that raises fails: the CLI prints
`FAIL [...]` and exits 1. Records go to examples_out/dryrun/.

Usage:
    python -m repro_torch.launch.dryrun --arch llama31-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--quant int8]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ALL_ARCHS, SHAPES_BY_NAME, get_config
from repro_torch.launch.hlo_analysis import COLLECTIVE_OPS
from repro_torch.launch.roofline import compute_roofline
from repro_torch.launch.specs import build_cell, placements_tree
from repro_torch.parallel.sharding import contiguous_strides, shardctx
from repro_torch.quant import BY_NAME as QUANT_BY_NAME
from repro_torch.simulate.hardware import HW_BY_NAME

RESULTS = Path(__file__).resolve().parents[3] / "examples_out" / "dryrun"

MESHES = {False: ((16, 16), ("data", "model"), "16x16"),
          True: ((2, 16, 16), ("pod", "data", "model"), "2x16x16")}

# collective ops -> (the reference's kind, the argument holding the
# operands): the functional collectives DTensor issues, and the c10d ops
# `torch.distributed` calls issue (whose outputs come first)
_COLLECTIVE_KIND = {
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
}
# ops that move nothing: a wait, a device query
_FREE = {"_c10d_functional.wait_tensor", "prim.device", "c10d.recv_"}

MEASURED_BY = {
    "flops": "torch.utils.flop_counter formulas over the ops DTensor runs "
             "on the local shards (FLOPs a device)",
    "bytes accessed": "operand + result bytes of every local op that is "
                      "not a view, unfused",
    "collective_bytes": "operand bytes of every collective issued on the "
                        "local shard, by kind",
    "memory_analysis": "argument/output: local-shard bytes of the step's "
                       "arguments and outputs; temp: peak live bytes of "
                       "the tensors the step's local ops make (outputs "
                       "included), tracked by their storages' lifetimes; "
                       "unread_argument: local-shard bytes of the "
                       "arguments no op read (XLA drops those from its "
                       "argument bytes)",
}


def _name(func) -> str:
    return str(func._overloadpacket)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the local ops and collectives a device runs (see the module
    docstring). Ops on DTensors pass through uncounted (DTensor runs them
    as local ops, which this mode then sees), and so does DTensor's
    tensor-meta propagation on global-shape fake tensors."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {k: 0 for k in COLLECTIVE_OPS}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}
        self._muted = 0
        self._args: Dict[int, int] = {}
        self._read: set = set()

    def watch(self, tree):
        """Note the local shards of the DTensors in `tree` (the step's
        arguments), to tell which of them no op reads."""
        for t in tree_leaves(tree):
            if hasattr(t, "to_local"):
                loc = t.to_local()
                self._args[loc.untyped_storage()._cdata] = _nbytes(loc)

    @property
    def unread_argument_bytes(self) -> int:
        """Bytes of the watched local shards that no counted op (a view
        aside) read: arguments the step never uses, which XLA's jit drops
        from its executable (`keep_unused=False`) and so from its
        argument bytes."""
        return sum(n for k, n in self._args.items() if k not in self._read)

    @contextlib.contextmanager
    def muted(self):
        self._muted += 1
        try:
            yield
        finally:
            self._muted -= 1

    def _track(self, t: torch.Tensor, new: bool):
        st = t.untyped_storage()
        key = st._cdata
        ent = self._storages.get(key)
        if ent is None:
            if not new:
                return                  # a view of an argument
            ent = self._storages[key] = [st.nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        ent = self._storages.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._muted:
            return out
        name = _name(func)
        if name in _FREE:
            return out
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        coll = _COLLECTIVE_KIND.get(name)
        if coll is not None:
            kind, arg = coll
            self.collectives[kind] += sum(
                _nbytes(a) for a in tree_leaves(args[arg])
                if isinstance(a, torch.Tensor))
        elif name.startswith(("c10d.", "_c10d_functional.")):
            raise NotImplementedError(f"dry-run: uncounted collective {name}")
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        aliases = [r.alias_info for r in func._schema.returns
                   if r.alias_info is not None]
        view = bool(aliases) and not any(a.is_write for a in aliases)
        if not view:
            self._read.update(a.untyped_storage()._cdata for a in ins)
            self.bytes_accessed += (sum(_nbytes(a) for a in ins)
                                    + sum(_nbytes(o) for o in outs))
            if func._overloadpacket in flop_registry:
                self.flops += flop_registry[func._overloadpacket](
                    *args, **kwargs, out_val=out)
        for o in outs:
            self._track(o, new=not aliases)
        return out


@contextlib.contextmanager
def counting(counter: OpCounter):
    """Enter `counter`, muted while DTensor propagates tensor metadata on
    fake tensors of the global shape (those ops run on no device)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def propagate(self, *a, **kw):
        with counter.muted():
            return orig(self, *a, **kw)

    ShardingPropagator._propagate_tensor_meta_non_cached = propagate
    try:
        with counter:
            yield counter
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


@contextlib.contextmanager
def fake_mesh(multi_pod: bool = False):
    """A `fake` process group of 256 (or 512) ranks with this process as
    rank 0, and the production mesh on it; destroyed on exit. Raises if a
    process group is already initialised."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run makes its own fake one")
    shape, names, _ = MESHES[multi_pod]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def shard_like(t: torch.Tensor, mesh, placements, fake_mode):
    """A DTensor of `t`'s global shape and dtype at `placements` whose
    local shard is a fake tensor of this rank's local shape."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local_shape, _ = compute_local_shape_and_global_offset(
        t.shape, mesh, placements)
    with fake_mode:
        local = torch.empty(local_shape, dtype=t.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape,
                              stride=contiguous_strides(t.shape))


def distribute_args(args, specs, mesh, fake_mode):
    """Every tensor of `args` as a DTensor at its spec's placements."""
    pls = placements_tree(specs, mesh)

    def visit(a, pl):
        if isinstance(a, dict):
            return {k: visit(v, pl[k]) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(visit(v, p) for v, p in zip(a, pl))
        if isinstance(a, torch.Tensor):
            return shard_like(a, mesh, pl, fake_mode)
        return a

    return tuple(visit(a, pl) for a, pl in zip(args, pls))


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in `tree`."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            total += _nbytes(t.to_local() if hasattr(t, "to_local") else t)
    return total


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             quant: str = "bf16", hw: str = "h100-sxm",
             rules=None, save: bool = True, verbose: bool = True) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    _, _, mesh_name = MESHES[multi_pod]
    qcfg = QUANT_BY_NAME[quant] if quant != "bf16" else None

    t0 = time.time()
    with fake_mesh(multi_pod) as mesh, shardctx(mesh, rules):
        n_dev = mesh.size()
        fn, args_abs, specs, _ = build_cell(cfg, shape, mesh, qcfg)
        fake_mode = FakeTensorMode()
        args = distribute_args(args_abs, specs, mesh, fake_mode)
        counter = OpCounter()
        counter.watch(args)
        with fake_mode, implicit_replication(), counting(counter):
            out = fn(*args)
        arg_bytes = local_bytes(args)
        out_bytes = local_bytes(out)
        del out, args
    compile_s = time.time() - t0

    cost = {"flops": float(counter.flops),
            "bytes accessed": float(counter.bytes_accessed)}
    mem_d = {"argument_size_in_bytes": arg_bytes,
             "output_size_in_bytes": out_bytes,
             "temp_size_in_bytes": counter.peak,
             "unread_argument_size_in_bytes": counter.unread_argument_bytes}
    coll = {k: float(v) for k, v in counter.collectives.items()}
    coll["total"] = sum(coll[k] for k in COLLECTIVE_OPS)

    terms = compute_roofline(
        cfg, shape, mesh_name=mesh_name, n_devices=n_dev, cost=cost,
        coll_bytes=coll["total"], hw=HW_BY_NAME[hw], quant=quant)

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "quant": quant, "hw": hw, "n_devices": n_dev,
        "compile_s": compile_s,
        "cost_analysis": cost,
        "memory_analysis": {k: int(v) for k, v in mem_d.items()},
        "collective_bytes": coll,
        "roofline": terms.row(),
        "hlo_bytes": None,
        "status": "ok",
        "measured_by": MEASURED_BY,
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name} x {quant}] "
              f"run={compile_s:.1f}s "
              f"flops/dev={terms.flops_per_device:.3g} "
              f"bytes/dev={terms.bytes_per_device:.3g} "
              f"coll/dev={coll['total']:.3g} "
              f"bottleneck={terms.bottleneck} "
              f"frac={terms.roofline_frac:.3f}")
        print(f"  memory_analysis: {mem_d}")
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}_{shape_name}_{mesh_name}_{quant}".replace("/", "-")
        (RESULTS / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def cells_for(arch: str):
    cfg = get_config(arch)
    return [s.name for s in cfg.shapes()]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant", default="bf16")
    ap.add_argument("--hw", default="h100-sxm", choices=sorted(HW_BY_NAME))
    args = ap.parse_args(argv)

    jobs = []
    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    for a in archs:
        shapes = cells_for(a) if (args.all or not args.shape) \
            else [args.shape]
        for s in shapes:
            meshes = [args.multi_pod] if not args.both_meshes \
                else [False, True]
            for mp in meshes:
                jobs.append((a, s, mp))

    failures = []
    for a, s, mp in jobs:
        try:
            run_cell(a, s, multi_pod=mp, quant=args.quant, hw=args.hw)
        except Exception as e:
            failures.append((a, s, mp, repr(e)))
            print(f"FAIL [{a} x {s} x mp={mp}]: {e}")
            traceback.print_exc()
    print(f"\n{len(jobs) - len(failures)}/{len(jobs)} cells ran")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
