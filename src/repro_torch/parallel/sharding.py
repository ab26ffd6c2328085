"""Logical-axis sharding rules (MaxText-style), resolved against the ambient mesh.

Counterpart of `repro.parallel.sharding`. Every tensor carries *logical*
axis names ("batch", "ff", "vocab", ...). A ShardingRules table maps
logical names to mesh axes. The resolver drops any mapping whose mesh-axis
product does not divide the concrete dimension, and uses a mesh axis at
most once in a spec (first dim wins), so one rule set serves every
(arch x shape x mesh).

A spec is the port's `P`: a tuple of per-dimension entries (None, a mesh
axis name, or a tuple of names), element for element the reference's
`PartitionSpec`. A mesh is read only through its axis names and sizes, so
the functions take both the port's `AbstractMesh` (names and sizes, no
devices: the production meshes of 256 and 512 chips) and a
`torch.distributed.device_mesh.DeviceMesh` (through its
`mesh_dim_names`).

The mesh is ambient: a launcher enters `shardctx(mesh)`; `constrain` is an
identity outside any context. Inside one, it redistributes a DTensor to
the resolved placements and leaves a plain tensor as it is: a sharding
constraint never changes values, and the port's eager model computes on
plain tensors, each rank holding the whole of them.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per leading tensor dimension, None
    (replicated), a mesh axis name, or a tuple of names (sharded over
    their product). Kept as given, as the reference's `PartitionSpec`
    (which keeps trailing Nones: `P("a", None) != P("a")` there too)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class AbstractMesh:
    """A mesh of named axes and their sizes, with no devices."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of an `AbstractMesh` or a `DeviceMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:               # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


# Logical axis -> mesh axes. "model" is the tensor-parallel axis; the batch
# dimension spreads over every data-parallel axis (pod x data).
DEFAULT_RULES: Dict[str, Axes] = {
    "batch": ("pod", "data"),
    "seq": None,                # flipped to "model" under sequence parallelism
    "kv_seq": ("pod", "data"),  # long-context (batch=1) KV shards over DP axes
    # KV-cache sequence axis: takes whatever axes the batch dim left free —
    # "model" for batched decode (heads permitting), all 512 ways at batch=1
    "kv_seq_tp": ("pod", "data", "model"),
    "d_model": None,
    "ff": "model",
    "heads_proj": "model",      # fused (H*hd) projection dim
    "qheads": "model",
    "kvheads": "model",
    "vocab": "model",
    "experts": "model",
    "ssm_inner": "model",
    "zero1": "data",            # optimizer-state sharding axis
    "stage": "stage",           # pipeline-parallel stage axis (opt-in meshes)
}


class ShardingRules(dict):
    """A dict of logical-axis -> mesh-axes with an override constructor."""

    def but(self, **overrides: Axes) -> "ShardingRules":
        new = ShardingRules(self)
        new.update(overrides)
        return new


DEFAULT = ShardingRules(DEFAULT_RULES)

_STATE = threading.local()


def current_mesh():
    return getattr(_STATE, "mesh", None)


def current_rules() -> ShardingRules:
    return getattr(_STATE, "rules", DEFAULT)


@contextlib.contextmanager
def shardctx(mesh, rules: Optional[ShardingRules] = None):
    """Install an ambient (mesh, rules) pair for constrain()/logical_spec()."""
    prev = (current_mesh(), current_rules())
    _STATE.mesh = mesh
    _STATE.rules = rules or DEFAULT
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def _axes_size(sizes: Dict[str, int], axes: Tuple[str, ...]) -> int:
    return math.prod(sizes[a] for a in axes)


def logical_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                 mesh=None, rules: Optional[ShardingRules] = None) -> P:
    """Resolve logical axis names against the mesh into a spec.

    Any mapping that does not divide the dimension (or references mesh axes
    that don't exist) is dropped — never an error. A mesh axis is used at
    most once across the whole spec (first dim wins). Trailing Nones are
    trimmed."""
    mesh = mesh or current_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return P()
    sizes = mesh_axes(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, names):
        axes = rules.get(name) if name else None
        if axes is None:
            parts.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        size = _axes_size(sizes, axes) if axes else 1
        if axes and size > 1 and dim % size == 0:
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def placements(spec: P, mesh):
    """The DTensor placements of `spec` on `mesh`, one per mesh dimension:
    `Shard(d)` where the spec puts the mesh axis on tensor dim d,
    `Replicate()` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else (part or ())):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh_axes(mesh))


def constrain(x, *names: Optional[str]):
    """The sharding constraint by logical names: identity with no mesh or
    on a plain tensor; a DTensor is redistributed to the resolved
    placements (its values unchanged)."""
    if current_mesh() is None or not is_dtensor(x):
        return x
    spec = logical_spec(x.shape, names, x.device_mesh)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


# ---------------------------------------------------------------------------
# DTensor: what it refuses that GSPMD does without a word, in one place.
# Each helper is the plain op on a plain tensor.
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor (the dry-run's arguments, a sharded
    restore's leaves)."""
    return hasattr(x, "placements")


def _split_on(x, dim: int) -> bool:
    """Whether `x` is a DTensor sharded along `dim`."""
    from torch.distributed.tensor import Shard
    dim = dim % x.ndim
    return is_dtensor(x) and any(
        isinstance(p, Shard) and p.dim == dim for p in x.placements)


def by_axes(mesh, dims: Dict[str, int]):
    """DTensor placements on a `DeviceMesh` from {mesh axis name: tensor
    dim}: `Shard(dim)` on the named axes, `Replicate()` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[a]) if a in dims else Replicate()
                 for a in mesh.mesh_dim_names)


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of `shape` (a DTensor's global
    strides, for `DTensor.from_local(..., shape=, stride=)`), computed
    without making a tensor: inside a counted dry-run a meta tensor would
    be one more op."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, v) for v in t)
    return t if t is None else fn(t)


def _tree_leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _tree_leaves(v)]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _tree_leaves(v)]
    return [] if t is None else [t]


def local_region(fn, mesh, args, arg_placements, out_placements):
    """A `shard_map` region: `fn(*local args)` on this rank's shards.
    Every tensor of the tree `args[i]` is taken at `arg_placements[i]`;
    each output tensor t comes back as a DTensor at `out_placements(t)`,
    a pair (placements, global shape). A DTensor argument is
    redistributed to its placements (the region's input collectives). A
    plain one is the same on every rank and is sliced to its shard with
    no communication; when every argument is plain the outputs are then
    gathered whole (`full_tensor`): the reference's contract of
    replicated in, replicated out."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    if not hasattr(mesh, "get_local_rank"):
        raise TypeError("a sharded region needs a DeviceMesh; an abstract "
                        "mesh has no ranks")
    rep = (Replicate(),) * mesh.ndim
    plain = not any(is_dtensor(t) for t in _tree_leaves(args))

    def local(t, pl):
        if not isinstance(t, torch.Tensor):
            return t
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return t.redistribute(mesh, pl).to_local()

    def wrap(t):
        pl, shape = out_placements(t)
        d = DTensor.from_local(t, mesh, pl, run_check=False,
                               shape=torch.Size(shape),
                               stride=contiguous_strides(shape))
        return d.full_tensor() if plain else d

    locs = [_tree_map(lambda t, pl=pl: local(t, pl), a)
            for a, pl in zip(args, arg_placements)]
    return _tree_map(wrap, fn(*locs))


def unflatten(x, dim: int, sizes: Sequence[int]):
    """`x.unflatten(dim, sizes)`: one dimension split into several (the
    head split of a fused projection, heads into (KV heads, group), a
    sequence into blocks). On a DTensor whose `dim` is sharded over mesh
    axes whose product does not divide `sizes[0]` (8 KV heads over a model
    axis of 16), those axes are replicated first, an explicit all-gather:
    DTensor refuses the view."""
    dim = dim % x.ndim
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        mesh_sizes = x.device_mesh.shape
        on_dim = [i for i, p in enumerate(x.placements)
                  if isinstance(p, Shard) and p.dim == dim]
        if sizes[0] % math.prod(mesh_sizes[i] for i in on_dim):
            pl = tuple(Replicate() if i in on_dim else p
                       for i, p in enumerate(x.placements))
            x = x.redistribute(x.device_mesh, pl)
    return x.unflatten(dim, tuple(sizes))


def split_last(x, n: int, d: int):
    """x (..., n * d) -> (..., n, d): the head split (`unflatten`)."""
    return unflatten(x, -1, (n, d))


def align_contraction(x, w):
    """x (..., K) ready for `x @ w` with w (K, N) a DTensor sharded on K:
    x's K is sharded over the same mesh axes (a local slice of a
    replicated x, no communication), so the product is the row-parallel
    one, a partial sum per rank, reduced where it is used. Left alone,
    DTensor may instead gather w and split x's rows over those axes,
    which turns a flattened (batch, seq) into a strided shard that its
    matmul cannot take. A plain x, or a w not sharded on K, is returned
    as it is."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    pl = tuple(Shard(last) if isinstance(pw, Shard) and pw.dim == 0
               and isinstance(px, Replicate) else px
               for px, pw in zip(x.placements, w.placements))
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def einsum(eq: str, *ops):
    """`torch.einsum`. On DTensors whose every split dimension is a batch
    index of `eq` (in every operand and in the output, split over the same
    mesh axis in each), the einsum of the local shards, wrapped as a
    DTensor split the same way: no communication, as DTensor's own rule
    would have it, but DTensor flattens the batch indices into one first,
    and a flattened (batch, heads) split over two mesh axes is a strided
    split its product refuses. Any other case is `torch.einsum`'s."""
    import torch
    if not ops or not all(is_dtensor(o) for o in ops):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    mesh = ops[0].device_mesh
    letter = {}                       # mesh dim -> the index split over it
    for o, sub in zip(ops, subs):
        for i, pl in enumerate(o.placements):
            if isinstance(pl, Shard):
                if letter.setdefault(i, sub[pl.dim]) != sub[pl.dim]:
                    return torch.einsum(eq, *ops)
            elif not isinstance(pl, Replicate):
                return torch.einsum(eq, *ops)
    for i, c in letter.items():
        if c not in out or not all(
                isinstance(o.placements[i], Shard)
                and sub[o.placements[i].dim] == c
                for o, sub in zip(ops, subs)):
            return torch.einsum(eq, *ops)
    size = {c: n for o, sub in zip(ops, subs) for c, n in zip(sub, o.shape)}
    shape = torch.Size(size[c] for c in out)
    local = torch.einsum(eq, *(o.to_local() for o in ops))
    pl = tuple(Shard(out.index(letter[i])) if i in letter else Replicate()
               for i in range(mesh.ndim))
    # the global strides in the local result's dimension order (einsum
    # may return a permuted layout)
    stride, acc = [0] * len(shape), 1
    for d in sorted(range(len(shape)), key=lambda d: local.stride(d)):
        stride[d] = acc
        acc *= shape[d]
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=tuple(stride))


def softmax(x, dim: int):
    """`torch.softmax(x, dim)`. On a DTensor split along `dim` (decode
    scores over a sequence-sharded cache), the same softmax spelled out:
    its max and its sum reduce over the split, an all-reduce of one value
    a row each, as GSPMD partitions the reference's; DTensor's own softmax
    gathers the whole dimension first. Anything else is `torch.softmax`."""
    import torch
    if _split_on(x, dim):
        e = torch.exp(x - x.amax(dim=dim, keepdim=True))
        return e / e.sum(dim=dim, keepdim=True)
    return torch.softmax(x, dim=dim)


def take_last(x, idx):
    """x[..., idx]: the entry of x's last dim at `idx` (x's leading
    shape) for each leading index, `torch.gather`. On a DTensor, a select
    against `idx`'s one-hot mask and a sum: the same value, elementwise on
    each shard, where the gather's backward would give every rank a
    zeros tensor of the whole input."""
    import torch
    if is_dtensor(x):
        hit = torch.arange(x.shape[-1], device=x.device) == idx[..., None]
        return torch.where(hit, x, 0.0).sum(dim=-1)
    return torch.gather(x, -1, idx[..., None])[..., 0]


def write_rows(cache, new, index):
    """`cache` (B, H, S, D) with new (B, 1, H, D) written at sequence
    position index[b] of each row b, as a new tensor (the given one
    untouched). On a DTensor cache (sharded by batch and sequence, where
    DTensor's `index_put` refuses), a select against the position's
    one-hot mask: the same values, elementwise on each shard, as GSPMD
    partitions the reference's scatter."""
    import torch
    if is_dtensor(cache):
        pos = torch.arange(cache.shape[2], device=cache.device)
        hit = (pos[None, :] == index[:, None])[:, None, :, None]
        return torch.where(hit, new.transpose(1, 2).to(cache.dtype), cache)
    bidx = torch.arange(new.shape[0], device=cache.device)
    cache = cache.clone()
    cache[bidx, :, index] = new[:, 0].to(cache.dtype)
    return cache


def micro_batch(v, i: int, n: int, k: int):
    """Micro-batch i (of k, n rows each) along dim 0: rows [i n, (i+1) n).
    A DTensor batch sharded on dim 0 over m ranks takes the i-th of k
    blocks of every rank's shard instead, as a data-parallel trainer
    walks its own rows: the same rows over the k micro-batches, grouped
    by shard, with no communication (a contiguous slice of a sharded
    dim would gather it)."""
    if not is_dtensor(v):
        return v[i * n:(i + 1) * n]
    from torch.distributed.tensor import Shard
    sizes = v.device_mesh.shape
    m = math.prod(sizes[j] for j, p in enumerate(v.placements)
                  if isinstance(p, Shard) and p.dim == 0)
    return v.unflatten(0, (m, k, n // m))[:, i].flatten(0, 1)


# ---------------------------------------------------------------------------
# Parameter specs by tree path (naming convention of the model zoo).
# ---------------------------------------------------------------------------

# (path-regex, logical names per dim). First match wins. Stacked layer params
# gain a leading replicated (scan) dim handled below.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"(^|/)embed$", ("vocab_embed", "d_model")),
    (r"(^|/)(pos_embed|enc_pos_embed)$", (None, None)),
    (r"(^|/)lm_head$", ("d_model", "vocab")),
    (r"(^|/)w[qkv]$", ("d_model", "heads_proj")),
    (r"(^|/)wo$", ("heads_proj", "d_model")),
    (r"(^|/)(gate|up)$", ("d_model", "ff")),
    (r"(^|/)down$", ("ff", "d_model")),
    (r"(^|/)experts_(gate|up)$", ("experts", "d_model", "ff")),
    (r"(^|/)experts_down$", ("experts", "ff", "d_model")),
    (r"(^|/)router$", ("d_model", None)),
    (r"(^|/)in_proj$", ("d_model", "ssm_inner")),
    (r"(^|/)out_proj$", ("ssm_inner", "d_model")),
    (r"(^|/)x_proj$", ("ssm_inner", None)),
    (r"(^|/)dt_proj$", (None, "ssm_inner")),
    (r"(^|/)conv_w$", ("ssm_inner", None)),
    (r"(^|/)A_log$", ("ssm_inner", None)),
    (r"(^|/)(D|dt_bias)$", ("ssm_inner",)),
    # xLSTM blocks are small: replicate.
    (r"(^|/)(mlstm|slstm)_", ()),
    (r"(^|/)(scale|bias)$", ()),
)


def _names_for_path(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    for pat, names in _PARAM_RULES:
        if re.search(pat, path):
            names = tuple(names)[:ndim]
            if len(names) < ndim:  # stacked (scan) leading dims -> replicated
                names = (None,) * (ndim - len(names)) + names
            return names
    return (None,) * ndim


# vocab-sharded table for tied embeddings, d-sharded for untied lookup-only
# tables: resolved by the caller passing `tied_embeddings`.
def _resolve_embed(names, tied: bool):
    return tuple(("vocab" if tied else None) if n == "vocab_embed"
                 else ("d_model" if (n == "d_model" and not tied) else
                       (None if n == "d_model" else n)) for n in names)


def param_spec_tree(params, mesh=None,
                    rules: Optional[ShardingRules] = None, *,
                    tied_embeddings: bool = False):
    """A spec tree matching `params` (dicts and lists of tensors, quantized
    `{"q", "scale"}` nodes). A tensor is read by its logical shape only,
    so meta tensors serve, and an int8 matrix stored K-major (strides (1,
    K_pad)) resolves by its `(K, N)` shape, as the reference's row-major
    one. The port's one dict a layer (`params["layers"]`) takes the
    reference's per-layer names; its specs are the reference's with the
    stacked (scan) dimension left out."""
    mesh = mesh or current_mesh()
    rules = rules or current_rules()

    def visit(node, path: str):
        if isinstance(node, dict):
            # quantized weight {"q":..,"scale":..} shards like the weight
            if set(node) == {"q", "scale"}:
                qspec = visit(node["q"], path)
                sspec = (P() if node["scale"] is None or mesh is None
                         else logical_spec(
                             node["scale"].shape,
                             _names_for_path(path, node["scale"].ndim),
                             mesh, rules))
                return {"q": qspec, "scale": sspec}
            return {k: visit(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v, path) for v in node)
        if node is None:
            return None
        names = _names_for_path(path, node.ndim)
        if "vocab_embed" in names:
            names = _resolve_embed(names, tied_embeddings)
        if mesh is None:
            return P()
        return logical_spec(node.shape, names, mesh, rules)

    return visit(params, "")


def zero1_spec(weight_spec: P, shape: Sequence[int], mesh=None,
               rules: Optional[ShardingRules] = None) -> P:
    """Optimizer-state spec: weight spec + ZeRO-1 sharding over the data axis
    on the first still-replicated, divisible dimension."""
    mesh = mesh or current_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return P()
    sizes = mesh_axes(mesh)
    axes = rules.get("zero1")
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in (axes or ()) if a in sizes)
    if not axes:
        return weight_spec
    used = set()
    for part in weight_spec:
        if isinstance(part, tuple):
            used.update(part)
        elif part is not None:
            used.add(part)
    axes = tuple(a for a in axes if a not in used)
    if not axes:
        return weight_spec
    size = _axes_size(sizes, axes)
    parts = list(weight_spec) + [None] * (len(shape) - len(weight_spec))
    for i, dim in enumerate(shape):
        if parts[i] is None and dim % size == 0 and size > 1:
            parts[i] = axes if len(axes) > 1 else axes[0]
            break
    return P(*parts)


def shardings_for(params, mesh=None, **kw):
    """The placements tree for `params` on `mesh` (`placements` of each
    spec: what `torch.distributed.tensor.distribute_tensor` takes), or the
    spec tree (all `P()`) without a mesh."""
    mesh = mesh or current_mesh()
    specs = param_spec_tree(params, mesh, **kw)
    if mesh is None:
        return specs

    def visit(node):
        if isinstance(node, P):
            return placements(node, mesh)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        return node

    return visit(specs)
