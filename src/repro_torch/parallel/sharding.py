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
        return dict(zip(names, mesh.mesh.shape))
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
    if current_mesh() is None or not hasattr(x, "redistribute"):
        return x
    spec = logical_spec(x.shape, names, x.device_mesh)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


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
