"""Mixture-of-Experts with capacity-grouped einsum dispatch.

Counterpart of `repro.models.moe`. Tokens are processed in groups; each
token picks its top-k experts; each expert accepts at most `capacity`
tokens per group, in token-major order, and the overflow is dropped.
Dispatch and combine are the reference's einsums over one-hot (group,
token, expert, slot) tensors. The port builds those tensors by adding each
(token, k) assignment's 1 (or its gate value) into its (expert, slot) cell,
times 0 where the assignment overflowed: the same values as the
reference's sum over k of one-hot products, without its (G, Sg, K, E, C)
intermediate. The expert MLPs are batched products over E, as the
reference leaves them to XLA. Experts stored int8 (a `{"q", "scale"}`
dict) on the card go to the grouped GEMM of `kernels.moe_gemm`, which
dequantizes each weight in registers to the bits of `quant.dequantize`
and never writes a bf16 copy (`uses_gemm`). Every other expert stack
(bf16, fp8, sharded as a DTensor, on the CPU) goes through `_w`, which
dequantizes a quantized one to bf16, and an einsum, exactly as in the
reference.

Ties in the router's top-k go to the lower expert index, as
`jax.lax.top_k` breaks them (`torch.topk` does not promise that).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.models.layers import INIT_STD, apply_mlp, init_mlp
from repro_torch.parallel.sharding import constrain, is_dtensor, local_region
from repro_torch.quant import dequantize
from repro_torch.tracing import span


def init_moe(d: int, cfg: MoEConfig, mlp_kind: str, *, device,
             generator: torch.Generator, dtype=torch.bfloat16):
    """normal(0, 1) x 0.02 drawn in fp32, then cast, as the reference; the
    router is kept in fp32 (after the same cast). The scaling is in place:
    one fp32 copy of a stack of experts at a time (21.5 GB at
    llama4-maverick's (128, 5120, 8192))."""
    E, ff = cfg.num_experts, cfg.expert_ff

    def w(shape):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(INIT_STD).to(dtype)

    p = {
        "router": w((d, E)).float(),
        "experts_up": w((E, d, ff)),
        "experts_down": w((E, ff, d)),
    }
    if mlp_kind == "swiglu":
        p["experts_gate"] = w((E, d, ff))
    if cfg.shared_expert_ff:
        p["shared"] = init_mlp(d, cfg.shared_expert_ff, mlp_kind,
                               device=device, generator=generator,
                               dtype=dtype)
    return p


def _w(wp, dtype):
    """Materialize a (possibly quantized) expert weight for the einsums,
    in a `moe.dequant` span; the caller drops it after its one einsum."""
    with span("moe.dequant"):
        if isinstance(wp, dict):
            q, s = wp["q"], wp["scale"]
            if s is None:
                return q.to(dtype)
            return dequantize(q, s).to(dtype)
        return wp


def gemm_takes(dtype, device_type: str, sharded: bool) -> bool:
    """The rule that sends an expert stack to the grouped GEMM: int8
    codes (a `{"q", "scale"}` dict with a scale) on a CUDA device, not a
    DTensor. Anything else takes `_w` and an einsum."""
    return dtype == torch.int8 and device_type == "cuda" and not sharded


def uses_gemm(wp, x) -> bool:
    """`gemm_takes` of expert weights `wp` and their input `x`."""
    if not isinstance(wp, dict) or wp["scale"] is None:
        return False
    q = wp["q"]
    return gemm_takes(q.dtype, q.device.type, is_dtensor(q) or is_dtensor(x))


def _experts(x, wp, eq: str):
    """One batched expert product `eq` of x (E, G, C, K) and the experts'
    (E, K, N) weights: the grouped GEMM (`uses_gemm`, in a `moe.gemm`
    span) or the einsum on `_w`'s weight."""
    if not uses_gemm(wp, x):
        return torch.einsum(eq, x, _w(wp, x.dtype))
    E, G, C, K = x.shape
    with span("moe.gemm"):
        out = moe_gemm(x.reshape(E, G * C, K).contiguous(), wp["q"],
                       wp["scale"])
    return out.reshape(E, G, C, -1)


def _activate(h_up, h_gate, kind: str):
    if kind == "swiglu":
        return F.silu(h_gate) * h_up
    if kind == "relu2":
        return torch.relu(h_up).square()
    return F.gelu(h_up, approximate="tanh")


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xg, router, E: int, K: int, cap: int):
    """Routing of token groups xg (G, Sg, d): the router's probabilities
    (G, Sg, E), the one-hot of each token's first expert (G, Sg, E, fp32),
    and the dispatch and combine tensors (G, Sg, E, cap), fp32."""
    G, Sg, _ = xg.shape
    logits = torch.einsum("gsd,de->gse", xg.float(), router)
    probs = torch.softmax(logits, dim=-1)                       # (G,Sg,E)
    gate_vals, gate_idx = top_k(probs, K)                       # (G,Sg,K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    first = F.one_hot(gate_idx[..., 0], E).float()

    # position of each (token, k) assignment within its expert's queue
    onehot = F.one_hot(gate_idx, E)                             # (G,Sg,K,E)
    pos = torch.cumsum(onehot.reshape(G, Sg * K, E), dim=1) - 1
    pos = torch.gather(pos.reshape(G, Sg, K, E), 3,
                       gate_idx[..., None]).squeeze(-1)         # (G,Sg,K)
    keep = (pos < cap).float()
    cell = ((torch.arange(G * Sg, device=xg.device).reshape(G, Sg, 1) * E
             + gate_idx) * cap + pos.clamp(0, cap - 1)).reshape(-1)
    dispatch_t = torch.zeros(G * Sg * E * cap, device=xg.device)
    dispatch_t.scatter_add_(0, cell, keep.reshape(-1))
    combine_t = torch.zeros(G * Sg * E * cap, device=xg.device)
    combine_t.scatter_add_(0, cell, (keep * gate_vals).reshape(-1))
    return (probs, first, dispatch_t.reshape(G, Sg, E, cap),
            combine_t.reshape(G, Sg, E, cap))


def _route_sharded(xg, router, E: int, K: int, cap: int):
    """`_route` on a DTensor xg, group by group (`local_region`): every
    group's routing is its own, so each rank routes the groups it holds
    (xg split by groups only, the router replicated: the redistributions
    to get there are the only collectives), and each result is split the
    same way. DTensor has no sharding rule for the routing's
    scatter-adds."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = xg.device_mesh
    by_group = tuple(p if isinstance(p, Shard) and p.dim == 0
                     else Replicate() for p in xg.placements)
    G = xg.shape[0]
    return local_region(lambda xl, rl: _route(xl, rl, E, K, cap), mesh,
                        (xg, router), (by_group, (Replicate(),) * mesh.ndim),
                        lambda t: (by_group, (G,) + tuple(t.shape[1:])))


def apply_moe(p, x: torch.Tensor, cfg: MoEConfig, mlp_kind: str,
              qcfg=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).

    Group tokens -> route top-k -> token-major queue positions for
    capacity -> dispatch einsum -> expert MLPs (batched over E) ->
    combine einsum weighted by the renormalised gate probabilities."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    Sg = min(cfg.group_size, T)
    G = T // Sg
    if G * Sg != T:
        raise ValueError(f"group_size {Sg} must divide tokens {T}")
    cap = max(K, int(math.ceil(Sg * K / E * cfg.capacity_factor)))

    xg = x.reshape(G, Sg, d)
    route = _route_sharded if is_dtensor(xg) else _route
    with span("moe.route"):
        probs, first, dispatch_t, combine_t = route(xg, p["router"], E, K,
                                                    cap)

    # Load-balancing aux loss (Switch-style): E * mean(frac_tokens * mean_prob)
    frac = first.mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))

    with span("moe.experts"):
        cdt = x.dtype
        expert_in = torch.einsum("gsec,gsd->egcd", dispatch_t.to(cdt), xg)
        expert_in = constrain(expert_in, "experts", "batch", None, None)
        up = _experts(expert_in, p["experts_up"], "egcd,edf->egcf")
        gatep = p.get("experts_gate")
        gate_h = (_experts(expert_in, gatep, "egcd,edf->egcf")
                  if gatep is not None else None)
        h = _activate(up, gate_h, mlp_kind)
        out_e = _experts(h, p["experts_down"], "egcf,efd->egcd")
        out_e = constrain(out_e, "experts", "batch", None, None)

        if is_dtensor(out_e):
            # (expert, slot) flattened with the expert outer: DTensor's product
            # takes the experts' split on the contracted dim as it is (partial
            # sums, then a reduction), where einsum's own flattening makes a
            # strided split that it refuses. Not the plain path's form: on a
            # plain tensor it sums in another order, and so is not bit for bit
            E_, G_, C_ = out_e.shape[:3]
            out = torch.einsum(
                "gsk,gkd->gsd", combine_t.to(cdt).flatten(2, 3),
                out_e.permute(1, 0, 2, 3).reshape(G_, E_ * C_, d))
        else:
            out = torch.einsum("gsec,egcd->gsd", combine_t.to(cdt), out_e)
    out = out.reshape(B, S, d)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, mlp_kind, qcfg)
    return out, aux
