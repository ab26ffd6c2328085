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
reference leaves them to XLA; quantized expert weights are dequantized to
bf16 first (`_w`), so they never go through the int8 kernel, exactly as in
the reference.

Ties in the router's top-k go to the lower expert index, as
`jax.lax.top_k` breaks them (`torch.topk` does not promise that).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import INIT_STD, apply_mlp, init_mlp
from repro_torch.parallel.sharding import constrain
from repro_torch.quant import dequantize


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
    """Materialize a (possibly quantized) expert weight for the einsums."""
    if isinstance(wp, dict):
        q, s = wp["q"], wp["scale"]
        if s is None:
            return q.to(dtype)
        return dequantize(q, s).to(dtype)
    return wp


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
    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)                       # (G,Sg,E)
    gate_vals, gate_idx = top_k(probs, K)                       # (G,Sg,K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # Load-balancing aux loss (Switch-style): E * mean(frac_tokens * mean_prob)
    frac = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))

    # position of each (token, k) assignment within its expert's queue
    onehot = F.one_hot(gate_idx, E)                             # (G,Sg,K,E)
    pos = torch.cumsum(onehot.reshape(G, Sg * K, E), dim=1) - 1
    pos = torch.gather(pos.reshape(G, Sg, K, E), 3,
                       gate_idx[..., None]).squeeze(-1)         # (G,Sg,K)
    keep = (pos < cap).float()
    cell = ((torch.arange(G * Sg, device=x.device).reshape(G, Sg, 1) * E
             + gate_idx) * cap + pos.clamp(0, cap - 1)).reshape(-1)
    dispatch_t = torch.zeros(G * Sg * E * cap, device=x.device)
    dispatch_t.scatter_add_(0, cell, keep.reshape(-1))
    combine_t = torch.zeros(G * Sg * E * cap, device=x.device)
    combine_t.scatter_add_(0, cell, (keep * gate_vals).reshape(-1))
    dispatch_t = dispatch_t.reshape(G, Sg, E, cap)
    combine_t = combine_t.reshape(G, Sg, E, cap)

    cdt = x.dtype
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch_t.to(cdt), xg)
    expert_in = constrain(expert_in, "experts", "batch", None, None)
    up = torch.einsum("egcd,edf->egcf", expert_in, _w(p["experts_up"], cdt))
    gatep = p.get("experts_gate")
    gate_h = (torch.einsum("egcd,edf->egcf", expert_in, _w(gatep, cdt))
              if gatep is not None else None)
    h = _activate(up, gate_h, mlp_kind)
    out_e = torch.einsum("egcf,efd->egcd", h, _w(p["experts_down"], cdt))
    out_e = constrain(out_e, "experts", "batch", None, None)

    out = torch.einsum("gsec,egcd->gsd", combine_t.to(cdt), out_e)
    out = out.reshape(B, S, d)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, mlp_kind, qcfg)
    return out, aux
