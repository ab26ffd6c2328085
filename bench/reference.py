"""The plain reference of the served decoders: plain PyTorch, no kernel.

It imports nothing of the program and takes nothing the program made: the
bf16 weights are made again from the run's seed (`bench.weights`, layer
by layer, so that the model never has to fit at once) and quantized here,
with this file's own copy of the plain arithmetic of the port's int8
scheme (`repro_torch/quant/__init__.py` at commit 81c71db): per output
channel int8 weights (scale = amax over d_in / 127), and for every 2-D
`linear` a dynamic per-tensor activation scale (amax * fl32(1/127)) and
an exact integer product, scaled in fp32 as `acc * (x_scale * w_scale)`;
stacked experts dequantized to bf16 (`q.bf16 * scale.bf16`).

It computes what the configuration states, in its stated storage: bf16
activations, K/V and logits, with every product accumulated in fp32
(TF32 off), softmax and norms in fp32. Attention is the plain masked
softmax (prefill: causal and `kv_len`; decode: the block table's pages,
positions at or past the slot's length masked to -1e30).

Two drivers:

- `replay(calls, ...)`: where rows of one call are coupled (a MoE's
  capacity queues over 256-token groups of the whole (B, Lp) call, pads
  and idle slots included; int8's per-tensor activation scale over the
  whole call), the reference follows the engine's calls one by one, on
  the inputs the engine handed the executor, and keeps its own paged K/V
  pools. It works layer by layer: all calls through layer 0, then layer 1.
- `forward(seqs, ...)`: where rows are not coupled (a dense model in
  bf16), one causal forward over each request's prompt and served tokens.

Both return the logits of the positions that predicted served tokens.
`mode` is the weights' precision: "bf16", "int8", or "int4" (the control
of an int8 configuration: int4 weights, int8 activations).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench import weights as W
from bench.clock import contexts

NEG_INF = -1e30
INV_127 = float(torch.tensor(1.0) / 127)
QMAX = {"int8": 127.0, "int4": 7.0}
# integer products are exact in fp32 while |partial sum| < 2**24:
# 127 * 127 * 1024 < 2**24
K_CHUNK = 1024


def setup_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def coupled(cfg, quant: str) -> bool:
    """Whether a call's rows depend on each other: MoE capacity queues,
    or int8's per-tensor activation scale."""
    return cfg.moe is not None or quant != "bf16"


# --- weights ---------------------------------------------------------------

def quantize(w: torch.Tensor, qmax: float):
    """(codes as fp32 integers, per-output-channel fp32 scale) of `w`
    (..., d_in, d_out)."""
    amax = w.float().abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / torch.tensor(qmax,
                                                       device=amax.device)
    q = torch.clamp(torch.round(w.float() / scale), -qmax, qmax)
    return q, scale


class Lin:
    """A 2-D weight as `linear` applies it."""

    def __init__(self, w: torch.Tensor, mode: str):
        self.mode = mode
        if mode == "bf16":
            self.w = w.float()
        else:
            self.q, self.scale = quantize(w, QMAX[mode])

    def __call__(self, x: torch.Tensor, segs: Sequence[Tuple[int, int]]
                 ) -> torch.Tensor:
        """x: (R, K) bf16 -> (R, N) bf16; `segs`: the row ranges that
        share one activation scale (one per call)."""
        if self.mode == "bf16":
            return (x.float() @ self.w).to(torch.bfloat16)
        xf = x.float()
        xs = torch.empty((x.shape[0], 1), device=x.device)
        for a, b in segs:
            xs[a:b] = torch.clamp(xf[a:b].abs().amax(), min=1e-8) * INV_127
        xq = torch.clamp(torch.round(xf / xs), -127, 127)
        K = xq.shape[1]
        acc = torch.zeros((x.shape[0], self.q.shape[1]), device=x.device,
                          dtype=torch.float64)
        for k in range(0, K, K_CHUNK):
            acc += (xq[:, k:k + K_CHUNK] @ self.q[k:k + K_CHUNK]).double()
        return (acc.float() * (xs * self.scale)).to(torch.bfloat16)


def experts(w: torch.Tensor, mode: str) -> torch.Tensor:
    """A stack of expert matrices as the einsums read them: bf16."""
    if mode == "bf16":
        return w
    q, scale = quantize(w, QMAX[mode])
    return q.to(torch.bfloat16) * scale.to(torch.bfloat16)


def layer_weights(cfg, seed: int, i: int, device, mode: str) -> dict:
    p = W.layer(cfg, seed, i, device)
    out = {"ln1": p["ln1"], "ln2": p["ln2"],
           "attn": {k: Lin(v, mode) for k, v in p["attn"].items()}}
    if "moe" in p:
        out["moe"] = {k: (v if k == "router" else experts(v, mode))
                      for k, v in p["moe"].items()}
    else:
        out["mlp"] = {k: Lin(v, mode) for k, v in p["mlp"].items()}
    return out


# --- layers ----------------------------------------------------------------

def norm(p, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding in fp32; x (R, H, D), pos (R,)."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exps)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def attend(q, k, v, valid) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), valid (B, Sq, Sk) bool ->
    (B, Sq, Hq, D) bf16; a row with no valid key takes the mean of V."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(torch.bfloat16)


def moe(p, h: torch.Tensor, cfg, segs) -> torch.Tensor:
    """Capacity-grouped top-k MoE over the rows of each call in `segs`:
    tokens in groups of `group_size` (fewer in a call of fewer rows),
    each expert taking at most `cap` of a group's assignments in
    token-major order; gates renormalised over the top-k and rounded to
    bf16; ties in the router to the lower expert."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    rows, exps, gates = [], [], []
    for a, b in segs:
        T = b - a
        Sg = min(m.group_size, T)
        G = T // Sg
        cap = max(K, int(math.ceil(Sg * K / E * m.capacity_factor)))
        probs = torch.softmax(h[a:b].float() @ p["router"], dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :K], idx[:, :K]
        vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
        onehot = F.one_hot(idx.reshape(G, Sg * K), E)
        pos = (torch.cumsum(onehot, dim=1) - 1).gather(
            2, idx.reshape(G, Sg * K, 1)).reshape(T, K)
        keep = pos < cap
        r = torch.arange(a, b, device=h.device)[:, None].expand(T, K)
        rows.append(r[keep])
        exps.append(idx[keep])
        gates.append(vals[keep])
    rows, exps = torch.cat(rows), torch.cat(exps)
    gates = torch.cat(gates).to(torch.bfloat16).float()
    acc = torch.zeros((h.shape[0], h.shape[1]), device=h.device)
    for e in range(E):
        sel = exps == e
        if not bool(sel.any()):
            continue
        r = rows[sel]
        x = h[r].float()
        up = (x @ p["experts_up"][e].float()).to(torch.bfloat16)
        if "experts_gate" in p:
            g = (x @ p["experts_gate"][e].float()).to(torch.bfloat16)
            act = F.silu(g) * up
        else:
            act = torch.relu(up).square()
        out = (act.float() @ p["experts_down"][e].float()).to(torch.bfloat16)
        acc.index_add_(0, r, gates[sel][:, None] * out.float())
    return acc.to(torch.bfloat16)


def mlp(p, h, kind: str, segs) -> torch.Tensor:
    if kind == "swiglu":
        act = F.silu(p["gate"](h, segs)) * p["up"](h, segs)
    elif kind == "relu2":
        act = torch.relu(p["up"](h, segs)).square()
    else:
        act = F.gelu(p["up"](h, segs), approximate="tanh")
    return p["down"](act, segs)


def _eps(cfile: dict) -> float:
    return float(cfile.get("rms_norm_eps", cfile.get("norm_eps", 1e-6)))


def _block_ff(lw, x, cfg, eps, segs):
    h = norm(lw["ln2"], x, cfg.norm_kind, eps)
    if "moe" in lw:
        return x + moe(lw["moe"], h, cfg, segs)
    return x + mlp(lw["mlp"], h, cfg.mlp_kind, segs)


def _lm_head(cfg, seed, device, mode) -> Lin:
    return Lin(W.lm_head(cfg, seed, device), mode)


# --- drivers ---------------------------------------------------------------

def replay(cfg, cfile: dict, seed: int, calls, engine_cfg: dict, device,
           mode: str, want: Sequence[Tuple[int, int]]
           ) -> Dict[Tuple[int, int], torch.Tensor]:
    """The fp32 logits (V,) at each wanted (index into `calls`' steps,
    slot), from a replay of every step in `calls` (a `WallClock` log)."""
    setup_precision()
    B = engine_cfg["max_batch"]
    page = engine_cfg["page_size"]
    steps = contexts(calls, B)
    eps = _eps(cfile)
    hd, nq, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    toks, pos, segs = [], [], []
    at = 0
    for c in steps:
        if c.kind == "prefill":
            Lp = c.tokens.shape[1]
            toks.append(c.tokens.reshape(-1))
            pos.append(np.tile(np.arange(Lp), B))
        else:
            toks.append(c.tokens.reshape(-1))
            pos.append(c.context)
        segs.append((at, at + len(toks[-1])))
        at += len(toks[-1])
    tok = torch.from_numpy(np.concatenate(toks).astype(np.int64)).to(device)
    posd = torch.from_numpy(np.concatenate(pos).astype(np.int64)).to(device)
    x = W.embed(cfg, seed, device)[tok]
    for i in range(cfg.num_layers):
        lw = layer_weights(cfg, seed, i, device, mode)
        h = norm(lw["ln1"], x, cfg.norm_kind, eps)
        a = lw["attn"]
        q = rope(a["wq"](h, segs).view(-1, nq, hd), posd, cfg.rope_theta)
        k = rope(a["wk"](h, segs).view(-1, nkv, hd), posd, cfg.rope_theta)
        v = a["wv"](h, segs).view(-1, nkv, hd)
        o = torch.empty_like(q)
        shape = (engine_cfg["num_pages"], page, nkv, hd)
        pk = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        pv = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        for c, (r0, r1) in zip(steps, segs):
            bt = torch.from_numpy(c.block_tables.astype(np.int64)).to(device)
            if c.kind == "prefill":
                Lp = c.tokens.shape[1]
                lens = torch.from_numpy(c.lens.astype(np.int64)).to(device)
                mask = torch.from_numpy(c.mask).to(device)
                qc = q[r0:r1].view(B, Lp, nq, hd)
                kc = k[r0:r1].view(B, Lp, nkv, hd)
                vc = v[r0:r1].view(B, Lp, nkv, hd)
                ar = torch.arange(Lp, device=device)
                valid = ((ar[None, :, None] >= ar[None, None, :])
                         & (ar[None, None, :] < lens[:, None, None]))
                o[r0:r1] = attend(qc, kc, vc, valid).view(-1, nq, hd)
                tpos = ar[None].expand(B, Lp)
                act = (tpos < lens[:, None]) & mask[:, None]
                _scatter(pk, pv, kc, vc, bt, tpos, act, page)
            else:
                ctx = torch.from_numpy(c.context.astype(np.int64)).to(device)
                act = torch.from_numpy(c.mask).to(device)
                kc, vc = k[r0:r1].view(B, 1, nkv, hd), v[r0:r1].view(
                    B, 1, nkv, hd)
                _scatter(pk, pv, kc, vc, bt, ctx[:, None], act[:, None],
                         page)
                kg = pk[bt].reshape(B, -1, nkv, hd)
                vg = pv[bt].reshape(B, -1, nkv, hd)
                after = ctx + act.long()
                valid = (torch.arange(kg.shape[1], device=device)[None]
                         < after[:, None])[:, None, :]
                o[r0:r1] = attend(q[r0:r1].view(B, 1, nq, hd), kg, vg,
                                  valid).view(-1, nq, hd)
        x = x + a["wo"](o.view(-1, nq * hd), segs)
        del q, k, v, o, pk, pv, h
        x = _block_ff(lw, x, cfg, eps, segs)
        del lw
    fn = W.norm(cfg, device)
    head = _lm_head(cfg, seed, device, mode)
    out = {}
    by_step: Dict[int, List[int]] = {}
    for si, slot in want:
        by_step.setdefault(si, []).append(slot)
    for si, slots in by_step.items():
        c, (r0, r1) = steps[si], segs[si]
        if c.kind == "prefill":
            Lp = c.tokens.shape[1]
            last = np.clip(c.lens.astype(np.int64) - 1, 0, Lp - 1)
            rows = r0 + np.arange(B) * Lp + last
        else:
            rows = r0 + np.arange(B)
        xl = norm(fn, x[torch.from_numpy(rows).to(device)], cfg.norm_kind,
                  eps)
        logits = head(xl, [(0, B)]).float()
        for slot in slots:
            out[(si, slot)] = logits[slot]
    return out


def _scatter(pk, pv, k, v, bt, positions, active, page: int):
    """Write (B, T) tokens' K/V into their pages; inactive ones to page 0."""
    page_idx = positions // page
    cols = page_idx.clamp(0, bt.shape[1] - 1)
    pages = torch.where(active, torch.gather(bt, 1, cols), 0)
    pf, of = pages.reshape(-1), (positions % page).reshape(-1)
    pk[pf, of] = k.reshape((-1,) + k.shape[2:])
    pv[pf, of] = v.reshape((-1,) + v.shape[2:])


def forward(cfg, cfile: dict, seed: int, seqs: Sequence[np.ndarray],
            first: Sequence[int], device, mode: str = "bf16"
            ) -> List[torch.Tensor]:
    """For each token sequence (a prompt and its served tokens but the
    last), the fp32 logits (n - first, V) of its positions from
    `first[i]` on: one causal forward a sequence, no cache. Only for rows
    that are not coupled (`coupled` false)."""
    if coupled(cfg, mode):
        raise ValueError("forward() is for uncoupled rows; use replay()")
    setup_precision()
    eps = _eps(cfile)
    hd, nq, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    lens = [len(s) for s in seqs]
    tok = torch.from_numpy(np.concatenate(seqs).astype(np.int64)).to(device)
    posd = torch.from_numpy(np.concatenate([np.arange(n) for n in lens])
                            ).to(device)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    segs = list(zip(bounds[:-1], bounds[1:]))
    x = W.embed(cfg, seed, device)[tok]
    for i in range(cfg.num_layers):
        lw = layer_weights(cfg, seed, i, device, mode)
        h = norm(lw["ln1"], x, cfg.norm_kind, eps)
        a = lw["attn"]
        q = rope(a["wq"](h, segs).view(-1, nq, hd), posd, cfg.rope_theta)
        k = rope(a["wk"](h, segs).view(-1, nkv, hd), posd, cfg.rope_theta)
        v = a["wv"](h, segs).view(-1, nkv, hd)
        o = torch.empty_like(q)
        for r0, r1 in segs:
            n = r1 - r0
            ar = torch.arange(n, device=device)
            valid = (ar[:, None] >= ar[None, :])[None]
            o[r0:r1] = attend(q[r0:r1][None], k[r0:r1][None],
                              v[r0:r1][None], valid)[0]
        x = x + a["wo"](o.view(-1, nq * hd), segs)
        del q, k, v, o, h
        x = _block_ff(lw, x, cfg, eps, segs)
        del lw
    fn = W.norm(cfg, device)
    head = _lm_head(cfg, seed, device, mode)
    out = []
    for (r0, r1), f in zip(segs, first):
        xl = norm(fn, x[r0 + f:r1], cfg.norm_kind, eps)
        out.append(head(xl, [(0, r1 - r0 - f)]).float())
    return out
