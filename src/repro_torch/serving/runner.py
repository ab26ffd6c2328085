"""Model execution against the paged KV pool (real-execution tier).

Counterpart of `repro.serving.runner` for decoders of attention, Mamba,
mLSTM and sLSTM blocks, dense or MoE (`models.moe`), and the VLM's text
stack (qwen2-vl-7b: M-RoPE over three equal position rows, as the
reference's runner rotates it), in any precision of `quant.BY_NAME`. An
encoder-decoder is refused, as the reference refuses it: its path is
`models.prefill` and `models.decode_step`.
Fixed-shape, mask-driven step functions over `max_batch` slots:
  prefill_fn — process padded prompts for newly admitted slots, scatter K/V
               into their pages, set their Mamba states, emit the first
               greedy token (TTFT event).
  decode_fn  — one token for every active slot through the paged-attention
               op and the Mamba decode step.

Attention runs in this package's kernels: prefill through the flash op
with a top-left causal mask and the reference's padding mask
(`causal_attention(kv_len=lens)`: keys at or past a slot's prompt length
are masked), decode through the paged op. Rows at or past the prompt
length write their K/V to the trash page and their logits are never
read, but their activations still flow on: into the MoE capacity queues,
and into the state of a Mamba layer that follows, so they must be the
reference's too.

A Mamba layer keeps per-slot O(1) state (`conv`, `h`) instead of pages,
and runs its recurrence in the selective-scan kernel. As in the
reference, its prefill runs over all `Lp` padded positions with no length
mask, so the state a slot carries into decode has also seen the pad
tokens after its prompt; only slots that prefill (or, at decode, that are
active) take the new state (`_mask_state`). mLSTM and sLSTM blocks
(`models.xlstm`) keep their fp32 states the same way: prefill runs them
from a fresh state over all `Lp` positions, decode one step from the
pooled state. A slot that has never prefilled keeps mLSTM's `m` at -inf.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import attention as attn_lib
from repro_torch.models import model as model_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import apply_norm
from repro_torch.quant import linear


def set_matmul_precision():
    """Keep every matmul's accumulation in fp32, as the reference's
    `preferred_element_type=float32`: no bf16 split-K reduction, no TF32."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_pools(cfg: ModelConfig, num_pages: int, page_size: int,
               max_batch: int, *, device) -> List[Dict[str, torch.Tensor]]:
    """The device state, one dict per layer: for an attention layer a bf16
    `(num_pages, page_size, Hkv, D)` K and V pool; per-slot states for the
    others: Mamba `conv` `(max_batch, d_conv - 1, di)` bf16 and `h`
    `(max_batch, di, N)` fp32; mLSTM `C` `(max_batch, H, dh, dh)`, `n`
    `(max_batch, H, dh)` and `m` `(max_batch, H)` (-inf); sLSTM `c`, `n`
    (ones), `m` and `h`, each `(max_batch, d)`; all fp32."""
    model_lib.check_served(cfg)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    pools = []
    for kind in cfg.block_pattern():
        if kind == "attn":
            pools.append({
                "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)})
        elif kind == "mamba":
            pools.append(ssm_lib.init_mamba_state(max_batch, cfg.d_model,
                                                  cfg.ssm, device=device))
        elif kind == "mlstm":
            pools.append(xlstm_lib.init_mlstm_state(
                max_batch, cfg.d_model, cfg.num_heads, cfg.xlstm,
                device=device))
        else:
            pools.append(xlstm_lib.init_slstm_state(max_batch, cfg.d_model,
                                                    device=device))
    return pools


def _scatter_kv(pool_k, pool_v, k, v, block_tables, positions, active,
                page_size: int):
    """Scatter per-token K/V into pages, in place.

    k/v: (B, T, Hkv, D); positions: (B, T) absolute token positions;
    active: (B, T) bool — inactive writes land on trash page 0. The
    reference returns new pool arrays; the port writes into its pools.
    """
    positions = positions.long()
    page_idx = positions // page_size                         # (B, T)
    offs = positions % page_size
    cols = page_idx.clamp(0, block_tables.shape[1] - 1)
    pages = torch.gather(block_tables.long(), 1, cols)        # (B, T)
    pages = torch.where(active, pages, 0)
    pf, of = pages.reshape(-1), offs.reshape(-1)
    pool_k[pf, of] = k.reshape((-1,) + k.shape[2:]).to(pool_k.dtype)
    pool_v[pf, of] = v.reshape((-1,) + v.shape[2:]).to(pool_v.dtype)


def _mask_state(pool, new, active):
    """Per-slot state update, in place: slots where `active` (B,) is set
    take `new`, the others keep `pool`'s state."""
    for name, n in new.items():
        a = active.reshape((-1,) + (1,) * (n.ndim - 1))
        pool[name].copy_(torch.where(a, n.to(pool[name].dtype), pool[name]))


def make_step_fns(cfg: ModelConfig, page_size: int, qcfg=None):
    """Build (prefill_fn, decode_fn) for this config."""
    model_lib.check_served(cfg)
    if cfg.family == "encdec":
        raise NotImplementedError(
            "encoder-decoder serving uses the contiguous-cache path "
            "(models.prefill, models.decode_step) only")
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    layers = list(zip(cfg.block_pattern(), cfg.moe_layer_mask()))

    def _recurrent(kind, p, h, state):
        """A Mamba, mLSTM or sLSTM block over h: (y, new state), from
        `state` (decode, one step) or from a fresh state (None: prefill)."""
        if kind == "mamba":
            if state is None:
                return ssm_lib.apply_mamba(p["mamba"], h, cfg.ssm, qcfg)
            return ssm_lib.mamba_decode_step(p["mamba"], h, state, cfg.ssm,
                                             qcfg)
        if kind == "mlstm":
            return xlstm_lib.mlstm_seq(p, h, nq, cfg.xlstm, state, qcfg)
        return xlstm_lib.slstm_seq(p, h, cfg.xlstm, state, qcfg)

    @torch.no_grad()
    def decode_fn(params, pools, block_tables, seq_lens, tokens, active):
        """tokens: (B,) int32. Writes the new K/V and recurrent states into
        `pools`. Returns (next_tokens, seq_lens + active)."""
        B = tokens.shape[0]
        x = model_lib.embed_tokens(params, cfg, tokens[:, None])
        positions = model_lib._positions(cfg, B, 1, offset=seq_lens,
                                         device=x.device)
        lens_after = seq_lens + active.to(torch.int32)
        for p, pool, (kind, is_moe) in zip(params["layers"], pools, layers):
            h = apply_norm(p["ln1"], x, cfg.norm_kind)
            if kind == "attn":
                q, k, v = attn_lib.qkv(p["attn"], h, nq, nkv, hd, qcfg)
                q = attn_lib.rotate(cfg.rope_kind, q, positions,
                                    cfg.rope_theta)
                k = attn_lib.rotate(cfg.rope_kind, k, positions,
                                    cfg.rope_theta)
                _scatter_kv(pool["k"], pool["v"], k, v, block_tables,
                            seq_lens[:, None], active[:, None], page_size)
                o = paged_attention(q[:, 0], pool["k"], pool["v"],
                                    block_tables, lens_after)
                x = x + linear(o.reshape(B, 1, nq * hd), p["attn"]["wo"],
                               qcfg)
            else:
                y, st = _recurrent(kind, p, h, pool)
                x = x + y
                _mask_state(pool, st, active)
            x = model_lib._apply_ff(p, cfg, x, is_moe, qcfg)
        x = apply_norm(params["final_norm"], x, cfg.norm_kind)
        logits = model_lib.unembed(params, cfg, x, qcfg)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        return nxt, lens_after

    @torch.no_grad()
    def prefill_fn(params, pools, block_tables, seq_lens, tokens, lens,
                   do_prefill):
        """tokens: (B, Lpad) int32; lens: (B,); do_prefill: (B,) bool.

        Processes prompts for flagged slots, writing their K/V and recurrent
        states into `pools`; returns (first_tokens, seq_lens) with
        seq_lens set to lens for those slots."""
        B, Lp = tokens.shape
        x = model_lib.embed_tokens(params, cfg, tokens)
        # M-RoPE rotates by (3, B, Lp) positions; the pages take (B, Lp)
        positions = model_lib._positions(cfg, B, Lp, device=x.device)
        posmat = torch.arange(Lp, device=x.device)[None].expand(B, Lp)
        tok_active = (torch.arange(Lp, device=x.device)[None]
                      < lens[:, None]) & do_prefill[:, None]
        for p, pool, (kind, is_moe) in zip(params["layers"], pools, layers):
            h = apply_norm(p["ln1"], x, cfg.norm_kind)
            if kind == "attn":
                q, k, v = attn_lib.qkv(p["attn"], h, nq, nkv, hd, qcfg)
                q = attn_lib.rotate(cfg.rope_kind, q, positions,
                                    cfg.rope_theta)
                k = attn_lib.rotate(cfg.rope_kind, k, positions,
                                    cfg.rope_theta)
                o = flash_attention(q, k, v, causal=True,
                                    kv_len=lens.to(torch.int32))
                x = x + linear(o.reshape(B, Lp, nq * hd), p["attn"]["wo"],
                               qcfg)
                _scatter_kv(pool["k"], pool["v"], k, v, block_tables,
                            posmat, tok_active, page_size)
            else:
                # over all Lp positions, pads included, as the reference
                y, st = _recurrent(kind, p, h, None)
                x = x + y
                _mask_state(pool, st, do_prefill)
            x = model_lib._apply_ff(p, cfg, x, is_moe, qcfg)
        x = apply_norm(params["final_norm"], x, cfg.norm_kind)
        # logits at each request's last prompt position
        idx = (lens.long() - 1).clamp(0, Lp - 1)
        x_last = x[torch.arange(B, device=x.device), idx][:, None]
        logits = model_lib.unembed(params, cfg, x_last, qcfg)
        first = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        new_seq = torch.where(do_prefill, lens.to(torch.int32), seq_lens)
        return first, new_seq

    return prefill_fn, decode_fn
