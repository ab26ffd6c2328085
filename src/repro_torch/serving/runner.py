"""Model execution against the paged KV pool (real-execution tier).

Counterpart of `repro.serving.runner` for attention decoders, dense or MoE
(`models.moe`), in any precision of `quant.BY_NAME`. Fixed-shape,
mask-driven step functions over `max_batch` slots:
  prefill_fn — process padded prompts for newly admitted slots, scatter K/V
               into their pages, emit the first greedy token (TTFT event).
  decode_fn  — one token for every active slot through the paged-attention
               op.

Attention runs in this package's kernels: prefill through the flash op
with a top-left causal mask, decode through the paged op. Prefill needs
no padding mask: a row below its slot's prompt length attends only to
columns at or before itself, which are all valid prompt tokens, so it
gets exactly what the reference's `causal_attention(kv_len=lens)` gives
it. Rows at or past the prompt length differ, and are thrown away: their
K/V writes go to the trash page and their logits are never read.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import attention as attn_lib
from repro_torch.models import model as model_lib
from repro_torch.models.layers import apply_norm
from repro_torch.quant import linear


def set_matmul_precision():
    """Keep every matmul's accumulation in fp32, as the reference's
    `preferred_element_type=float32`: no bf16 split-K reduction, no TF32."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_pools(cfg: ModelConfig, num_pages: int, page_size: int, *,
               device) -> List[Dict[str, torch.Tensor]]:
    """One bf16 `(num_pages, page_size, Hkv, D)` K and V pool per layer."""
    model_lib.check_served(cfg)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
             "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
            for _ in range(cfg.num_layers)]


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


def make_step_fns(cfg: ModelConfig, page_size: int, qcfg=None):
    """Build (prefill_fn, decode_fn) for this config."""
    model_lib.check_served(cfg)
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    moe_mask = cfg.moe_layer_mask()

    @torch.no_grad()
    def decode_fn(params, pools, block_tables, seq_lens, tokens, active):
        """tokens: (B,) int32. Writes the new K/V into `pools`. Returns
        (next_tokens, seq_lens + active)."""
        B = tokens.shape[0]
        x = model_lib.embed_tokens(params, cfg, tokens[:, None])
        positions = model_lib._positions(cfg, B, 1, offset=seq_lens,
                                         device=x.device)
        lens_after = seq_lens + active.to(torch.int32)
        for p, pool, is_moe in zip(params["layers"], pools, moe_mask):
            h = apply_norm(p["ln1"], x, cfg.norm_kind)
            q, k, v = attn_lib.qkv(p["attn"], h, nq, nkv, hd, qcfg)
            q = attn_lib.rotate(cfg.rope_kind, q, positions, cfg.rope_theta)
            k = attn_lib.rotate(cfg.rope_kind, k, positions, cfg.rope_theta)
            _scatter_kv(pool["k"], pool["v"], k, v, block_tables,
                        seq_lens[:, None], active[:, None], page_size)
            o = paged_attention(q[:, 0], pool["k"], pool["v"], block_tables,
                                lens_after)
            x = x + linear(o.reshape(B, 1, nq * hd), p["attn"]["wo"], qcfg)
            x = model_lib._apply_ff(p, cfg, x, is_moe, qcfg)
        x = apply_norm(params["final_norm"], x, cfg.norm_kind)
        logits = model_lib.unembed(params, cfg, x, qcfg)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        return nxt, lens_after

    @torch.no_grad()
    def prefill_fn(params, pools, block_tables, seq_lens, tokens, lens,
                   do_prefill):
        """tokens: (B, Lpad) int32; lens: (B,); do_prefill: (B,) bool.

        Processes prompts for flagged slots, writing their K/V into
        `pools`; returns (first_tokens, seq_lens) with seq_lens set to lens
        for those slots."""
        B, Lp = tokens.shape
        x = model_lib.embed_tokens(params, cfg, tokens)
        positions = model_lib._positions(cfg, B, Lp, device=x.device)
        tok_active = (torch.arange(Lp, device=x.device)[None]
                      < lens[:, None]) & do_prefill[:, None]
        for p, pool, is_moe in zip(params["layers"], pools, moe_mask):
            h = apply_norm(p["ln1"], x, cfg.norm_kind)
            q, k, v = attn_lib.qkv(p["attn"], h, nq, nkv, hd, qcfg)
            q = attn_lib.rotate(cfg.rope_kind, q, positions, cfg.rope_theta)
            k = attn_lib.rotate(cfg.rope_kind, k, positions, cfg.rope_theta)
            o = flash_attention(q, k, v, causal=True)
            x = x + linear(o.reshape(B, Lp, nq * hd), p["attn"]["wo"], qcfg)
            _scatter_kv(pool["k"], pool["v"], k, v, block_tables, positions,
                        tok_active, page_size)
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
