"""Model assembly: decoders of attention, Mamba, mLSTM and sLSTM blocks,
dense or MoE, the encoder-decoder (whisper-base) and the VLM's text
stack (qwen2-vl-7b): parameters, embedding, the full-sequence forward and
loss, and prefill and decode on a contiguous cache.

Counterpart of `repro.models.model`. The
reference stacks each layer's parameters over the R repeats of its
superblock and scans them; PyTorch runs eagerly, so the port keeps one
parameter dictionary per layer in `params["layers"]` (and per encoder
layer in `params["encoder"]`) and loops over them in order. A cache
follows the layers: `{"len": (B,), "layers": [per layer]}`, each leaf of
the reference's per-repeat shape and dtype.

  init_params(cfg, device=..., generator=..., quant=...) -> params
  forward(params, cfg, batch, ...)            -> (logits, aux)
  train_loss(params, cfg, batch, ...)         -> (loss, {"ce", "aux"})
  encode(params, cfg, frames, ...)            -> encoder output
  prefill(params, cfg, batch, ...)            -> (last logits, cache)
  decode_step(params, cfg, token, cache, ...) -> (logits, cache)
  cache_spec / init_cache / abstract_cache    -> the cache's (shape, dtype)
                                                 tree, zeros, meta tensors
  embed_tokens / unembed / _apply_ff          -> also used by serving.runner

Where the attention runs: `prefill` and `encode` through the flash op
(`kernels.flash_attention`: the kernel on a CUDA tensor, its plain version
on the CPU), causal for self-attention and without a mask for the
encoder's and the cross-attention, as the served prefill runs it where
the reference computes it in `jnp`; `forward` and `train_loss` through the
plain functions of `models.attention`, the reference's own roundings,
since they need autograd and the kernel has none; `decode_step` through
`attention.decode_attention` on the contiguous cache, as the reference
(`_flash_decode_attention` with `PERF.flash_decode`).

The mesh half follows the reference's `shard_map` contract literally:
replicated in, replicated out, the work split inside. Under
`parallel.shardctx(mesh)` with a `DeviceMesh`, every rank calls the same
function on the whole of its inputs; `_flash_decode_attention` takes its
batch shard and its sequence shard of the cache and combines the partial
softmaxes over the "model" axis' group, and `_local_batch_shard_map`
(`PERF.local_recurrence`) runs a recurrent block on its batch shard.
Both are `parallel.sharding.local_region`s, which gather the outputs
whole for plain inputs and keep them split for DTensors (the dry-run).
Each falls back to the plain function exactly where the reference does.
`constrain` and `constrain_cache` sit at the reference's places; they
change only a DTensor's placements (`parallel.sharding.constrain`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (
    apply_mlp, apply_norm, cross_entropy_loss, dense_init, embed_init,
    init_mlp, init_norm, linear, softcap)
from repro_torch.parallel.collectives import combine_partial_softmax
from repro_torch.parallel.sharding import (
    by_axes, constrain, current_mesh, is_dtensor, local_region, logical_spec,
    mesh_axes, split_last)
from repro_torch.quant import quantize_tree
from repro_torch.tracing import span

MAX_POS = 32768          # learned-position table size (whisper)
VLM_PATCHES = 256        # stubbed patch count for vlm input cells
AUX_LOSS_COEF = 0.01


@dataclasses.dataclass
class PerfConfig:
    """The reference's performance levers: `kv_cache_dtype`, the
    contiguous cache's K/V dtype (bf16, or `torch.float8_e4m3fn`);
    `local_recurrence`, recurrent blocks on the rank's batch shard
    (`_local_batch_shard_map`); `flash_decode`, decode attention as
    partial softmaxes over the cache's sequence shards
    (`_flash_decode_attention`). The last two act only under a mesh."""
    kv_cache_dtype: Any = torch.bfloat16
    local_recurrence: bool = False
    flash_decode: bool = False


PERF = PerfConfig()


def unit_size(cfg: ModelConfig) -> int:
    u = 1
    if cfg.attn_every > 1:
        u = math.lcm(u, cfg.attn_every)
    if cfg.moe is not None and cfg.moe.interleave > 1:
        u = math.lcm(u, cfg.moe.interleave)
    if cfg.xlstm is not None:
        u = math.lcm(u, cfg.xlstm.slstm_every)
    if cfg.num_layers % u:
        u = cfg.num_layers     # degenerate: no repetition -> single scan step
    return u


def unit_pattern(cfg: ModelConfig) -> Tuple[Tuple[str, bool], ...]:
    """(block_kind, is_moe) for each of the first U layers."""
    u = unit_size(cfg)
    kinds = cfg.block_pattern()
    moes = cfg.moe_layer_mask()
    return tuple((kinds[i], moes[i]) for i in range(u))


def check_served(cfg: ModelConfig):
    """Raise for a configuration the port cannot run: one with a block
    kind other than attention, Mamba, mLSTM and sLSTM (the reference has
    no other). Decoders, encoder-decoders and the VLM's text stack all
    run; the serving runner refuses encoder-decoders itself, as the
    reference's does."""
    kinds = {kind for kind, _ in unit_pattern(cfg)}
    if not kinds <= {"attn", "mamba", "mlstm", "slstm"}:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds)}; the port runs "
            "attention, Mamba, mLSTM and sLSTM blocks")


def init_params(cfg: ModelConfig, *, device, generator: torch.Generator,
                dtype=torch.bfloat16, quant: str = "bf16") -> Dict[str, Any]:
    """Random parameters, normal × 0.02 as the reference draws them.

    With `quant` int8 or fp8 each layer is quantized (`quantize_tree`) as
    soon as it is drawn, and so is the lm_head, so a model whose bf16
    weights would not fit the card never holds them all at once. An xLSTM
    block holds `ln1` and its own parameters, with no `ln2` or MLP; with
    tied embeddings there is no lm_head. An encoder-decoder's decoder
    layers add `ln_x` and the cross-attention `xattn`; it has learned
    positions (`pos_embed`, MAX_POS rows), and its encoder (`encoder`, one
    dict a layer: `ln1`, `attn`, `ln2`, `mlp`), `enc_pos_embed`
    (`frontend_len` rows) and `enc_final_norm`.

    The numbers differ from the reference's (another generator); tests
    that compare the two frameworks initialise in JAX and convert with
    `repro_torch.weights.params_from_jax`."""
    check_served(cfg)
    d = cfg.d_model
    kw = dict(device=device, generator=generator, dtype=dtype)
    layers = [quantize_tree(_init_layer(cfg, kind, is_moe, kw), quant)
              for kind, is_moe in zip(cfg.block_pattern(),
                                      cfg.moe_layer_mask())]
    params = {
        "embed": embed_init(cfg.vocab_size, d, **kw),
        "final_norm": init_norm(cfg.norm_kind, d, device=device, dtype=dtype),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = quantize_tree(dense_init(d, cfg.vocab_size, **kw),
                                          quant)
    if cfg.rope_kind == "none" and cfg.family == "encdec":
        params["pos_embed"] = embed_init(MAX_POS, d, **kw)
    if cfg.encoder_layers:
        norm = lambda: init_norm(cfg.norm_kind, d, device=device, dtype=dtype)
        params["encoder"] = [quantize_tree({
            "ln1": norm(),
            "attn": attn.init_attention(d, cfg.num_heads, cfg.num_kv_heads,
                                        cfg.resolved_head_dim, **kw),
            "ln2": norm(),
            "mlp": init_mlp(d, cfg.d_ff, cfg.mlp_kind, **kw)}, quant)
            for _ in range(cfg.encoder_layers)]
        params["enc_pos_embed"] = embed_init(cfg.frontend_len or 1500, d,
                                             **kw)
        params["enc_final_norm"] = norm()
    return params


def _init_layer(cfg: ModelConfig, kind: str, is_moe: bool, kw):
    d = cfg.d_model
    norm = lambda: init_norm(cfg.norm_kind, d, device=kw["device"],
                             dtype=kw["dtype"])
    p = {"ln1": norm()}
    if kind == "mlstm":         # self-contained: the ff is inside the block
        return {**p, **xlstm_lib.init_mlstm(d, cfg.num_heads, cfg.xlstm,
                                            **kw)}
    if kind == "slstm":
        return {**p, **xlstm_lib.init_slstm(d, cfg.xlstm, **kw)}
    if kind == "attn":
        p["attn"] = attn.init_attention(d, cfg.num_heads, cfg.num_kv_heads,
                                        cfg.resolved_head_dim, **kw)
    else:
        p["mamba"] = ssm_lib.init_mamba(d, cfg.ssm, **kw)
    if cfg.family == "encdec":
        p["ln_x"] = norm()
        p["xattn"] = attn.init_cross_attention(
            d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, **kw)
    if is_moe:
        p["ln2"] = norm()
        p["moe"] = moe_lib.init_moe(d, cfg.moe, cfg.mlp_kind, **kw)
    elif cfg.d_ff:
        p["ln2"] = norm()
        p["mlp"] = init_mlp(d, cfg.d_ff, cfg.mlp_kind, **kw)
    return p


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    # F.embedding raises on an id outside the vocabulary, where the
    # reference's jnp.take would fill NaN.
    x = F.embedding(tokens.long(), params["embed"])
    return constrain(x, "batch", "seq", "d_model")


def unembed(params, cfg: ModelConfig, x: torch.Tensor, qcfg=None
            ) -> torch.Tensor:
    """fp32 logits, then the optional softcap. Tied embeddings: x against
    `embed` (cast to x's dtype) with an fp32 result, as the reference's
    `dot_general(preferred_element_type=float32)`; the operands go to fp32
    first, which is exact for bf16 ones, so the product is never rounded
    to bf16."""
    if cfg.tie_embeddings:     # `embed` is never quantized (quant.SKIP)
        w = params["embed"].to(x.dtype)
        logits = torch.matmul(x.float(), w.float().T)
    else:
        logits = linear(x, params["lm_head"], qcfg).float()
    logits = softcap(logits, cfg.logit_softcap)
    return constrain(logits, "batch", "seq", "vocab")


def _positions(cfg: ModelConfig, batch: int, seq: int, offset=None,
               device=None) -> torch.Tensor:
    """(B, S) int32 positions, from `offset` (B,) if given; M-RoPE's (3, B,
    S): three equal rows (t, h, w), as the reference gives text."""
    base = torch.arange(seq, dtype=torch.int32, device=device)[None]
    if offset is not None:
        base = base + offset[:, None].to(torch.int32)
    else:
        base = base.expand(batch, seq)
    if cfg.rope_kind == "mrope":
        return base[None].expand(3, batch, seq)
    return base


def _residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y, the sum held to the residual stream's sharding (the names
    the reference constrains it to after each block). Under a mesh the
    sub-layer's output otherwise keeps whatever layout DTensor chose for
    its last product, such as a sequence split over the model axis that a
    later flatten cannot take."""
    return constrain(x + y, "batch", "seq", "d_model")


def _apply_ff_aux(p, cfg: ModelConfig, x: torch.Tensor, is_moe: bool,
                  qcfg=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The feed-forward half of a block: (x, the MoE aux loss, fp32, 0
    without a MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if is_moe and "moe" in p:
        with span("layer.moe"):
            h = apply_norm(p["ln2"], x, cfg.norm_kind)
            mo, aux = moe_lib.apply_moe(p["moe"], h, cfg.moe, cfg.mlp_kind,
                                        qcfg)
            x = _residual(x, mo)
    elif "mlp" in p:
        with span("layer.ffn"):
            h = apply_norm(p["ln2"], x, cfg.norm_kind)
            x = _residual(x, apply_mlp(p["mlp"], h, cfg.mlp_kind, qcfg))
    return x, aux


def _apply_ff(p, cfg: ModelConfig, x: torch.Tensor, is_moe: bool,
              qcfg=None) -> torch.Tensor:
    """The feed-forward half of a block; the MoE aux loss is dropped, as
    the reference's serving runner drops it."""
    return _apply_ff_aux(p, cfg, x, is_moe, qcfg)[0]


def _layer_kinds(cfg: ModelConfig):
    return list(zip(cfg.block_pattern(), cfg.moe_layer_mask()))


def _flash(q, k, v, causal: bool = True):
    """The flash op. A DTensor q (the dry-run's) takes the same attention
    in the model's own functions (`attention.causal_attention`,
    `bidirectional_attention`: the full rectangle, as the op's plain
    version computes it), whose head split a sharded q can take."""
    if is_dtensor(q):
        return (attn.causal_attention if causal
                else attn.bidirectional_attention)(q, k, v)
    return flash_attention(q, k, v, causal=causal)


def _bidirectional_flash(q, k, v):
    return _flash(q, k, v, causal=False)


# ---------------------------------------------------------------------------
# Block application, full sequence (train / prefill)
# ---------------------------------------------------------------------------

def _apply_attn_block(p, cfg: ModelConfig, x, positions, qcfg,
                      enc_kv=None, make_cache=False, flash=False):
    """Returns (x, cache or None); cache k/v layout (B, Hkv, S, D). With
    `flash` the attention runs in the flash op (causal; the
    cross-attention without a mask), else in the plain functions."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    h = apply_norm(p["ln1"], x, cfg.norm_kind)
    q, k, v = attn.qkv(p["attn"], h, cfg.num_heads, cfg.num_kv_heads, hd, qcfg)
    q = attn.rotate(cfg.rope_kind, q, positions, cfg.rope_theta)
    k = attn.rotate(cfg.rope_kind, k, positions, cfg.rope_theta)
    q = constrain(q, "batch", "seq", "qheads", None)
    k = constrain(k, "batch", "seq", "kvheads", None)
    v = constrain(v, "batch", "seq", "kvheads", None)
    if flash:
        o = _flash(q, k, v)
    elif S > attn.CHUNKED_THRESHOLD:
        o = attn.causal_attention_chunked(q, k, v)
    else:
        o = attn.causal_attention(q, k, v)
    o = constrain(o, "batch", "seq", "qheads", None)
    x = _residual(x, linear(o.reshape(B, S, cfg.num_heads * hd),
                            p["attn"]["wo"], qcfg))
    cache = None
    if make_cache:
        kv_dt = PERF.kv_cache_dtype
        cache = {"k": k.transpose(1, 2).to(kv_dt).contiguous(),
                 "v": v.transpose(1, 2).to(kv_dt).contiguous()}
    if enc_kv is not None:
        h = apply_norm(p["ln_x"], x, cfg.norm_kind)
        x = _residual(x, attn.cross_attention(
            p["xattn"], h, enc_kv["xk"], enc_kv["xv"], cfg.num_heads,
            cfg.num_kv_heads, hd, qcfg,
            attend=_bidirectional_flash if flash else None))
    return x, cache


def _batch_axes(mesh, x) -> Optional[Tuple[str, ...]]:
    """The mesh axes x's batch (dim 0) shards over, or None where the
    rules leave it replicated (batch smaller than or not divisible by the
    data degree)."""
    bspec = logical_spec(x.shape, ("batch",), mesh)
    bax = bspec[0] if len(bspec) else None
    return (bax,) if isinstance(bax, str) else bax


def _batch_region(fn, mesh, bax, p, x, *state):
    """`fn(p, x, *state)` on this rank's batch shard (`local_region`):
    the params replicated, x and the `state` trees (batch-major) split by
    batch over the mesh axes `bax`, and every output whose leading dim is
    the shard's batch split the same way (the rest replicated)."""
    rep = by_axes(mesh, {})
    by_batch = by_axes(mesh, {a: 0 for a in bax})
    b = x.shape[0] // math.prod(mesh_axes(mesh)[a] for a in bax)

    def out(t):
        if t.ndim and t.shape[0] == b:
            return by_batch, (x.shape[0],) + tuple(t.shape[1:])
        return rep, tuple(t.shape)

    return local_region(fn, mesh, (p, x) + state,
                        (rep, by_batch) + (by_batch,) * len(state), out)


def _local_batch_shard_map(fn, p, x):
    """Run a recurrent block on this rank's batch shard with replicated
    params (`_batch_region`): the time-loop recurrence stays local to the
    rank, and the outputs (all batch-major) come back whole, or, for a
    DTensor x, split by batch."""
    mesh = current_mesh()
    if mesh is None:
        return fn(p, x)
    bax = _batch_axes(mesh, x)
    if bax is None:
        # gate: batch smaller than the DP degree cannot be split
        return fn(p, x)
    return _batch_region(fn, mesh, bax, p, x)


def _batch_local(fn, p, x, *state):
    """An xLSTM block (no work across the batch; the rules replicate its
    parameters) on a DTensor x, run on the local batch shards (the whole
    batch where the rules leave it unsplit), as DTensor would run it had
    it a rule for each of its ops (it has none for `log_sigmoid`)."""
    mesh = x.device_mesh
    return _batch_region(fn, mesh, _batch_axes(mesh, x) or (), p, x, *state)


def _apply_block_seq(p, cfg: ModelConfig, kind: str, is_moe: bool, x,
                     positions, qcfg, enc_kv=None, make_cache=False,
                     flash=False):
    """Full-sequence block application. Returns (x, aux, cache)."""
    cache = None
    if kind == "attn":
        x, cache = _apply_attn_block(p, cfg, x, positions, qcfg, enc_kv,
                                     make_cache, flash)
    else:
        h = apply_norm(p["ln1"], x, cfg.norm_kind)
        if kind == "mamba":
            fn = lambda p_, h_: ssm_lib.apply_mamba(p_["mamba"], h_, cfg.ssm,
                                                    qcfg)
        elif kind == "mlstm":
            fn = lambda p_, h_: xlstm_lib.mlstm_seq(
                p_, h_, cfg.num_heads, cfg.xlstm, None, qcfg)
        else:
            fn = lambda p_, h_: xlstm_lib.slstm_seq(p_, h_, cfg.xlstm, None,
                                                    qcfg)
        if PERF.local_recurrence:
            y, state = _local_batch_shard_map(fn, p, h)
        elif kind != "mamba" and is_dtensor(h):
            y, state = _batch_local(fn, p, h)
        else:
            y, state = fn(p, h)
        x = x + y
        if make_cache:
            cache = state
    x, aux = _apply_ff_aux(p, cfg, x, is_moe, qcfg)
    x = constrain(x, "batch", "seq", "d_model")
    return x, aux, cache


def _stack_forward(params, cfg: ModelConfig, x, positions, qcfg,
                   enc_out=None, make_cache=False, remat=False, flash=False):
    """Every layer in order. Returns (x, aux summed, caches: one dict a
    layer, or None without `make_cache`). With `remat` (and autograd on)
    each layer is recomputed in the backward pass
    (`torch.utils.checkpoint`), as the reference's `jax.checkpoint` of its
    scan body."""
    hd = cfg.resolved_head_dim
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for p, (kind, is_moe) in zip(params["layers"], _layer_kinds(cfg)):
        enc_kv = None
        if enc_out is not None and kind == "attn":
            # cross-attention K/V from the encoder output, this layer's
            # weights
            Bz, Se, _ = enc_out.shape
            enc_kv = {n: split_last(linear(enc_out, p["xattn"][w], qcfg),
                                    cfg.num_kv_heads, hd)
                      for n, w in (("xk", "wk"), ("xv", "wv"))}

        def run(x, p=p, kind=kind, is_moe=is_moe, enc_kv=enc_kv):
            return _apply_block_seq(p, cfg, kind, is_moe, x, positions,
                                    qcfg, enc_kv, make_cache, flash)

        if remat and torch.is_grad_enabled():
            x, aux, cache = checkpoint(run, x, use_reentrant=False)
        else:
            x, aux, cache = run(x)
        aux_total = aux_total + aux
        if make_cache:
            if enc_kv is not None:
                cache = dict(cache or {}, **enc_kv)
            caches.append(cache if cache is not None else {})
    return x, aux_total, (caches if make_cache else None)


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, frames, qcfg=None, *, flash=True):
    """frames: (B, Se, d_model) stubbed frontend embeddings -> (B, Se, d).
    The attention has no mask: through the flash op (`flash`, as
    `prefill` runs it), or the plain `bidirectional_attention` (as
    `forward` runs it, for autograd)."""
    B, Se, _ = frames.shape
    x = frames + params["enc_pos_embed"][:Se].to(frames.dtype)
    hd = cfg.resolved_head_dim
    attend = _bidirectional_flash if flash else attn.bidirectional_attention
    for p in params["encoder"]:
        h = apply_norm(p["ln1"], x, cfg.norm_kind)
        q, k, v = attn.qkv(p["attn"], h, cfg.num_heads, cfg.num_kv_heads,
                           hd, qcfg)
        o = constrain(attend(q, k, v), "batch", "seq", "qheads", None)
        x = _residual(x, linear(o.reshape(B, Se, cfg.num_heads * hd),
                                p["attn"]["wo"], qcfg))
        h = apply_norm(p["ln2"], x, cfg.norm_kind)
        x = _residual(x, apply_mlp(p["mlp"], h, cfg.mlp_kind, qcfg))
    return apply_norm(params["enc_final_norm"], x, cfg.norm_kind)


# ---------------------------------------------------------------------------
# Full forward / loss (train path)
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Token embeddings; a VLM's first P positions replaced by the stubbed
    patch embeddings `batch["patches"]` (B, P, d); learned positions
    added."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    if cfg.frontend == "vision_patches" and "patches" in batch:
        patches = batch["patches"].to(device=x.device, dtype=x.dtype)
        P_ = patches.shape[1]
        pat = F.pad(patches, (0, 0, 0, S - P_))
        is_patch = (torch.arange(S, device=x.device) < P_)[None, :, None]
        x = torch.where(is_patch, pat, x)
    if "pos_embed" in params:
        x = x + params["pos_embed"][:S].to(x.dtype)
    return x


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            qcfg=None, remat=False):
    """Full-sequence logits (fp32) and the MoE aux loss. batch: tokens
    (B, S) [+ frames (B, Se, d) / patches (B, P, d)]."""
    B, S = batch["tokens"].shape
    x = _embed_inputs(params, cfg, batch)
    positions = _positions(cfg, B, S, device=x.device)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = encode(params, cfg, batch["frames"].to(x.dtype), qcfg,
                         flash=False)
    x, aux, _ = _stack_forward(params, cfg, x, positions, qcfg,
                               enc_out=enc_out, remat=remat)
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    return unembed(params, cfg, x, qcfg), aux


def train_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               qcfg=None, remat=True):
    """(cross entropy + AUX_LOSS_COEF · aux, {"ce", "aux"}); batch adds
    labels (B, S) and an optional mask."""
    logits, aux = forward(params, cfg, batch, qcfg, remat=remat)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss + AUX_LOSS_COEF * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Contiguous cache
# ---------------------------------------------------------------------------

def _block_cache_shape(cfg: ModelConfig, kind: str, B: int, S_max: int,
                       enc_len: int = 0):
    hd, d = cfg.resolved_head_dim, cfg.d_model
    f32 = torch.float32
    if kind == "attn":
        kv_dt = PERF.kv_cache_dtype
        out = {"k": ((B, cfg.num_kv_heads, S_max, hd), kv_dt),
               "v": ((B, cfg.num_kv_heads, S_max, hd), kv_dt)}
        if cfg.family == "encdec":
            out["xk"] = ((B, enc_len, cfg.num_kv_heads, hd), torch.bfloat16)
            out["xv"] = ((B, enc_len, cfg.num_kv_heads, hd), torch.bfloat16)
        return out
    if kind == "mamba":
        di = cfg.ssm.expand * d
        return {"conv": ((B, cfg.ssm.d_conv - 1, di), torch.bfloat16),
                "h": ((B, di, cfg.ssm.d_state), f32)}
    if kind == "mlstm":
        di = int(cfg.xlstm.mlstm_proj_factor * d)
        dh = di // cfg.num_heads
        return {"C": ((B, cfg.num_heads, dh, dh), f32),
                "n": ((B, cfg.num_heads, dh), f32),
                "m": ((B, cfg.num_heads), f32)}
    return {k: ((B, d), f32) for k in ("c", "n", "m", "h")}


def cache_spec(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0):
    """(shape, dtype) tree: {"len": (B,), "layers": [per layer]}."""
    return {"len": ((batch,), torch.int32),
            "layers": [_block_cache_shape(cfg, kind, batch, max_len, enc_len)
                       for kind in cfg.block_pattern()]}


def _map_spec(fn, spec):
    if isinstance(spec, dict):
        return {k: _map_spec(fn, v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_map_spec(fn, v) for v in spec]
    return fn(*spec)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device=None):
    return _map_spec(lambda shape, dt: torch.zeros(shape, dtype=dt,
                                                   device=device),
                     cache_spec(cfg, batch, max_len, enc_len))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   enc_len: int = 0):
    """The cache as tensors on the `meta` device: shapes and dtypes, no
    memory (the reference's `ShapeDtypeStruct`s)."""
    return _map_spec(lambda shape, dt: torch.empty(shape, dtype=dt,
                                                   device="meta"),
                     cache_spec(cfg, batch, max_len, enc_len))


def constrain_cache(cfg: ModelConfig, cache):
    """The reference's sharding constraints on the cache, by the names of
    each leaf (the reference's, without its stacked repeat dimension)."""
    def visit(blk):
        c = {}
        for name, arr in blk.items():
            if name in ("k", "v"):
                c[name] = constrain(arr, "batch", "kvheads", "kv_seq_tp",
                                    None)
            elif name in ("xk", "xv"):
                c[name] = constrain(arr, "batch", None, "kvheads", None)
            else:
                names = ["batch"] + [None] * (arr.ndim - 1)
                if name in ("h", "C"):
                    names[1] = "ssm_inner"
                c[name] = constrain(arr, *names)
        return c
    return {"len": cache["len"],
            "layers": [visit(blk) for blk in cache["layers"]]}


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            qcfg=None, max_len: Optional[int] = None):
    """Run the full prompt, return (last-position logits (B, 1, V) fp32,
    the filled cache, K/V padded with zeros to `max_len`)."""
    B, S = batch["tokens"].shape
    max_len = max_len or S
    x = _embed_inputs(params, cfg, batch)
    positions = _positions(cfg, B, S, device=x.device)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = encode(params, cfg, batch["frames"].to(x.dtype), qcfg)
    x, _, caches = _stack_forward(params, cfg, x, positions, qcfg,
                                  enc_out=enc_out, make_cache=True,
                                  flash=True)
    for c in caches:
        if "k" in c and max_len > S:
            for nm in ("k", "v"):
                c[nm] = F.pad(c[nm], (0, 0, 0, max_len - S))
    cache = {"len": torch.full((B,), S, dtype=torch.int32, device=x.device),
             "layers": caches}
    cache = constrain_cache(cfg, cache)
    x = apply_norm(params["final_norm"], x[:, -1:], cfg.norm_kind)
    return unembed(params, cfg, x, qcfg), cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _flash_decode_attention(q, kc, vc, cache_len):
    """Flash-decoding over the cache's sequence shards (`local_region`):
    each rank of the "model" axis computes a partial softmax over its
    slice of the keys of its batch shard; the exact combine is three
    small all-reduces of (num, den, max) over the "model" group, and the
    output is split by batch (gathered whole for plain inputs). Without a
    mesh or a "model" axis, and at the reference's three other gates, it
    is `attention.decode_attention`."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh_axes(mesh):
        return attn.decode_attention(q, kc, vc, cache_len)
    n_model = mesh_axes(mesh)["model"]
    bax = _batch_axes(mesh, q)
    S = kc.shape[2]
    if S % n_model:
        return attn.decode_attention(q, kc, vc, cache_len)
    # gate: KV heads that fill the model axis shard the cache by head, not
    # by sequence
    if kc.shape[1] % n_model == 0:
        return attn.decode_attention(q, kc, vc, cache_len)
    # gate: at batch < DP degree the batch is not split over the data axes
    if bax is None:
        return attn.decode_attention(q, kc, vc, cache_len)
    by_batch = by_axes(mesh, {a: 0 for a in bax})
    by_seq = by_axes(mesh, {**{a: 0 for a in bax}, "model": 2})

    def partial(q_l, cl_l, kc_l, vc_l):
        s_loc = kc_l.shape[2]
        pos = mesh.get_local_rank("model") * s_loc + torch.arange(
            s_loc, device=q_l.device)
        valid = pos[None, :] < cl_l[:, None]
        num, den, m = attn.decode_attention_partial(q_l, kc_l, vc_l, valid)
        out = combine_partial_softmax(num, den, m, mesh.get_group("model"))
        return out.to(q_l.dtype)

    return local_region(partial, mesh, (q, cache_len, kc, vc),
                        (by_batch, by_batch, by_seq, by_seq),
                        lambda t: (by_batch, tuple(q.shape)))


def _apply_block_decode(p, cfg: ModelConfig, kind: str, is_moe: bool, x,
                        cache_j, positions, cache_len, qcfg):
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    new_cache = dict(cache_j)
    h = apply_norm(p["ln1"], x, cfg.norm_kind)
    if kind == "attn":
        q, k, v = attn.qkv(p["attn"], h, cfg.num_heads, cfg.num_kv_heads,
                           hd, qcfg)
        q = attn.rotate(cfg.rope_kind, q, positions, cfg.rope_theta)
        k = attn.rotate(cfg.rope_kind, k, positions, cfg.rope_theta)
        kc, vc = attn.update_cache(cache_j["k"], cache_j["v"], k, v,
                                   cache_len)
        attend = (_flash_decode_attention if PERF.flash_decode
                  else attn.decode_attention)
        o = attend(q, kc.to(x.dtype), vc.to(x.dtype), cache_len + 1)
        x = _residual(x, linear(o.reshape(B, 1, cfg.num_heads * hd),
                                p["attn"]["wo"], qcfg))
        new_cache["k"], new_cache["v"] = kc, vc
        if "xk" in cache_j:
            h = apply_norm(p["ln_x"], x, cfg.norm_kind)
            x = _residual(x, attn.cross_attention(
                p["xattn"], h, cache_j["xk"].to(x.dtype),
                cache_j["xv"].to(x.dtype), cfg.num_heads, cfg.num_kv_heads,
                hd, qcfg))
    else:
        if kind == "mamba":
            y, new_cache = ssm_lib.mamba_decode_step(p["mamba"], h, cache_j,
                                                     cfg.ssm, qcfg)
        else:
            if kind == "mlstm":
                fn = lambda p_, h_, c_: xlstm_lib.mlstm_seq(  # noqa: E731
                    p_, h_, cfg.num_heads, cfg.xlstm, c_, qcfg)
            else:
                fn = lambda p_, h_, c_: xlstm_lib.slstm_seq(  # noqa: E731
                    p_, h_, cfg.xlstm, c_, qcfg)
            y, new_cache = (_batch_local(fn, p, h, cache_j)
                            if is_dtensor(h) else fn(p, h, cache_j))
        x = x + y
    return _apply_ff(p, cfg, x, is_moe, qcfg), new_cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, cache, qcfg=None):
    """One decode step. token: (B, 1) int32; cache from prefill or
    init_cache. Returns (logits (B, 1, V) fp32, a new cache with len + 1;
    the given one untouched)."""
    B = token.shape[0]
    cache_len = cache["len"]
    x = embed_tokens(params, cfg, token)
    if "pos_embed" in params:
        # a lookup (the rows `pos_embed[i]`), which DTensor shards by the
        # batch of its ids where its indexing refuses to
        pos = F.embedding(cache_len.long().clamp(0, MAX_POS - 1),
                          params["pos_embed"])
        x = x + pos[:, None].to(x.dtype)
    positions = _positions(cfg, B, 1, offset=cache_len, device=x.device)
    layers = []
    for p, c, (kind, is_moe) in zip(params["layers"], cache["layers"],
                                    _layer_kinds(cfg)):
        x, nc = _apply_block_decode(p, cfg, kind, is_moe, x, c, positions,
                                    cache_len, qcfg)
        layers.append(nc)
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    logits = unembed(params, cfg, x, qcfg)
    new_cache = {"len": cache_len + 1, "layers": layers}
    return logits, constrain_cache(cfg, new_cache)
