"""Config dataclasses for the repro framework.

A ModelConfig fully describes an architecture; a ShapeConfig describes one
(seq_len, global_batch, kind) input-shape cell from the assignment. The
registry in __init__.py maps --arch ids to ModelConfig builders.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Shape cells (same four for every LM-family arch, per the assignment).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int                 # d_ff of each expert MLP
    capacity_factor: float = 1.25
    group_size: int = 256          # tokens per dispatch group
    # every `interleave`-th layer is MoE (1 = all layers, 2 = alternating)
    interleave: int = 1
    shared_expert_ff: int = 0      # optional always-on shared expert


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM block parameters."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                # d_inner = expand * d_model
    dt_rank: int = 0               # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack: ratio of mLSTM to sLSTM blocks."""
    slstm_every: int = 2           # every k-th block is sLSTM, rest mLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv1d_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # block type per layer position: "attn" | "mamba" | "mlstm" | "slstm"
    # resolved by block_pattern() below.
    mlp_kind: str = "swiglu"       # swiglu | relu2 | gelu
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm
    rope_kind: str = "rope"        # rope | mrope | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid pattern: attention every k-th layer (jamba: 8 -> 1 attn per 8)
    attn_every: int = 1
    # enc-dec (whisper): number of encoder layers; decoder = num_layers
    encoder_layers: int = 0
    # modality frontend stub: "none" | "audio_frames" | "vision_patches"
    frontend: str = "none"
    # max patches/frames the frontend stub can emit (vlm/audio)
    frontend_len: int = 0
    logit_softcap: float = 0.0
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def block_pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds for the decoder stack."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm" and self.xlstm is not None:
                k = "slstm" if (i % self.xlstm.slstm_every == self.xlstm.slstm_every - 1) else "mlstm"
            elif self.attn_every > 1:
                # jamba-style: one attention layer per `attn_every` block window
                k = "attn" if (i % self.attn_every == self.attn_every // 2) else "mamba"
            else:
                k = "attn"
            kinds.append(k)
        return tuple(kinds)

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        if self.moe is None:
            return tuple(False for _ in range(self.num_layers))
        il = self.moe.interleave
        return tuple((i % il == il - 1) for i in range(self.num_layers))

    # ---- parameter counting (used by cost model + roofline) ----
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """KV-cache bytes appended per generated token (all layers)."""
        hd = self.resolved_head_dim
        n_attn = sum(1 for k in self.block_pattern() if k == "attn")
        return n_attn * 2 * self.num_kv_heads * hd * bytes_per_el

    def shapes(self) -> Tuple[ShapeConfig, ...]:
        """Shape cells assigned to this arch (long_500k only for sub-quadratic)."""
        subquad = self.family in ("ssm", "hybrid")
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if subquad:
            out.append(LONG_500K)
        return tuple(out)


@functools.lru_cache(maxsize=None)
def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    """Analytic parameter count; active_only counts top-k experts only."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    attn = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d  # q,k,v,o

    def mlp(ff: int) -> int:
        if ff == 0:
            return 0
        mults = 3 if cfg.mlp_kind == "swiglu" else 2
        return mults * d * ff

    pattern = cfg.block_pattern()
    moe_mask = cfg.moe_layer_mask()
    total = 0
    for i, kind in enumerate(pattern):
        if kind == "attn":
            total += attn
        elif kind == "mamba":
            assert cfg.ssm is not None
            di = cfg.ssm.expand * d
            dtr = cfg.ssm.dt_rank or -(-d // 16)
            # in_proj (d->2*di), conv, x_proj (di->dtr+2*state), dt_proj, A, D, out_proj
            total += d * 2 * di + di * cfg.ssm.d_conv + di * (dtr + 2 * cfg.ssm.d_state)
            total += dtr * di + di * cfg.ssm.d_state + di + di * d
        elif kind == "mlstm":
            assert cfg.xlstm is not None
            di = int(cfg.xlstm.mlstm_proj_factor * d)
            # up 2x (x + gate), q/k/v projections at di, gates, down
            total += d * 2 * di + 3 * di * di
            total += 3 * di  # i,f,o gate vectors (simplified)
            total += di * d
        elif kind == "slstm":
            assert cfg.xlstm is not None
            di = d
            total += 4 * di * di + 4 * di  # recurrent gates
            pf = cfg.xlstm.slstm_proj_factor
            total += int(2 * di * di * pf)  # ff up/down
        # MLP / MoE
        if kind == "attn" or cfg.family == "hybrid":
            if moe_mask[i] and cfg.moe is not None:
                e = cfg.moe.top_k if active_only else cfg.moe.num_experts
                total += e * mlp(cfg.moe.expert_ff) + d * cfg.moe.num_experts
                total += mlp(cfg.moe.shared_expert_ff)
            else:
                total += mlp(cfg.d_ff)
        # norms
        total += 2 * d
    # embeddings (+ output head unless tied)
    total += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    # encoder stack (whisper): encoder layers are attn + mlp
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (attn + mlp(cfg.d_ff) + 2 * d)
    return int(total)
