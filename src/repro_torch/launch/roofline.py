"""Three-term roofline from a dry-run record (§Roofline).

Counterpart of `repro.launch.roofline`, its functions unchanged: pure
functions of a config, a shape, a `HardwareGen` and a cost dict. The
port's dry-run (`launch.dryrun`) fills the cost dict from the local-shard
ops it counts under a fake process group, where the reference reads
XLA's `cost_analysis()`; the docstring below is the reference's.

    compute    = HLO_FLOPs_per_device / peak_FLOP/s
    memory     = HLO_bytes_per_device / HBM_bw
    collective = collective_bytes_per_device / ICI_link_bw

cost_analysis() on the SPMD module reports per-device flops/bytes;
collective bytes come from the HLO parser. MODEL_FLOPS (6·N·D train,
2·N_active·D serve) over HLO_FLOPs flags remat/redundancy waste. XLA:CPU's
"bytes accessed" over-counts vs a fused TPU executable, so the analytic
HBM floor (weights+state streamed once + activation traffic) is reported
alongside as `memory_analytic` (DESIGN §6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.simulate.hardware import HardwareGen, V5E


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float          # analytic (scan-corrected) per device
    flops_per_device_hlo: float      # raw cost_analysis (bodies counted 1x)
    bytes_per_device: float          # scan-corrected estimate
    bytes_per_device_hlo: float
    scan_multiplier: float           # applied body-execution correction
    collective_bytes_per_device: float   # trip-count-weighted HLO parse
    compute_s: float
    memory_s: float
    memory_analytic_s: float
    collective_s: float
    model_flops: float
    model_flops_ratio: float       # useful / implemented (whole job)
    bottleneck: str
    roofline_frac: float           # resource floor / dominant term

    def row(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (serve)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch            # one new token per sequence
    return 2.0 * n * tokens


def analytic_flops(cfg: ModelConfig, shape: ShapeConfig,
                   remat: bool = True) -> float:
    """Exact whole-job FLOPs of OUR implementation (XLA cost_analysis
    counts scan bodies once — verified — so the structural model is the
    ground truth; the raw HLO number ships alongside for audit).

    Matmul flops: fwd 2·N_active·T; backward +4·N·T; remat recompute +2·N·T.
    Attention: the chunked/flash path computes the full S x S rectangle
    (masked), so 4·B·Hq·hd·S·S_kv per attn layer fwd.
    """
    B, S = shape.global_batch, shape.seq_len
    n_attn = sum(1 for k in cfg.block_pattern() if k == "attn")
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    if shape.kind == "decode":
        T = B
        base = 2.0 * cfg.active_param_count() * T
        attn = 4.0 * B * n_attn * hq * hd * S        # read S-ctx per token
        return base + attn
    T = B * S
    fwd_mult, attn_mult = (1.0, 1.0)
    if shape.kind == "train":
        fwd_mult = 3.0 + (1.0 if remat else 0.0)     # fwd+bwd(2x)+remat
        attn_mult = fwd_mult
    base = 2.0 * cfg.active_param_count() * T * fwd_mult
    full_rect = S > 2048        # chunked path computes masked full S^2
    attn = 4.0 * B * n_attn * hq * hd * S * (S if full_rect else S / 2)
    attn *= attn_mult
    if cfg.encoder_layers:
        Se = cfg.frontend_len or 1500
        enc_p = cfg.encoder_layers * (
            4 * cfg.d_model * hq * hd + 2 * cfg.d_model * cfg.d_ff)
        base += 2.0 * enc_p * B * Se * fwd_mult
        attn += 4.0 * B * cfg.encoder_layers * hq * hd * Se * Se * attn_mult
    return base + attn


def analytic_memory_bytes(cfg: ModelConfig, shape: ShapeConfig,
                          weight_bytes_per_param: int = 2) -> float:
    """HBM floor: weights + KV/state traffic + activations, whole job."""
    w = cfg.param_count() * weight_bytes_per_param
    B, S = shape.global_batch, shape.seq_len
    act = 0.0
    if shape.kind in ("train", "prefill"):
        act = 4.0 * B * S * cfg.d_model * 2 * cfg.num_layers
        if shape.kind == "train":
            w *= 3            # params read + grad write + opt update traffic
    else:
        act = B * cfg.kv_bytes_per_token() * S     # read the whole cache
        w += B * cfg.kv_bytes_per_token()          # append one token
    return w + act


def compute_roofline(cfg: ModelConfig, shape: ShapeConfig, *,
                     mesh_name: str, n_devices: int,
                     cost: Dict[str, float],
                     coll_bytes: float,
                     hw: HardwareGen = V5E,
                     quant: str = "bf16") -> RooflineTerms:
    flops_hlo = float(cost.get("flops", 0.0))
    bytes_hlo = float(cost.get("bytes accessed", 0.0))
    peak = hw.peak(quant)

    # analytic (scan-corrected) compute; HLO raw reported alongside.
    flops_dev = analytic_flops(cfg, shape) / n_devices
    scan_mult = flops_dev / flops_hlo if flops_hlo else 1.0
    # bytes undercount lives in the same loop bodies -> scale by the same
    # body-execution multiplier (capped: never report below the raw value)
    bytes_dev = bytes_hlo * max(scan_mult, 1.0)

    compute_s = flops_dev / peak
    memory_s = bytes_dev / hw.hbm_bw
    mf = model_flops(cfg, shape)
    wbytes = 1 if quant in ("int8", "fp8") else 2
    mem_an = analytic_memory_bytes(cfg, shape, wbytes) / n_devices / hw.hbm_bw
    coll_s = coll_bytes / hw.ici_bw
    ratio = mf / (flops_dev * n_devices) if flops_dev else math.nan
    # bottleneck classification uses the analytic memory floor: XLA:CPU's
    # "bytes accessed" counts every unfused operand and would classify
    # every cell memory-bound (documented in EXPERIMENTS §Roofline; the
    # raw HLO term is reported alongside).
    terms = {"compute": compute_s, "memory": mem_an,
             "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    terms["memory"] = memory_s       # reported term stays the HLO formula
    useful_compute_s = (mf / n_devices) / peak
    # roofline fraction = irreducible time for the dominant resource over
    # its measured term: model FLOPs for compute-bound cells, the analytic
    # HBM floor for memory-bound cells; collective-bound cells have no
    # intrinsic floor (the collectives are scheme-induced), so the best
    # achievable is whichever physical term would dominate next.
    if bottleneck == "compute":
        frac = useful_compute_s / max(compute_s, 1e-30)
    elif bottleneck == "memory":
        frac = mem_an / max(memory_s, 1e-30)
    else:
        frac = max(useful_compute_s, mem_an) / max(coll_s, 1e-30)
    frac = min(frac, 1.0)
    return RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh=mesh_name,
        n_devices=n_devices, flops_per_device=flops_dev,
        flops_per_device_hlo=flops_hlo,
        bytes_per_device=bytes_dev, bytes_per_device_hlo=bytes_hlo,
        scan_multiplier=scan_mult,
        collective_bytes_per_device=coll_bytes,
        compute_s=compute_s, memory_s=memory_s,
        memory_analytic_s=mem_an, collective_s=coll_s,
        model_flops=mf, model_flops_ratio=ratio,
        bottleneck=bottleneck, roofline_frac=frac)
