"""Hardware book of the sim tier (the paper's H-axis), with the port's card.

A copy of `repro.simulate.hardware` plus one entry, `h100-sxm`, the card
the port runs on. The three TPU generations and the `cpu-node`
pseudo-entry are kept unchanged, so the port's sim tier reproduces the
reference's records on them exactly.

The TPU entries map the paper's cross-hardware pair (H100 NVL vs A100
PCIe) onto v5p-class (pricier, faster, higher-bandwidth) vs v5e (cheaper,
slower): the load-driven cost spread must reproduce with compressed
magnitude on the cheaper part. fp8 is native on the v6e-class entry
only; v5e runs fp8 through a dequant-emulation path (int8 is native
everywhere), reproducing the paper's hardware-conditional quantization
caveat. `h100-sxm` has fp8 tensor cores, so it runs fp8 at its int8
rate.

Prices are public on-demand list prices; the framework treats them as a
replaceable price book, exactly as the paper treats Azure rates ("the
framework's value is in the methodology, not specific dollar amounts",
§6.9).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareGen:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    peak_flops_int8: float
    hbm_bw: float               # bytes/s per chip
    ici_bw: float               # bytes/s per link (one direction)
    hbm_bytes: float            # per chip
    price_per_chip_hr: float    # $/chip-hour on-demand
    native_fp8: bool
    native_int8: bool = True

    def peak(self, quant: str) -> float:
        if quant == "int8" and self.native_int8:
            return self.peak_flops_int8
        if quant == "fp8" and self.native_fp8:
            return self.peak_flops_int8          # fp8 rides the 2x MXU path
        return self.peak_flops_bf16


V5E = HardwareGen("tpu-v5e", 197e12, 394e12, 819e9, 50e9, 16e9, 1.20,
                  native_fp8=False)
V5P = HardwareGen("tpu-v5p", 459e12, 918e12, 2765e9, 100e9, 95e9, 4.20,
                  native_fp8=False)
V6E = HardwareGen("tpu-v6e", 918e12, 1836e12, 1640e9, 100e9, 32e9, 2.70,
                  native_fp8=True)

# NVIDIA H100 80GB SXM5 ("NVIDIA H100 80GB HBM3" at 700 W), from NVIDIA's
# data sheet, https://www.nvidia.com/en-us/data-center/h100/ (H100 SXM
# column; dense rates, without sparsity): 989 TFLOP/s bf16, 1,979 TOP/s
# int8 and 1,979 TFLOP/s fp8, 3.35 TB/s of HBM3, 80 GB. ici_bw is NVLink
# 4's 900 GB/s taken in one direction; the step-time model reads it only
# when n_chips > 1. Price: Lambda's on-demand 8x H100 SXM 80GB instance,
# $2.99 per GPU-hour, https://lambdalabs.com/service/gpu-cloud#pricing,
# list price of 2025-06 (a replaceable book entry, like the TPU prices).
H100 = HardwareGen("h100-sxm", 989e12, 1979e12, 3.35e12, 450e9, 80e9, 2.99,
                   native_fp8=True)

HW_BY_NAME = {h.name: h for h in (V5E, V5P, V6E, H100)}

# Pseudo-hardware entry for the CPU real-execution tier: throughput is
# measured, only the price matters for C_eff shape validation.
CPU_NODE = HardwareGen("cpu-node", 1e12, 1e12, 5e10, 1e9, 64e9, 1.00,
                       native_fp8=False, native_int8=False)
HW_BY_NAME["cpu-node"] = CPU_NODE
