"""Drive the PyTorch port's live cost-metered server, its training and its
parallel substrate on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. device: the card's name, count, and `nvidia-smi` name and power limit;
  2. build: every kernel of `src/repro_torch/csrc/` with nvcc for sm_90a,
     one process each, in parallel; ptxas's register/shared-memory lines;
     the flash library's SASS (`cuobjdump -sass`) must hold tensor-core
     (HGMMA) and TMA-load (UTMALDG) instructions, the int8 library's
     integer tensor-core (IGMMA) and TMA-load ones, the MoE grouped GEMM's
     HGMMA, UTMALDG and ldmatrix (LDSM) and no int-to-float conversion
     (I2F), the paged library's
     cp.async copies (LDGSTS), the scan library's cp.async (or TMA) copies
     and exponentials (MUFU.EX2, counted), the fleet loop's PTX float64
     products, sums and quotients rounded to nearest (mul.rn, add.rn,
     div.rn) and no fused multiply-add (fma.f64) nor any product or sum
     that ptxas may contract (its SASS counted: DFMA there divides), and
     ptxas must report no spill bytes for the int8, scan, 8-bit AdamW and
     MoE grouped-GEMM kernels on a fresh build; SYNCS (mbarrier) counted; the 8-bit AdamW
     library's PTX must round every fp32 product, sum, quotient and square
     root on its own (mul.rn, add.rn, div.rn, sqrt.rn) and fuse only the
     multiply-adds its source writes (fma.rn), nothing ptxas may contract
     (its SASS FFMAs counted: the source's and div.rn's and sqrt.rn's);
  3. kernels: each kernel against its plain PyTorch version at the served
     shapes of llama31-8b, qwen3-30b-a3b and jamba-v0.1-52b (and the int8
     GEMM at mixtral-8x7b's, phi3-medium-14b's and nemotron-4-15b's
     lm_heads, N 32000, 100352 and 256000, granite-34b's wk/wv at N 128,
     codeqwen1.5-7b's down projection at K 13440, xlstm-350m's sLSTM
     projections at K or N 1365, in rows padded to 1376 bytes whose
     padding holds random codes, and llama4-maverick-400b-a17b's lm_head,
     N 202048, and wk/wv, N 1024); the attention kernels at every
     (head_dim, group) they are compiled for (`ATTN_ARCHS`: 128 with G 4,
     8, 1, 6, 48, 7 and 5, and 64 with G 2), and flash without a mask at
     whisper-base's 1500 frames (D 64, G 1). The
     attention kernels in bf16 with |kernel - plain| <= 1e-3 + 2**-7
     |plain| on every element (one bf16 step of the result;
     `repro_torch.kernels.bf16_gate`; flash also with the prefill's
     padding mask `kv_len`); the int8 matmul
     bit for bit; the selective scan's y and h_final in fp32 with
     |kernel - plain| <= 1e-5 + 1e-4 |plain| (`fp32_gate`) at the prefill
     (8, 512, 8192, 16) and decode (8, 1, 8192, 16) shapes. Each check
     must also reject a planted fault (the kernel run with the last page,
     the last key tile or the last 128-wide K tile dropped, the scan's
     decode step with h0 read as zeros, or its prefill without its last
     chunk of time steps; the int8 fault must change more than 90% of the
     outputs, and at K 1365 it drops the ragged tail: K run as 1360;
     without a mask the last key tile of 1500 frames, its 28 keys, is
     dropped). The scan's prefill grid must fit the card in one wave
     (`ssm_scan.kernel.layout`, from the occupancy API). The
     int8 weights are stored K-major, as the model stores them. A paged
     row with seq_len 0 must be the mean of V over its block-table row
     (within `bf16_gate`), also at a served decode mix whose idle slots
     have rows of 0s. Then the
     kernel, the plain version and the yardstick PyTorch call timed on the
     device (CUDA graphs of repeated calls, timed with CUDA events), each
     beside its bound; paged attention also at a served decode step's
     contexts (8 slots of 520-768 tokens), with and without slots 0-3
     idle; flash also at a served prefill call's kv_len, half
     the slots at 512 and half at 0, with its TFLOP/s, share of its bound
     and ratio to SDPA; the int8 GEMM with its TOP/s and `torch._int_mm`
     on the K-major weight and on a row-major copy. The fused 8-bit AdamW
     update at llama31-8b's leaf shapes (embedding, wq, wk, gate, down, a
     norm scale; bf16 g and p, wq also with fp32 g) and xlstm-350m's
     ragged sLSTM width 1365: p, codes and scales bit for bit against its
     plain version after 3 updates, a planted fault (the last 256-block of
     each row left un-re-encoded) rejected, timed beside its bound (10
     bytes an element in bf16, plus the scales). The int8 experts'
     grouped GEMM (`check_moe_gemm`) at the decode and prefill expert
     shapes of mixtral-8x7b, jamba-v0.1-52b, llama4-maverick-400b-a17b,
     qwen3-30b-a3b and granite-moe-1b-a400m against `dequantize` + einsum
     by `bf16_gate`, its weights bit for bit (codes at the extremes,
     scales over 1e-10 to 1e4), two planted faults rejected, timed beside
     its bound and the bf16 einsum on weights already dequantized;
  4. small-input checks: narrow models (llama31-8b in bf16 and in int8,
     qwen3-30b-a3b in bf16, mixtral-8x7b in int8 with its own routing,
     phi3-medium-14b in int8, codeqwen1.5-7b in bf16, nemotron-4-15b and
     granite-34b in int8, granite-moe-1b-a400m in bf16 with its own
     routing, held by its K/V and fp32 logits, qwen2-vl-7b in bf16,
     llama4-maverick-400b-a17b in bf16 with its own routing over 8 experts
     (top-1, a shared expert), held by K/V, tokens and fp32 logits
     (`LOGITS_BOUNDS`), 2 layers, the last six at their full config's
     head_dim and group;
     whisper-base in bf16 through `models.prefill` and `decode_step` (2 +
     2 layers, 8 heads of 64, 1500 frames), held by K/V, cross-attention
     K/V and fp32 logits; jamba-v0.1-52b in bf16 and
     int8, 8 layers; xlstm-350m in bf16, 4 layers, held by its states and
     fp32 logits) through the kernels on the card against the same models
     through the plain versions on the CPU; every check is printed with
     its last decode step's fp32 logits against the CPU's, and a failed
     one fails the run once the later phases have run;
  5. main paths: full-width models (random weights from a seed) through
     `build_engine` -> `Engine` -> `RealExecutor` -> `CostMeter`, each
     serving 8 chat requests (512:256, lambda 4/s, seed 0) that overlap:
     llama31-8b in bf16 and int8 (32 layers), qwen3-30b-a3b in bf16, int8
     and fp8 (48 layers), jamba-v0.1-52b in int8 and fp8 (32 layers: 4
     attention, 28 Mamba, 16 MoE), mixtral-8x7b in int8 and fp8 (32
     layers, all MoE: 8 experts, top-2), xlstm-350m in bf16 (24 layers:
     12 mLSTM, 12 sLSTM; tied embeddings; no kernel of the port on its
     path), phi3-medium-14b in bf16 and int8 (40 layers, d_model 5120,
     40/10 heads), codeqwen1.5-7b in bf16 and int8 (32 layers, 32/32
     heads), nemotron-4-15b in bf16 and int8 (32 layers, 48/8 heads,
     squared-ReLU MLP, layernorm, vocab 256000), granite-34b in int8 and
     bf16 (88 layers, 48/1 heads, gelu MLP) and granite-moe-1b-a400m in
     bf16 (24 MoE layers: 32 experts, top-8; head_dim 64; tied
     embeddings), qwen2-vl-7b in bf16 and int8 (28 layers, 28/4 heads,
     M-RoPE over equal positions), xlstm-350m in int8 (its sLSTM
     projections at K or N 1365) and llama4-maverick-400b-a17b in bf16 and
     int8 (40/8 heads, vocab 202048; a dense layer, then a MoE layer of
     128 experts, top-1, and a shared expert). Depth cut (`DEPTH_CUTS`) to
     keep the run in its time (llama4-maverick to its first 2 layers, one
     whole unit of 18.55 B parameters: its 48 fit no card):
     qwen3-30b-a3b, jamba-v0.1-52b and mixtral-8x7b in fp8 serve their
     first 8 layers (jamba's one whole unit: 1 attention, 7 Mamba, 4
     MoE), then qwen3-30b-a3b, phi3-medium-14b, granite-34b,
     codeqwen1.5-7b, nemotron-4-15b, qwen2-vl-7b and granite-moe-1b-a400m
     in bf16 their first 8 and
     xlstm-350m in bf16 and int8 its first 4, each at
     full width with every block kind and kernel of its path; every other
     int8 path keeps full depth. Each path prints the card's
     peak allocated memory. Every request must finish with its token
     count, the K/V pools and recurrent states must hold no NaN and no
     infinity but the -inf
     mLSTM stabiliser of a slot that never prefilled, and the kernels'
     launch counts, set to 0 before each path and read after it, must be
     one flash launch per attention layer per prefill call, one paged
     launch per attention layer per decode step, one scan launch per
     Mamba layer per call and, under int8, one int8 launch per `linear`
     per call (225 for llama31-8b and codeqwen1.5-7b, 193 for
     qwen3-30b-a3b and nemotron-4-15b, 177 for jamba-v0.1-52b, 129 for
     mixtral-8x7b, 281 for phi3-medium-14b, 529 for granite-34b, 197 for
     qwen2-vl-7b, 18 for xlstm-350m's 4 layers, 15 for
     llama4-maverick-400b-a17b's 2, its shared expert's 3 among them),
     under int8 one grouped-GEMM launch per expert product of a MoE layer
     per call (96 for mixtral-8x7b), and every call's fp32
     logits finite. On a MoE path, after the timed serve, the first MoE
     layer's expert products once more with the tracer on: one `moe.gemm`
     span a launch and no `moe.dequant` for int8 experts, `moe.dequant`
     and no launch for the others. Then the contiguous-cache API: whisper-base at full
     width and depth (6 + 6 layers) through `models.prefill` over 8 slots
     of 1500 frames and a 440-token prompt and 8 `decode_step`s, its
     counts set to 0 before it: flash 18 launches, 12 without a mask, no
     other kernel; finite logits and cache. The
     meter prices at the card's hardware-book entry
     (`launch.serve.real_tier_hw`: `h100-sxm`), and each prefill call's
     and decode step's work and wall time is logged for phase 6;
  6. sim tier: each main path again on `SimExecutor` over the step-time
     model of `h100-sxm` (same quant, engine and arrivals): every request
     must finish with the real tier's token count; tokens/s, TTFT p50,
     engine clock, decode-step and prefill-call times printed beside the
     real tier's, with real/sim ratios (a finding, not a gate). Then the
     paper's 42-cell matrix (the reference's `paper_h100` axes: the
     paper's three models x {bf16, fp8} x the 7-point lambda ladder,
     mixtral-8x7b on 2 chips) on `h100-sxm` through `PlanRunner`: 42
     records, every C_eff finite and positive, penalty = 1/U to 1e-9,
     C_eff non-increasing along each ladder within 5%; per (model, quant)
     C_eff at each lambda, the idle-to-saturation spread and the penalty
     at lambda 1, per model the fp8 uplift in saturation tokens/s;
  7. fleet: the fleet-loop kernel (the jit backend's event loop, float64,
     one thread a lane) against its plain version on the card at phase
     6's grid and at the first 512-lane chunk of its ensemble (integers
     equal, floats within the jit tolerance, a run with the budget cut
     skipped rejected), timed beside its bound and the serial chain of
     its longest lane (a one-thread probe times a dependent float64 sum
     and quotient); then
     that grid (42 lanes) and its 672-lane ensemble (the reference's
     `paper_ensemble` axes: 16 arrival seeds) through `PlanRunner` on the
     numpy fleet ("vector") and on the card ("jit", one launch a chunk of
     at most 512 lanes): the vector records equal phase 6's, the jit
     records within the jit tolerance of the vector ones, every lane on
     the kernel (no fallback), launches exactly 1 and 2, the ensemble's
     confidence bands equal within the tolerance; wall times, device ms a
     launch, rounds of the longest lane;
  8. live validation, the paper's six-phase run (§6.7): the real half of
     `examples/torch_serve_cost_meter.py` on the full-width llama31-8b in
     bf16 through `build_engine` (rates 0.5, 1, 2, 4, 2, 0.5 req/s, 20 s of
     arrivals each, chat scaled to 192 : 96; 200 requests) with the meter
     ticking, each tick, each phase's peak in flight and queue, and the
     summary printed; gates: every request
     finishes, tokens conserved, flash and paged launches exact (counts set
     to 0 before it), K/V finite, the meter's average finite and positive.
     Then the example's sim half on `h100-sxm`, and the same traffic and
     engine on the sim tier beside the real readings;
  9. training, every served model freed first: (a) a narrow llama31-8b
     (2 layers, d_model 512, vocab 1024, bf16) trains `TRAIN_SMALL`'s 5
     adamw8bit steps on the card (the fused kernel) and on the CPU (its
     plain version) from the same weights and batches, held by
     `TRAIN_SMALL_BOUNDS` (each step's loss and the final parameters),
     the card's run with the gradient clip skipped rejected; and step by
     step (each step also taken on the CPU from a copy of the card's
     state), held by `TRAIN_LOCKSTEP_BOUNDS` (the shares of parameters
     and moment codes that differ), the clip skipped and the kernel's
     unencoded last block rejected; (b)
     `repro_torch.launch.train.main(TRAIN_FULL)`: llama31-8b at full width
     and depth (32 layers, 8.03 B parameters) with adamw8bit, 4 steps of
     2 x 512 tokens, its counts set to 0 before it (gates: every loss and
     grad norm finite, the loss falling at every step, one adamw8bit
     launch per leaf per step, every weight matrix moved from the initial
     weights; each step's stream time as the entry point returns it,
     tokens/s, peak allocated, and the optimizer's device ms a step on
     the trained state against its bound printed); (c)
     `examples/torch_train_small.py`'s ~100M config: 4 steps straight,
     then 2, a checkpoint, a restore and 2 more, the last loss within
     1e-2 of the straight run's;
 10. parallel (`parallel_phase`): a one-rank NCCL group and a (1, 1)
     `DeviceMesh`; the flash-decoding combine, the ring all-gather and a
     one-stage pipeline on CUDA tensors against their values without a
     group, and llama31-8b's `decode_step` (full width and depth) under
     `shardctx` against the same steps without it: equal; then the
     sharded checkpoint restore (`sharded_restore`): a narrow llama31-8b's
     parameters and adamw8bit state restored with `shardings=`, every
     leaf a DTensor on the card whose local tensor equals the plain
     restore's bit for bit, and a corrupted newest step skipped by
     `restore_latest`. Multi-rank NCCL waits for a machine with more than
     one card (the multi-rank parity runs on the CPU:
     `tests/test_torch_parallel.py`).
 11. dry-run (`dryrun_phase`): `launch.dryrun.run_cell` on fake process
     groups in a child process (after phase 10, so that no timed phase
     shares the host's cores with it; a fake group is process-wide):
     whisper-base decode_32k on 256 and 512 ranks and llama31-8b
     decode_32k on 256, on `h100-sxm`
     (gates, `dryrun_gates`: status ok; argument bytes equal to
     `launch.specs`' specs' shard bytes, which the planted fault, every
     parameter replicated, must fail, and less the unread arguments
     equal to the reference's record; FLOPs within a band of the
     analytic count and collective bytes within a band of the
     reference's), and the counters exact on the unit product; a
     `{"dryrun": ...}` line with the card's name and power limit.
Then `main_paths`, `contiguous_api`, `sim_tier`, `fleet`,
`live_validation`, `training`, `parallel`, `dryrun` and `kernels` JSON
lines, the
`nvidia-smi` line, and as the last line
`{"ok": true, "device": {...}}`. Needs no network and imports no JAX.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12          # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor FLOP/s (data sheet)
INT8_PEAK = 1979e12       # H100 SXM dense int8 tensor OP/s (data sheet)
FP32_PEAK = 67e12         # H100 SXM fp32 FLOP/s outside the tensor cores
FP64_PEAK = 34e12         # H100 SXM fp64 FLOP/s outside the tensor cores
# exponentials: 16 a clock per SM in the special-function units, 132 SMs
# at the 1.98 GHz boost clock
EXP_RATE = 132 * 16 * 1.98e9
# served shapes: 8 slots of 512 + 256 tokens at page 16; the attention
# kernels at each (head_dim, query heads per KV head) they are compiled
# for, with the heads of the arch that serves it (`heads`): G 4 and 8 at
# head_dim 128 (llama31-8b, qwen3-30b-a3b), G 1, 6, 48, 7 and 5
# (codeqwen1.5-7b, nemotron-4-15b, granite-34b, qwen2-vl-7b,
# llama4-maverick-400b-a17b), and head_dim 64 at G 2 (granite-moe-1b-a400m)
B, PAGE, MAXP = 8, 16, 48
ATTN_ARCHS = ("llama31-8b", "qwen3-30b-a3b", "codeqwen1.5-7b",
              "nemotron-4-15b", "granite-34b", "granite-moe-1b-a400m",
              "qwen2-vl-7b", "llama4-maverick-400b-a17b")
# whisper-base on the contiguous-cache API (`models.prefill`,
# `models.decode_step`): 8 slots of 1500 stubbed audio frames, a prompt of
# 440 tokens and 8 decode steps (448 tokens: the decoder's context); its
# encoder's attention and the cross-attention run flash without a mask
WHISPER = dict(batch=8, frames=1500, prompt=440, steps=8)
# a served decode step's contexts: 8 slots of 512 prompt tokens, 8-256
# tokens into their answers
SERVED_LENS = [520, 555, 591, 626, 662, 697, 733, 768]
# (M, K, N) of the int8 products on the main paths: 8 rows in decode and
# for the prefill lm_head, 8 x 512 for the other prefill projections (512
# for a call that prefills one prompt)
INT8_SHAPES = [
    (8, 4096, 14336, "llama31-8b decode gate/up"),
    (4096, 4096, 14336, "llama31-8b prefill gate/up"),
    (8, 14336, 4096, "llama31-8b decode down"),
    (8, 4096, 128256, "llama31-8b lm_head"),
    (8, 2048, 4096, "qwen3-30b-a3b decode wq"),
    (4096, 2048, 512, "qwen3-30b-a3b prefill wk/wv"),
    (8, 4096, 16384, "jamba-v0.1-52b decode in_proj"),
    (4096, 8192, 288, "jamba-v0.1-52b prefill x_proj"),
    (8, 256, 8192, "jamba-v0.1-52b decode dt_proj"),
    (4096, 14336, 4096, "llama31-8b prefill down"),
    (4096, 4096, 4096, "llama31-8b prefill wq/wo"),
    (4096, 4096, 1024, "llama31-8b prefill wk/wv"),
    (4096, 4096, 16384, "jamba-v0.1-52b prefill in_proj"),
    (4096, 8192, 4096, "jamba-v0.1-52b prefill out_proj"),
    (4096, 2048, 4096, "qwen3-30b-a3b prefill wq"),
    (4096, 4096, 2048, "qwen3-30b-a3b prefill wo"),
    (8, 2048, 151936, "qwen3-30b-a3b lm_head"),
    (8, 4096, 65536, "jamba-v0.1-52b lm_head"),
    (512, 4096, 14336, "llama31-8b prefill gate/up, one prompt"),
    (8, 4096, 32000, "mixtral-8x7b lm_head"),
    (8, 5120, 100352, "phi3-medium-14b lm_head"),
    (8, 6144, 256000, "nemotron-4-15b lm_head"),
    (8, 6144, 128, "granite-34b decode wk/wv"),
    (8, 13440, 4096, "codeqwen1.5-7b decode down"),
    (8, 1365, 1024, "xlstm-350m decode slstm_down"),
    (8, 1024, 1365, "xlstm-350m decode slstm_up"),
    (4096, 1365, 1024, "xlstm-350m prefill slstm_down"),
    (4096, 1024, 1365, "xlstm-350m prefill slstm_up"),
    (8, 3584, 512, "qwen2-vl-7b decode wk/wv"),
    (8, 18944, 3584, "qwen2-vl-7b decode down"),
    (8, 3584, 152064, "qwen2-vl-7b lm_head"),
    (4096, 3584, 18944, "qwen2-vl-7b prefill gate/up"),
    (8, 5120, 202048, "llama4-maverick-400b-a17b lm_head"),
    (8, 5120, 1024, "llama4-maverick-400b-a17b decode wk/wv"),
]
# the int8 experts' grouped GEMM at each MoE configuration's served shapes
# (E, d, f, rows an expert at decode, at a prefill of 8 x 512): up and
# gate (K d, N f) and down (K f, N d); rows as `models.moe.apply_moe`
# gives them (groups of 256 tokens, capacity factor 1.25)
MOE_GEMM_ARCHS = [("mixtral-8x7b", 8, 4096, 14336, 3, 1280),
                  ("jamba-v0.1-52b", 16, 4096, 14336, 2, 640),
                  ("llama4-maverick-400b-a17b", 128, 5120, 8192, 1, 48),
                  ("qwen3-30b-a3b", 128, 2048, 768, 8, 320),
                  ("granite-moe-1b-a400m", 32, 1024, 512, 8, 1280)]
# the selective scan at jamba-v0.1-52b's served shapes (B, S, d_inner, N):
# prefill of 8 slots at Lp 512 from a zero state, and a decode step
SSM_SHAPES = [(8, 512, 8192, 16, "prefill"), (8, 1, 8192, 16, "decode")]
MAIN_PATHS = [("llama31-8b", "bf16"), ("llama31-8b", "int8"),
              ("qwen3-30b-a3b", "bf16"), ("qwen3-30b-a3b", "int8"),
              ("qwen3-30b-a3b", "fp8"), ("jamba-v0.1-52b", "int8"),
              ("jamba-v0.1-52b", "fp8"), ("mixtral-8x7b", "int8"),
              ("mixtral-8x7b", "fp8"), ("xlstm-350m", "bf16"),
              ("phi3-medium-14b", "bf16"), ("phi3-medium-14b", "int8"),
              ("codeqwen1.5-7b", "bf16"), ("codeqwen1.5-7b", "int8"),
              ("nemotron-4-15b", "bf16"), ("nemotron-4-15b", "int8"),
              ("granite-34b", "int8"), ("granite-34b", "bf16"),
              ("granite-moe-1b-a400m", "bf16"), ("qwen2-vl-7b", "bf16"),
              ("qwen2-vl-7b", "int8"), ("xlstm-350m", "int8"),
              ("llama4-maverick-400b-a17b", "bf16"),
              ("llama4-maverick-400b-a17b", "int8")]
# main paths served at a cut depth (`launch.serve.cut_depth`), so that the
# whole run keeps within its time on a slow host too: the three fp8
# paths, whose int8 twins keep full depth, then qwen3-30b-a3b and
# phi3-medium-14b in bf16, whose int8 twins run the same attention
# kernels at full depth, and xlstm-350m, which runs no kernel of the
# port, and its int8 twin, which runs only the int8 kernel; each keeps
# every block kind and kernel of its path (jamba's 8 layers are one whole
# unit: 1 attention, 7 Mamba, 4 MoE; xlstm's 4 two mLSTM and two sLSTM
# blocks). Since phase 9 (training) the run came within 11 s of its 880 s
# mark on one host, and with granite-34b in bf16 cut ended at 882 s on a
# slower one, so granite-34b, codeqwen1.5-7b and nemotron-4-15b in bf16
# are cut too, their int8 twins running the same attention kernels (G 48,
# 1 and 6) at full depth. llama4-maverick-400b-a17b serves one whole unit,
# its first 2 layers (a dense layer, then a MoE layer of 128 experts and a
# shared expert): 18.55 B parameters, 37.1 GB in bf16; its 48 layers hold
# 397.7 B, which no card holds in any precision. With its paths and checks
# the run ended at 893.6 s on an H100 80GB HBM3 (700 W), ~60 s later than
# without them, so qwen2-vl-7b and granite-moe-1b-a400m
# in bf16 serve their first 8 layers too (each 1-layer unit whole; their
# attention kernels, G 7 and D 64, unchanged; qwen2-vl-7b's int8 twin at
# full depth)
DEPTH_CUTS = {("llama4-maverick-400b-a17b", "bf16"): 2,
              ("llama4-maverick-400b-a17b", "int8"): 2,
              ("qwen2-vl-7b", "bf16"): 8, ("granite-moe-1b-a400m", "bf16"): 8,
              ("qwen3-30b-a3b", "fp8"): 8, ("jamba-v0.1-52b", "fp8"): 8,
              ("mixtral-8x7b", "fp8"): 8, ("qwen3-30b-a3b", "bf16"): 8,
              ("phi3-medium-14b", "bf16"): 8, ("xlstm-350m", "bf16"): 4,
              ("xlstm-350m", "int8"): 4, ("granite-34b", "bf16"): 8,
              ("codeqwen1.5-7b", "bf16"): 8, ("nemotron-4-15b", "bf16"): 8}
# phase 4: narrow models, the kernels on the card against the plain
# versions on the CPU; those in REAL_ROUTING route as their full config
# (top-k, groups; as many experts, or SMALL_EXPERTS), those in SMALL_HEADS
# take these (query heads, KV heads, head_dim): the full config's head_dim
# and query heads per KV head
REAL_ROUTING = {"mixtral-8x7b", "granite-moe-1b-a400m",
                "llama4-maverick-400b-a17b"}
SMALL_EXPERTS = {"llama4-maverick-400b-a17b": 8}
SMALL_HEADS = {"codeqwen1.5-7b": (4, 4, 128), "nemotron-4-15b": (12, 2, 128),
               "granite-34b": (48, 1, 128),
               "granite-moe-1b-a400m": (8, 4, 64),
               "qwen2-vl-7b": (14, 2, 128), "whisper-base": (8, 8, 64),
               "llama4-maverick-400b-a17b": (10, 2, 128)}
SMALL_CHECKS = [("llama31-8b", "bf16"), ("llama31-8b", "int8"),
                ("qwen3-30b-a3b", "bf16"), ("jamba-v0.1-52b", "bf16"),
                ("jamba-v0.1-52b", "int8"), ("mixtral-8x7b", "int8"),
                ("xlstm-350m", "bf16"), ("phi3-medium-14b", "int8"),
                ("codeqwen1.5-7b", "bf16"), ("nemotron-4-15b", "int8"),
                ("granite-34b", "int8"), ("granite-moe-1b-a400m", "bf16"),
                ("qwen2-vl-7b", "bf16"), ("llama4-maverick-400b-a17b", "bf16")]
# phases 5 and 6: 8 chat requests (512 in : 256 out) that overlap
MAIN_SPEC = dict(lam=4.0, n_requests=8, io_shape="chat", scale=1.0, seed=0)
# phase 6: the sim tier on the card's own hardware-book entry, and the
# reference's `paper_h100` matrix (experiments/plans.py) moved onto it
SIM_HW = "h100-sxm"
PAPER_TRIO = ("llama31-8b", "qwen3-30b-a3b", "mixtral-8x7b")
PAPER_CHIPS = (("llama31-8b", 1), ("qwen3-30b-a3b", 1), ("mixtral-8x7b", 2))
# phase 7, counted from the round body (`csrc/fleet_loop.cuh`, a decode
# round of a dense one-chip lane that does not cut its burst; a quotient
# is one operation, a conversion, ceil, max or min none): its float64
# operations (decode_terms 8, the mean context 1, the time to the next
# event 2, jump 17, clock and busy area 3; a round that admits adds 18, a
# probe of the budget cut 17, an idle round has 2), and its dependent
# chain, each step waiting for the one before: n_occ to float64, b kv,
# its quotient by bwd (the slope), that times the mean context, mem0,
# compute - mem0, its quotient by the slope, ceil, max, min (m), m + k,
# - 1, times the slope, times k - m, halved, the series, two sums to the
# burst's time, the clock: 19 steps, 2 of them quotients
# phase 8: the six-phase live validation (`examples/torch_serve_cost_meter.py`)
# at the reference's rates 0.5, 1, 2, 4, 2, 0.5 req/s, 20 s of arrivals
# each (200 requests), chat scaled by 0.375 (192 in : 96 out). At 0.25
# (128 : 64) an H100 80GB HBM3 (700 W) filled its 8 slots in the 4 req/s
# phase in each of three runs, but served 238-255 tokens/s at its peak
# there, 3.7-4.0 req/s of 64-token answers, so that phase queued on some
# hosts and hardly on others (TTFT p50 of all requests 2,870, 62 and
# 1,050 ms). At 96 tokens the same peak serves at most 2.7 req/s, so the
# fourth phase offers 1.5 times that; measured at 0.375, it queued 50
# requests at its peak (their TTFT p50 15.0 s), and the backlog held all
# 8 slots to the end of the run
LIVE = dict(phase_s=20.0, scale=0.375)
# phase 3: the fused 8-bit AdamW update at llama31-8b's leaf shapes (the
# embedding, wq, wk, the MLP's gate and down projections, a norm scale)
# and at xlstm-350m's sLSTM width 1365 (a ragged last block of 85), with
# the clip scale ADAMW_CLIP where a case says so
ADAMW_SHAPES = [("embed", (128256, 4096)), ("wq", (4096, 4096)),
                ("wk", (4096, 1024)), ("gate", (4096, 14336)),
                ("down", (14336, 4096)), ("norm scale", (4096,)),
                ("xlstm-350m sLSTM, ragged", (1024, 1365))]
ADAMW_CLIP = 0.37
# fp32 operations an element of the update: both dequantizations (3
# each), m (3: a product and a fused multiply-add) and v (4), u (two
# quotients, a sum, a square root, a reciprocal and a product), p (a fused
# multiply-add) and both encodings (a quotient, a square root, a product
# and a rounding each)
ADAMW_F32_OPS = 29
# phase 9: training. (a) the narrow llama31-8b, adamw8bit, on the card and
# on the CPU from the same weights and batches; (b) the full llama31-8b
# through the port's training entry point; (c)
# `examples/torch_train_small.py` with a restart. (a) runs (and the
# example trains with) at lr 1e-3, the ~100M example's rate: at 3e-3
# adamw8bit diverges on the narrow model within its 5 steps. Every bound
# of (a) sits at the geometric mean of the farthest sound reading (the
# card against the CPU) and the nearest planted fault that reading is
# held against, weight seeds 1-8 (`scripts/train_check_sensitivity.py
# --seeds 8`; H100 80GB HBM3, 700 W; PERF.md §6). Free-running, 5 steps
# (fault: the card's run with the clip skipped): the largest difference
# of a step's loss 0.143 / 0.364 and of the final parameters 10.2 / 46.5.
# These read rounding that compounds (a v code rounded to 0 makes an
# element's update explode on either side), so they only guard the whole
# run; their mean |difference| separated nothing (sound 0.00147, fault
# 0.00114) and is printed. Step by step (each step also taken on the CPU
# from a copy of the card's state): the share of parameters not equal
# 0.0301 / 0.788 (clip skipped; the kernel's unencoded last block leaves
# every parameter right, 0.015-0.023) and of moment codes more than 1
# apart 0.00213 / 0.351 (the unencoded block; clip skipped 0.72). (b)
# runs at 3e-5, where the full model's loss falls at every step
# (12.47, 10.68, 9.92, 9.06; at 1e-4 it rises to 19.50 by step 3, as adamw
# does at full width without warm-up, and adamw8bit's codec adds a rise
# of its own on the card and the CPU alike:
# `scripts/train_full_width_witness.py`, PERF.md §6)
TRAIN_SMALL = dict(steps=5, batch=4, seq=64, lr=1e-3)
TRAIN_SMALL_BOUNDS = {"loss": 0.228, "params max": 21.8}
TRAIN_FAULTS = ("clip skipped", "block left unencoded")
TRAIN_LOCKSTEP_BOUNDS = {"params off": 0.154, "codes off": 0.0273}
TRAIN_FULL = ["--arch", "llama31-8b", "--opt", "adamw8bit", "--lr", "3e-5",
              "--steps", "4", "--batch", "2", "--seq", "512",
              "--log-every", "1", "--seed", "0"]
FLEET_F64_PER_ROUND = 31
FLEET_CHAIN = {"other": 17, "quotients": 2}
# a one-thread probe of the float64 latencies the chain is made of
FP64_PROBE = r"""
#include <cuda_runtime.h>
__global__ void chain(double* out, double x, double y, int n, int divide) {
  double a = x;
  if (divide) {
#pragma unroll 16
    for (int i = 0; i < n; ++i) a = __ddiv_rn(a, y);
  } else {
#pragma unroll 16
    for (int i = 0; i < n; ++i) a = __dadd_rn(a, y);
  }
  *out = a;
}
extern "C" int fp64_chain(void* out, double x, double y, int n, int divide,
                          void* stream) {
  chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), x, y, n, divide);
  return static_cast<int>(cudaGetLastError());
}
"""


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def sass_counts(lib_path: str) -> dict:
    """Counts of tensor-core, TMA-load, mbarrier and float64 instructions
    in a library's SASS, from the toolkit's `cuobjdump` beside `nvcc`."""
    from repro_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    ops = []
    for line in sass.splitlines():      # /*0070*/  [@P0] OPCODE.mods ... ;
        words = line.split("*/", 1)[-1].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            ops.append(words[0])
    return {k: sum(o.startswith(k) for o in ops)
            for k in ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "SYNCS",
                      "LDGSTS", "LDSM", "MUFU.EX2", "MUFU.RCP64H", "DFMA",
                      "DMUL", "DADD", "FFMA", "I2F")}


def device_ms(fn, arg_sets, per_graph=20, replays=5) -> float:
    """Device time of one call: `per_graph` calls (cycling over
    `arg_sets`, so their data does not all sit in L2) captured in a CUDA
    graph, replayed `replays` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(per_graph):
            fn(*arg_sets[i % len(arg_sets)])
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (replays * per_graph)
    del g
    return ms


def bound(nbytes: float, ops: float, peak: float = BF16_PEAK):
    t_bytes, t_ops = nbytes / MEM_BW * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def hold(name, pairs, faulty, fault_ref, gate_fn=None):
    """Gate each (kernel, plain) pair; then require that the gate rejects
    `faulty`, the kernel's output on inputs that drop a little of the work
    that `fault_ref` covers (no fault check where `faulty` is None). The
    gate is `bf16_gate` unless `gate_fn`."""
    from repro_torch.kernels import bf16_gate
    gate_fn = gate_fn or bf16_gate
    err = max(max_abs(o, r) for o, r in pairs)
    gate = max(gate_fn(o, r) for o, r in pairs)
    if not gate <= 1:
        fail(f"{name} disagrees with its plain version: max abs {err}, "
             f"gate {gate} > 1")
    if faulty is None:
        return err, gate, None
    fault = {"max_abs": max_abs(faulty, fault_ref),
             "gate": gate_fn(faulty, fault_ref)}
    if not fault["gate"] > 1:
        fail(f"{name}: the gate accepts a planted fault: {fault}")
    return err, gate, fault


def paged_bound(q, bt, lens, hkv):
    """The least time of a paged-attention call: K and V of every valid
    position once, and for a seq_len-0 row V of each distinct page its row
    gathers once (it reads no K: its scores are all 0); q, the output, the
    block tables and the lengths; 4 FLOPs a valid position per query head
    and dimension, 2 for an idle row's positions."""
    _, hq, d = q.shape
    n_tok = int(lens.sum())
    idle = (lens == 0).nonzero().flatten()
    idle_pages = int(torch.unique(bt[idle]).numel()) if len(idle) else 0
    nbytes = ((2 * n_tok + idle_pages * PAGE) * hkv * d * 2
              + 2 * q.numel() * 2 + bt.numel() * 4 + lens.numel() * 4)
    flops = (4 * n_tok + 2 * len(idle) * bt.shape[1] * PAGE) * hq * d
    return bound(nbytes, flops)


def mean_v(vp, bt_row, hq):
    """What a seq_len-0 row gets: the mean of V over every position its
    block-table row gathers, fp32, for each of the hq query heads."""
    _, _, hkv, d = vp.shape
    m = vp[bt_row.long()].float().reshape(-1, hkv, d).mean(0)
    return m.repeat_interleave(hq // hkv, dim=0)


def check_paged(gen, arch):
    from repro_torch.kernels import bf16_gate
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    dev, (hq, hkv, d) = "cuda", heads(arch)
    P = B * MAXP + 1
    # ragged: empty, one token, exact page boundaries, the full 768
    lens = torch.tensor([0, 1, 16, 17, 256, 512, 700, 768], dtype=torch.int32,
                        device=dev)
    bt = (torch.randperm(P - 1, generator=gen, device=dev)[:B * MAXP] + 1) \
        .to(torch.int32).reshape(B, MAXP)
    q = torch.randn(B, hq, d, generator=gen, device=dev).bfloat16()
    pools = [(torch.randn(P, PAGE, hkv, d, generator=gen, device=dev)
              .bfloat16(),
              torch.randn(P, PAGE, hkv, d, generator=gen, device=dev)
              .bfloat16()) for _ in range(4)]
    # a served decode step: 8 slots of 520-768 tokens, and the same with
    # slots 0-3 idle as the engine leaves them (seq_len 0, rows of 0s)
    served = torch.tensor(SERVED_LENS, dtype=torch.int32, device=dev)
    idle_lens = served.clone()
    idle_lens[:4] = 0
    idle_bt = bt.clone()
    idle_bt[:4] = 0
    cases = [(bt, lens), (bt, served), (idle_bt, idle_lens)]
    pairs = []
    for kp, vp in pools[:2]:
        for t, n in cases:
            out = paged_attention_kernel(q, kp, vp, t, n)
            torch.cuda.synchronize()
            pairs.append((out, paged_attention_ref(q, kp, vp, t, n)))
            for b in (n == 0).nonzero().flatten().tolist():
                g = bf16_gate(out[b], mean_v(vp, t[b], hq))
                if not g <= 1:
                    fail(f"paged attention ({arch}): seq_len 0 in row {b} is "
                         f"not the mean of V over its row: gate {g}")
    # planted fault: the 768-token row without its last page, as a loop
    # bound off by one page would give
    short = lens.clone()
    short[-1] -= PAGE
    kp, vp = pools[1]
    err, gate, fault = hold(f"paged attention ({arch})", pairs,
                            paged_attention_kernel(q, kp, vp, bt, short),
                            pairs[len(cases)][1])
    b_ms, b_by = paged_bound(q, bt, lens, hkv)
    mixes = {}
    for name, (t, n) in (("served", cases[1]), ("served, slots 0-3 idle",
                                                 cases[2])):
        m_args = [(q, kp, vp, t, n) for kp, vp in pools]
        m_ms = device_ms(paged_attention_kernel, m_args)
        m_b_ms, m_b_by = paged_bound(q, t, n, hkv)
        mixes[name] = {"seq_lens": n.tolist(), "ms": m_ms,
                       "plain_ms": device_ms(paged_attention_ref, m_args),
                       "bound_ms": m_b_ms, "bound_by": m_b_by,
                       "share_of_bound": m_b_ms / m_ms}
    args = [(q, kp, vp, bt, lens) for kp, vp in pools]
    ms = device_ms(paged_attention_kernel, args)
    return {
        "max_abs_err": err, "gate": gate, "fault": fault,
        "fault_desc": "the 768-token row's last page dropped",
        "ms": ms,
        "plain_ms": device_ms(paged_attention_ref, args),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "share_of_bound": b_ms / ms, "served_mixes": mixes,
        "shape": f"{arch}: B={B} Hq={hq} Hkv={hkv} D={d} page={PAGE} "
                 f"max_pages={MAXP} seq_lens={lens.tolist()}",
        "instantiation": {"head_dim": d, "group": hq // hkv},
    }


def check_flash(gen, arch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels import bf16_gate
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    dev, (hq, hkv, d) = "cuda", heads(arch)
    pairs = []
    sets = {}
    for L in (512, 576):   # 576: a multiple of 64, not of 128
        sets[L] = [tuple(torch.randn(B, L, h, d, generator=gen, device=dev)
                         .bfloat16() for h in (hq, hkv, hkv))
                   for _ in range(2)]
        for q, k, v in sets[L]:
            out = flash_attention_kernel(q, k, v, causal=True)
            torch.cuda.synchronize()
            pairs.append((out, flash_attention_ref(q, k, v, causal=True)))
    # the prefill's padding mask: ragged prompt lengths, and 0 for a slot
    # that does not prefill (the mean of V over all keys)
    kv_len = torch.tensor([512, 0, 1, 63, 64, 300, 511, 37],
                          dtype=torch.int32, device=dev)
    q, k, v = sets[512][1]
    out = flash_attention_kernel(q, k, v, causal=True, kv_len=kv_len)
    torch.cuda.synchronize()
    pairs.append((out, flash_attention_ref(q, k, v, causal=True,
                                           kv_len=kv_len)))
    L = 512                # the served prompt length, chat 512:256
    # planted fault: the last 64-key tile dropped, as a tile count off by
    # one would give; it changes only the last 64 query rows
    q, k, v = sets[L][0]
    err, gate, fault = hold(
        f"flash attention ({arch})", pairs,
        flash_attention_kernel(q, k[:, :-64].contiguous(),
                               v[:, :-64].contiguous(), causal=True),
        pairs[0][1])
    args = sets[L]
    lib_args = [tuple(t.transpose(1, 2).contiguous() for t in a)
                for a in args]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    nbytes = 2 * (2 * B * L * hq * d + 2 * B * L * hkv * d)
    flops = 4 * B * hq * L * L * d / 2
    b_ms, b_by = bound(nbytes, flops)
    # what a served prefill call passes: the slots that prefill have their
    # prompt (here all 512 tokens), the others kv_len 0 (the mean of V);
    # the least work is q, K and the causal product for the prefilling
    # slots, V and the output for all
    n_pre = B // 2
    mix = torch.tensor([L] * n_pre + [0] * (B - n_pre), dtype=torch.int32,
                       device=dev)
    mix_bytes = 2 * (n_pre * L * hq * d + B * L * hq * d + n_pre * L * hkv * d
                     + B * L * hkv * d) + 4 * B
    mix_flops = 4 * n_pre * hq * L * L * d / 2
    mix_b_ms, mix_b_by = bound(mix_bytes, mix_flops)
    ms = device_ms(lambda q, k, v: flash_attention_kernel(
        q, k, v, causal=True), args)
    lib_ms = device_ms(sdpa, lib_args)
    # the yardstick held to the kernel's gate, for the record only: SDPA
    # rounds P to bf16 before P V
    lib_gate = bf16_gate(sdpa(*lib_args[0]).transpose(1, 2), pairs[0][1])
    mix_ms = device_ms(lambda q, k, v: flash_attention_kernel(
        q, k, v, causal=True, kv_len=mix), args)
    return {
        "max_abs_err": err, "gate": gate, "fault": fault,
        "fault_desc": "the last 64-key tile of Lp 512 dropped",
        "ms": ms,
        "plain_ms": device_ms(lambda q, k, v: flash_attention_ref(
            q, k, v, causal=True), args, per_graph=4),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
        # the algorithm's FLOPs over the kernel's time (the kernel also
        # runs a second, low-order bf16 term of P through the tensor cores)
        "tflops": flops / ms * 1e-9, "share_of_bound": b_ms / ms,
        "x_library": ms / lib_ms, "library_gate": lib_gate,
        "served_mix": {
            "kv_len": mix.tolist(), "ms": mix_ms,
            "bound_ms": mix_b_ms, "bound_by": mix_b_by,
            "share_of_bound": mix_b_ms / mix_ms,
            "tflops": mix_flops / mix_ms * 1e-9},
        "shape": f"{arch}: B={B} Sq=Sk={L} Hq={hq} Hkv={hkv} D={d} causal "
                 f"(checked also at Sq=Sk=576 and with kv_len "
                 f"{kv_len.tolist()})",
        "instantiation": {"head_dim": d, "group": hq // hkv},
    }


def check_flash_bidirectional(gen):
    """Flash at whisper-base's shapes (8 heads of 64 on 8 KV heads, 8
    slots), two instantiations, each within `bf16_gate` of the plain
    version and timed beside SDPA. Without a mask at 1500 frames (23 key
    tiles of 64 and one of 28): the encoder's self-attention (Sq = Sk =
    1500), the decoder's cross-attention over the frames (Sq = the
    prompt, 440) and one decode row; the planted fault drops the last key
    tile (the 28 keys past 1472), which every row reads. Causal at the
    decoder's prompt (Sq = Sk = 440: 6 key tiles of 64 and one of 56);
    the planted fault drops that last 56-key tile, which the last 56
    query rows read."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    dev, (hq, hkv, d) = "cuda", heads("whisper-base")
    Bw, Se, S = WHISPER["batch"], WHISPER["frames"], WHISPER["prompt"]
    mk = lambda S, h: torch.randn(Bw, S, h, d, generator=gen,
                                  device=dev).bfloat16()
    variants = []
    for causal, L in ((False, Se), (True, S)):
        sets = [(mk(L, hq), mk(L, hkv), mk(L, hkv)) for _ in range(2)]
        pairs = []
        for Sq in ((Se, S, 1) if not causal else (S,)):
            q, k, v = sets[0][0][:, :Sq].contiguous(), sets[0][1], \
                sets[0][2]
            out = flash_attention_kernel(q, k, v, causal=causal)
            torch.cuda.synchronize()
            pairs.append((out, flash_attention_ref(q, k, v, causal=causal)))
        if causal:      # the second set too: the timed inputs
            q, k, v = sets[1]
            out = flash_attention_kernel(q, k, v, causal=True)
            torch.cuda.synchronize()
            pairs.append((out, flash_attention_ref(q, k, v, causal=True)))
        q, k, v = sets[0]
        last = (L - 1) // 64 * 64
        what = "no mask" if not causal else "causal"
        err, gate, fault = hold(
            f"flash attention (whisper-base, {what})", pairs,
            flash_attention_kernel(q, k[:, :last].contiguous(),
                                   v[:, :last].contiguous(), causal=causal),
            pairs[0][1])
        share = 0.5 if causal else 1.0
        nbytes = 2 * (2 * Bw * L * hq * d + 2 * Bw * L * hkv * d)
        flops = 4 * Bw * hq * L * L * d * share
        b_ms, b_by = bound(nbytes, flops)
        ms = device_ms(lambda q, k, v: flash_attention_kernel(
            q, k, v, causal=causal), sets)
        lib_args = [tuple(t.transpose(1, 2).contiguous() for t in a)
                    for a in sets]
        lib_ms = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), lib_args)
        also = (f" (checked also at Sq={S} and 1)" if not causal else
                " (the decoder's prompt)")
        variants.append({
            "max_abs_err": err, "gate": gate, "fault": fault,
            "fault_desc": f"the last key tile dropped ({L} keys run as "
                          f"{last})",
            "ms": ms,
            "plain_ms": device_ms(lambda q, k, v: flash_attention_ref(
                q, k, v, causal=causal), sets, per_graph=2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library_note": f"SDPA, {what}",
            "tflops": flops / ms * 1e-9, "share_of_bound": b_ms / ms,
            "x_library": ms / lib_ms,
            "shape": f"whisper-base: B={Bw} Sq=Sk={L} Hq={hq} Hkv={hkv} "
                     f"D={d} {what}{also}",
            "instantiation": {"head_dim": d, "group": hq // hkv,
                              "causal": causal, "path": "whisper-base"},
        })
        del sets, pairs, lib_args
    return variants


def ssm_inputs(gen, Bsz, S, di, N, with_h0):
    """Unit-normal u, B, C, D and h0, dt = softplus(unit normal) and the
    model's A = -(1..N) per channel, all fp32 on the card."""
    import torch.nn.functional as F
    dev = "cuda"
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev) \
        .expand(di, N).contiguous()
    return (r(Bsz, S, di), F.softplus(r(Bsz, S, di)), r(Bsz, S, N),
            r(Bsz, S, N), A, r(di), r(Bsz, di, N) if with_h0 else None)


def check_ssm(gen):
    """The selective scan against its plain version at jamba-v0.1-52b's
    served prefill and decode shapes, y and h_final each through
    `fp32_gate`; a planted fault must fail it: at decode the step run with
    h0 read as zeros, as a scan that drops the carried state would; at
    prefill h_final of the scan run without its last chunk of time steps
    (the kernel's own chunk length), as one that drops the last ring stage
    would. The prefill grid must fit the card in one wave: every block runs
    the whole sequence, so a second wave would double the time.
    Timed at both shapes; the plain version at prefill is a 512-step
    Python loop, captured whole in the CUDA graph like any other call."""
    from repro_torch.kernels import fp32_gate
    from repro_torch.kernels.ssm_scan.kernel import layout, ssm_scan_kernel
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    lay = layout(16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk = lay["chunk"]
    variants = []
    for Bsz, S, di, N, what in SSM_SHAPES:
        decode = what == "decode"
        sets = [ssm_inputs(gen, Bsz, S, di, N, decode) for _ in range(2)]
        pairs = []
        for args in sets:
            y, h = ssm_scan_kernel(*args)
            torch.cuda.synchronize()
            yr, hr = ssm_scan_ref(*args)
            pairs += [(y, yr), (h, hr)]
        if decode:      # y of the step with the carried state dropped
            faulty, fault_ref = ssm_scan_kernel(*sets[0][:-1], None)[0], \
                pairs[0][1]
        else:           # h_final with the last chunk dropped
            u, dt, Bm, Cm = (t[:, :-chunk].contiguous()
                             for t in sets[0][:4])
            faulty, fault_ref = ssm_scan_kernel(u, dt, Bm, Cm,
                                                *sets[0][4:])[1], pairs[1][1]
        err, gate, fault = hold(f"ssm_scan ({what})", pairs, faulty,
                                fault_ref, gate_fn=fp32_gate)
        # u, dt and y once each; B and C; A and D; h0 where read, h_final
        elems = Bsz * S * di
        nbytes = 4 * (3 * elems + 2 * Bsz * S * N + di * N + di
                      + Bsz * di * N * (2 if decode else 1))
        flops = elems * (6 * N + 3)
        terms = {"bytes": nbytes / MEM_BW * 1e3,
                 "fp32 operations": flops / FP32_PEAK * 1e3,
                 "exponentials": elems * N / EXP_RATE * 1e3}
        term = max(terms, key=terms.get)
        if not decode:
            blocks = -(-di // lay["channels_per_block"]) * Bsz
            grid = dict(lay, blocks=blocks, sms=sms, waves=-(
                -blocks // (lay["resident_blocks_per_sm"] * sms)))
            print(f"kernel ssm_scan ({what}): {grid}", flush=True)
            if grid["waves"] != 1:
                fail(f"ssm_scan's prefill grid needs {grid['waves']} waves "
                     f"at {Bsz} x {di}: {grid}")
        variants.append({
            "max_abs_err": err, "gate": gate, "fault": fault,
            "fault_desc": ("the decode step run with h0 read as zeros"
                           if decode else "h_final of the prefill run "
                           f"without its last {chunk} steps (one chunk)"),
            "ms": device_ms(ssm_scan_kernel, sets),
            "plain_ms": device_ms(ssm_scan_ref, sets,
                                  per_graph=2 if S > 1 else 20,
                                  replays=3 if S > 1 else 5),
            "bound_ms": terms[term],
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_terms_ms": terms,
            "library_ms": None,
            "library_note": "none: no single PyTorch call computes a "
                            "selective scan",
            "shape": f"jamba-v0.1-52b {what}: B={Bsz} S={S} d_inner={di} "
                     f"N={N}" + (", random h0" if decode else ", h0 zero"),
        })
        del sets, pairs
        torch.cuda.empty_cache()
    return variants


def int_mm(x, w, xs, ws):
    """The yardstick: `torch._int_mm` followed by the same scaling."""
    return torch._int_mm(x, w).float() * (xs * ws)


def int_mm_rows(x):
    """cuBLASLt's int8 GEMM refuses M <= 16: x padded with zero rows to
    M = 17, the smallest it takes."""
    M = x.shape[0]
    return x if M > 16 else torch.cat([x, x.new_zeros(17 - M, x.shape[1])])


def _int_mm_operands(x, w, xs, ws, Kp, Np):
    """`int_mm`'s operands for an (M, K) x (K, N) product: x with zero
    rows to M = 17 where M <= 16; at a K or N past the true ones (Kp, Np)
    copies of x, w (K-major) and ws zero-padded to them."""
    (M, K), N = x.shape, w.shape[1]
    if (Kp, Np) != (K, N):
        xp = x.new_zeros(M, Kp)
        xp[:, :K] = x
        wp = w.new_zeros(Np, Kp)
        wp[:N, :K] = w.mT
        wsp = ws.new_zeros(1, Np)
        wsp[:, :N] = ws
        x, w, ws = xp, wp.mT, wsp
    return int_mm_rows(x), w, xs, ws


def check_int8(gen):
    """The int8 kernel bit for bit against its plain version at every
    served shape, on weights stored K-major as the model stores them (rows
    padded to a multiple of 16 bytes where K is not one, the activation's
    rows too, the padding filled with random codes that must not be
    read); a planted fault (the last 128-wide K tile dropped, or at a K
    that is no multiple of 16 its ragged tail: K 1365 run as 1360) must
    change more than 90% of the outputs. Timed at every shape, beside
    `torch._int_mm` on the same K-major weight and on a row-major copy
    (at a K or N that is no multiple of 8, on zero-padded copies)."""
    from repro_torch.kernels.int8_matmul.kernel import (
        ROW_BYTES, int8_matmul_kernel, padded)
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    dev = "cuda"
    variants = []
    for M, K, N, what in INT8_SHAPES:
        # enough weight sets that cycling over them overflows the 50 MB L2,
        # as a decode step's weights, each read once, do
        n_sets = max(2, min(6, -(-120_000_000 // (K * N))))
        ld = padded(K, ROW_BYTES)
        sets = []
        for _ in range(n_sets):
            sets.append((
                torch.randint(-127, 128, (M, ld), generator=gen, device=dev,
                              dtype=torch.int8)[:, :K],
                # (K, N) stored K-major: the .mT of the first K columns of
                # a contiguous (N, ld)
                torch.randint(-127, 128, (N, ld), generator=gen, device=dev,
                              dtype=torch.int8)[:, :K].mT,
                torch.rand(1, generator=gen, device=dev) * 0.02 + 1e-3,
                torch.rand(1, N, generator=gen, device=dev) * 0.02 + 1e-3))
        x, w, xs, ws = sets[0]
        out = int8_matmul_kernel(x, w, xs, ws)
        torch.cuda.synchronize()
        ref = int8_matmul_ref(x, w, xs, ws)
        if not torch.equal(out, ref):
            fail(f"int8 matmul at {(M, K, N)} is not bit-exact: "
                 f"{int((out != ref).sum())} elements differ, max abs "
                 f"{max_abs(out, ref)}")
        tail = K % ROW_BYTES or 128
        faulty = int8_matmul_kernel(x[:, :K - tail], w[:K - tail], xs, ws)
        n_bad = int((faulty != ref).sum())
        if not n_bad > 0.9 * M * N:
            fail(f"int8 matmul at {(M, K, N)}: the planted fault changed "
                 f"only {n_bad} of {M * N} outputs")
        nbytes = M * K + K * N + 4 + 4 * N + 4 * M * N
        ops = 2 * M * N * K
        b_ms, b_by = bound(nbytes, ops, INT8_PEAK)
        del out, ref, faulty
        ms = device_ms(int8_matmul_kernel, sets)
        # torch._int_mm takes K and N multiples of 8 only: at another K or
        # N it runs on copies zero-padded to multiples of 16 bytes (K to
        # the model's row stride `ld`), whose zero codes add nothing
        Kp, Np = (K, N) if not (K % 8 or N % 8) else (
            ld, padded(N, ROW_BYTES))
        lib_sets = [_int_mm_operands(*a, Kp, Np) for a in sets]
        lib_ms = device_ms(int_mm, lib_sets)
        row_sets = [(a[0], a[1].contiguous()) + a[2:] for a in lib_sets]
        lib_row_ms = device_ms(int_mm, row_sets)
        del row_sets, lib_sets
        note = ("torch._int_mm + scaling on the K-major weight (on a "
                f"row-major copy: {lib_row_ms:.4f} ms)" + (
                    "" if M > 16 else f", x padded from M={M} to M=17") + (
                    "" if (Kp, Np) == (K, N) else
                    f", K and N zero-padded from {K}, {N} to {Kp}, {Np}"))
        variants.append({
            "max_abs_err": 0.0, "fault": {
                "elements_differing": n_bad, "of": M * N},
            "fault_desc": (f"the ragged K tail dropped ({K} run as "
                           f"{K - tail})" if K % ROW_BYTES
                           else "the last 128-wide K tile dropped"),
            "ms": ms,
            "plain_ms": device_ms(int8_matmul_ref, sets, per_graph=2),
            "bound_ms": b_ms, "bound_by": b_by,
            "tops": ops / ms * 1e-9, "x_bound": ms / b_ms,
            "library_ms": lib_ms, "library_row_major_ms": lib_row_ms,
            "library_note": note,
            "shape": f"{what}: M={M} K={K} N={N}",
        })
        del sets
        torch.cuda.empty_cache()
    return variants


def moe_gemm_shapes():
    """(E, M, K, N, what) of every product `check_moe_gemm` holds."""
    out = []
    for arch, E, d, f, dec, pre in MOE_GEMM_ARCHS:
        for M, when in ((dec, "decode"), (pre, "prefill")):
            out.append((E, M, d, f, f"{arch} {when} up/gate"))
            out.append((E, M, f, d, f"{arch} {when} down"))
    return out


def moe_gemm_bound(E, M, K, N):
    """(ops, bytes) of one launch: int8 weights and fp32 scales read once,
    the bf16 rows in and out once."""
    return 2 * E * M * K * N, E * K * N + 4 * E * N + 2 * E * M * (K + N)


def one_hot_rows(E, K, ks, device):
    """x (E, len(ks), K) bf16 whose row m is 1 at k = ks[m]: the product
    with it is the weight's k-rows ks, exactly (one fp32 term a sum)."""
    x = torch.zeros(E, len(ks), K, dtype=torch.bfloat16, device=device)
    x[:, torch.arange(len(ks)), torch.as_tensor(ks)] = 1
    return x


def check_moe_gemm(gen):
    """The int8 experts' grouped GEMM against its plain version (the
    einsum on `quant.dequantize`'s bf16 weights) at every MoE
    configuration's decode and prefill expert shapes, by `bf16_gate`; its
    weights bit for bit against `dequantize` (one-hot rows of x read
    k-rows of the weight: at decode 8 rows at spread k, at prefill every
    k of the first two experts), also with codes at +-127, 0 and +-1 and
    scales over 1e-10 to 1e4; two planted faults must fail the gate: the
    last 64-deep K tile dropped, and expert 0's scale row shifted by one
    column. Timed beside its bound, the plain version and the yardstick:
    the bf16 einsum on weights already dequantized."""
    from repro_torch.kernels import bf16_gate
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm_kernel
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    from repro_torch.quant import dequantize
    dev = "cuda"
    variants = []
    for E, M, K, N, what in moe_gemm_shapes():
        torch.cuda.empty_cache()
        wbytes = E * K * N
        n_sets = max(1, min(4, -(-120_000_000 // wbytes)))
        sets = []
        for _ in range(n_sets):
            sets.append((
                torch.randn(E, M, K, generator=gen, device=dev).bfloat16(),
                torch.randint(-127, 128, (E, K, N), generator=gen,
                              device=dev, dtype=torch.int8),
                torch.rand(E, 1, N, generator=gen, device=dev) * 0.02
                + 1e-4))
        x, q, sc = sets[0]
        out = moe_gemm_kernel(x, q, sc)
        torch.cuda.synchronize()
        ref = moe_gemm_ref(x, q, sc)
        err, gate = max_abs(out, ref), bf16_gate(out, ref)
        if not gate <= 1:
            fail(f"moe_gemm at {what} {(E, M, K, N)} disagrees with its "
                 f"plain version: max abs {err}, gate {gate} > 1")
        del out, ref
        # the weights, bit for bit: one-hot rows at spread k (decode path)
        # or every k of two experts (prefill path)
        wide = M > 64
        ks = (list(range(K)) if wide else
              [(K * i) // 8 + (37 * i) % (K // 8) for i in range(8)])
        Ew = 2 if wide else E
        qx = q[:Ew].clone()
        qx[:, :, :4] = torch.tensor([127, -127, 0, 1], dtype=torch.int8,
                                    device=dev)
        qx[:, :, 4:8] = torch.tensor([-1, 126, -128 + 1, 64],
                                     dtype=torch.int8, device=dev)
        scx = torch.logspace(-10, 4, N, device=dev).reshape(1, 1, N) * (
            1 + torch.rand(Ew, 1, N, generator=gen, device=dev))
        bits = {}
        for name, (qq, ss) in {"codes": (q[:Ew], sc[:Ew]),
                               "extremes": (qx, scx)}.items():
            xo = one_hot_rows(Ew, K, ks, dev)
            got = moe_gemm_kernel(xo, qq.contiguous(), ss.contiguous())
            want = dequantize(qq, ss)[:, ks]
            torch.cuda.synchronize()
            n_off = int((got.view(torch.int16)
                         != want.view(torch.int16)).sum())
            if n_off:
                fail(f"moe_gemm at {what}: {n_off} of {want.numel()} "
                     f"weights ({name}) differ from quant.dequantize's bits")
            bits[name] = want.numel()
            del xo, got, want, qq, ss
        del qx, scx
        # planted faults
        ref = moe_gemm_ref(x, q, sc)
        f_tile = moe_gemm_kernel(x[..., :K - 64].contiguous(),
                                 q[:, :K - 64].contiguous(), sc)
        shifted = sc.clone()
        shifted[0] = torch.roll(sc[0], 1, dims=-1)
        f_scale = moe_gemm_kernel(x, q, shifted)
        faults = {"last K tile dropped": bf16_gate(f_tile, ref),
                  "expert 0's scale row shifted": bf16_gate(f_scale, ref)}
        if not all(g > 1 for g in faults.values()):
            fail(f"moe_gemm at {what}: the gate accepts a planted fault: "
                 f"{faults}")
        del ref, f_tile, f_scale, shifted
        ops, nbytes = moe_gemm_bound(E, M, K, N)
        b_ms, b_by = bound(nbytes, ops)
        ms = device_ms(moe_gemm_kernel, sets)
        torch.cuda.empty_cache()      # the plain version's bf16 copies
        plain_ms = device_ms(moe_gemm_ref, sets[:1], per_graph=1)
        torch.cuda.empty_cache()
        lib_sets = [(a[0], dequantize(a[1], a[2])) for a in sets]
        lib_ms = device_ms(lambda xx, w: torch.einsum("emk,ekn->emn", xx, w),
                           lib_sets)
        del lib_sets
        variants.append({
            "shape": f"{what}: E={E} M={M} K={K} N={N}",
            "max_abs_err": err, "gate": gate, "weights_bit_exact": bits,
            "fault": faults, "fault_desc": "last K tile dropped; expert 0's "
            "scale row shifted by one column",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / ms,
            "tflops": ops / ms * 1e-9, "gb_s": nbytes / ms * 1e-6,
            "library_ms": lib_ms,
            "library_note": "torch.einsum in bf16 on the weights already "
                            "dequantized (reads 2 bytes a weight)",
        })
        del sets, x, q, sc
    return variants


def small_input_check(arch="llama31-8b", quant="bf16"):
    """A narrow model at head_dim 128 (2 layers; jamba-v0.1-52b 8: 7 Mamba
    layers, d_state 4, and one attention layer; xlstm-350m 4: mLSTM, sLSTM,
    mLSTM, sLSTM) through the kernels on the card and through the plain
    versions on the CPU, on the same weights (quantized on the CPU, then
    moved) and tokens. The MoE layers of an arch in `REAL_ROUTING` route as
    the full config does (mixtral-8x7b: 8 experts, top-2, groups of 256;
    granite-moe-1b-a400m: 32 experts, top-8); an arch in `SMALL_HEADS` has
    its full config's head_dim and query heads per KV head.

    In bf16, and in int8 without Mamba or MoE layers: K/V pools within 0.02 (five
    bf16 steps at |K| < 1) and at least 90% of greedy tokens equal (a flip
    needs a near-tie of two logits); jamba's Mamba states too, each within
    5% of its layer's largest magnitude (conv holds bf16 activations, one
    step 2**-8 of the largest; h inherits a few such steps through u, dt,
    B and C). A decode step that drops the carried h or conv state moves
    them by far more.

    jamba in int8: its bf16 MoE GEMMs round differently on the two
    devices, each `linear`'s per-tensor activation quantization turns such
    a difference into a flipped int8 step (1/127 of the tensor's largest
    value), and a router near-tie sends a token elsewhere; on the CPU,
    nudging 1-100% of one side's MoE outputs by one bf16 step left 96-99%
    of K/V and 93-97% of conv elements within 0.02, and 85-96% of tokens
    equal. So, by shares: at least 90% of K/V and 85% of conv elements
    within 0.02, 95% of h elements within 5% of the layer's largest |h|,
    and 80% of greedy tokens equal. The h bound lies between the sound
    readings and the planted fault that only h sees
    (`scripts/small_check_sensitivity.py --arch jamba-v0.1-52b --quant
    int8`, at the geometric mean of their shares outside): an H100 80GB
    HBM3 (700 W) reads 96.92% of h on its own (99.5% of K/V, 92.4% of
    conv, 85% of tokens), and 96.94-100% with its measured roundings
    added as nudges (seeds 0-7); where it parts from the CPU, its router
    parts rows at near ties, most of them pad rows of one prompt, and a
    later Mamba layer carries them into that slot's h. A decode step that
    drops the carried h leaves 91.9% of h on the CPU and 90.2% on the
    card (K/V, conv and tokens do not see it); one that drops the conv
    state 36% of conv and 66-68% of h.

    mixtral-8x7b in int8 (MoE, no Mamba): replayed on the CPU's own
    inputs (`scripts/small_check_sensitivity.py --card`), an H100 rounded
    2.9% of the int8 q/k/v projections' bf16 results one step apart from
    the CPU, 0.15% of wo's, 0.36% of the MoE's and under 0.02% of the
    norms', rope's and attention's, while the int8 scales were formed
    differently on the two devices; with the same scales on both, q/k/v
    and wo are equal and the MoE's 0.40% remains. Layer 0's K/V stayed
    within one bf16 step and layer 1's ended at most 0.054 apart. The
    bounds below keep the noisier calibration. Nudging the CPU's
    operations at those shares ("as an H100 rounds", seeds 0-7) gives
    0.043-0.051 where layer 0 routes every token alike, as it did on the
    card; in 4 of the 8 seeds one or two tokens routed differently or lost
    an expert to the capacity limit, and their layer-1 K/V moved by up to
    1.1. So tokens are held, not elements: at least 95% of the written
    K/V cells (a token's place in the pool) within 0.1 in every layer
    (the card: 100%; the nudges 98.9-100%; every result of every
    operation nudged: 95.7%) and 80% of greedy tokens equal (the nudges
    89-96%). A decode that drops each context's last page leaves 91.4% of
    the cells and 63% of the tokens.

    granite-34b in int8 (48 query heads on one KV head): on the card every
    int8 `linear` equals the CPU's bit for bit, but the norms, rope and
    attention round 0.002-0.007% of their results a bf16 step apart
    (`scripts/small_check_sensitivity.py --card`), and a `linear`'s
    per-tensor activation quantization turns such a step into a flipped
    int8 code: the card's K/V ended 0.0234 apart on 0.01% of layer 1's
    elements, past the 0.02 above, and the CPU's operations nudged at the
    card's shares ("as an H100 rounds", seeds 0-7, on the CPU and on the
    card) 0.030-0.044. So it is held as mixtral-8x7b int8 is (`BY_CELLS`):
    those nudges keep 100% of the cells within 0.1 and 93-100% of the
    tokens (every result of every operation nudged: 98.9% and 93%); a
    decode that drops each context's last page leaves 91.4% and 59%.

    granite-moe-1b-a400m in bf16 (32 experts, top-8, head_dim 64, tied
    embeddings): tokens say nothing, as for xlstm-350m below, so the share
    of written K/V cells within 0.02 in every layer and the last decode
    step's fp32 logits are held (`TIED_BOUNDS`), each bound at the
    geometric mean of the farthest sound reading and the nearest fault
    reading, as jamba int8's h bound: an H100 80GB HBM3 (700 W) read 100%
    and 0.0026 of the logits' largest; the "as an H100 rounds" nudges
    (seeds 0-7, on the CPU and on the card) 99.46-100% and 0.0022-0.0035;
    a decode that drops each context's last page 91.40% and 0.242.

    xlstm-350m in bf16 (`_xlstm_readings`): tokens say nothing there (with
    tied random embeddings greedy decoding repeats each slot's last prompt
    token), so every mLSTM and sLSTM state and the last decode step's fp32
    logits are held instead."""
    cfg, params = small_model(arch, quant)
    sides = drive_small(cfg, quant, params, {"cpu": "cpu", "cuda": "cuda"})
    return small_readings(cfg, quant, sides["cpu"], sides["cuda"])


def small_model(arch, quant):
    """The narrow model of `small_input_check`: (cfg, parameters on the
    CPU, drawn from seed 1 and quantized to `quant`)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    full = get_config(arch)
    cfg = reduced(arch, d_model=512, ff=1024, vocab=1024,
                  layers=4 if full.xlstm is not None else 2)
    if arch in REAL_ROUTING:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, top_k=full.moe.top_k, group_size=full.moe.group_size,
            num_experts=SMALL_EXPERTS.get(arch, full.moe.num_experts)))
    if arch in SMALL_HEADS:
        hq, hkv, d = SMALL_HEADS[arch]
        cfg = dataclasses.replace(cfg, num_heads=hq, num_kv_heads=hkv,
                                  head_dim=d)
    return cfg, init_params(cfg, device="cpu", quant=quant,
                            generator=torch.Generator().manual_seed(1))


def drive_small(cfg, quant, params, devices, before=lambda name: None):
    """Run the step functions on each side of `devices` (name -> device):
    a prefill of 4 slots with prompts of 37, 0, 128 and 5 tokens (seed 0),
    then 8 decode steps, every side fed the first side's tokens;
    `before(name)` runs before each side's call. Returns, per name, its
    pools, token streams, the last call's fp32 logits (read by wrapping
    `models.model.unembed`) and the active mask."""
    import numpy as np
    from repro_torch.models import model as model_lib
    from repro_torch.quant import BY_NAME
    from repro_torch.serving import runner
    sides = {name: dict(params=_tree_map(lambda t: t.to(dev), params),
                        pools=runner.init_pools(cfg, 33, PAGE, 4, device=dev),
                        seq=torch.zeros(4, dtype=torch.int32, device=dev),
                        streams=[], dev=dev)
             for name, dev in devices.items()}
    pre, dec = runner.make_step_fns(cfg, PAGE, qcfg=BY_NAME[quant])
    rng = np.random.default_rng(0)
    lens = np.array([37, 0, 128, 5], np.int32)
    tokens = np.zeros((4, 128), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(0, 1000, n)
    bt = np.arange(1, 33, dtype=np.int32).reshape(4, 8)
    active = lens > 0
    unembed, side = model_lib.unembed, None

    def recording(params, cfg, x, qcfg=None):     # the runner's logits
        out = unembed(params, cfg, x, qcfg)
        side["logits"] = out[:, 0].float().cpu()
        return out

    model_lib.unembed = recording
    try:
        cur = np.zeros(4, np.int32)
        for step in range(9):
            for name, side in sides.items():
                before(name)
                t = lambda a: torch.from_numpy(a).to(side["dev"])
                if step == 0:
                    out, side["seq"] = pre(side["params"], side["pools"],
                                           t(bt), side["seq"], t(tokens),
                                           t(lens), t(active))
                else:
                    out, side["seq"] = dec(side["params"], side["pools"],
                                           t(bt), side["seq"], t(cur),
                                           t(active))
                side["streams"].append(out.cpu().numpy()[active])
            first = next(iter(sides.values()))
            cur[active] = first["streams"][-1]
    finally:
        model_lib.unembed = unembed
    for side in sides.values():
        side["active"] = active
    return sides


def small_readings(cfg, quant, a, b):
    """(readings, ok) of `small_input_check` for two sides of
    `drive_small`, `a` the reference (the CPU)."""
    import numpy as np
    pools = list(zip(a["pools"], b["pools"]))
    agree = float(np.mean(np.concatenate(
        [x == y for x, y in zip(a["streams"], b["streams"])])))
    if cfg.xlstm is not None:
        return _xlstm_readings(pools, a["logits"], b["logits"], a["active"],
                               agree)
    diff = max(float((x[n][1:].float() -
                      y[n][1:].float().cpu()).abs().max())
               for x, y in pools if "k" in x for n in ("k", "v"))
    act = torch.from_numpy(a["active"])
    lc, lg = a["logits"][act], b["logits"][act]
    logits = float((lc - lg).abs().max() / lc.abs().max())
    # the share of elements within a bound: 0.02 for the bf16 activations
    # (K/V past the trash page, conv), 5% of the layer's largest |h| for h;
    # and the Mamba states' largest difference over the layer's largest
    # magnitude, in the worst layer
    counts = {"k": [0, 0], "conv": [0, 0], "h": [0, 0]}
    rel = {"conv": 0.0, "h": 0.0}
    for pa, pb in pools:
        for n, x in pa.items():
            x, y = x.float(), pb[n].float().cpu()
            if n in ("k", "v"):
                x, y = x[1:], y[1:]
            top = max(float(x.abs().max()), 1e-30)
            if n in rel:
                rel[n] = max(rel[n], float((x - y).abs().max()) / top)
            tol = 0.05 * top if n == "h" else 0.02
            c = counts["k" if n == "v" else n]
            c[0] += int(((x - y).abs() <= tol).sum())
            c[1] += x.numel()
    share = {n: ok / tot if tot else 1.0 for n, (ok, tot) in counts.items()}
    readings = {"K/V max diff": diff,
                "Mamba states' max diff over their largest": rel,
                "shares within bounds": share, "greedy tokens equal": agree,
                "last logits' max diff over their largest": logits}
    if cfg.ssm is not None and quant == "int8":
        ok = (share["k"] >= 0.9 and share["conv"] >= 0.85
              and share["h"] >= 0.95 and agree >= 0.8)
    elif quant == "int8" and cfg.name.removesuffix("-reduced") in BY_CELLS:
        tokens = _tokens_within(pools, 0.1)
        readings["tokens' K/V within 0.1"] = tokens
        ok = tokens >= 0.95 and agree >= 0.8
    elif cfg.tie_embeddings:
        # tied random embeddings: greedy decoding repeats each slot's last
        # prompt token, so the K/V cells and the fp32 logits are held
        tokens = _tokens_within(pools, TIED_BOUNDS["K/V"])
        readings[f"tokens' K/V within {TIED_BOUNDS['K/V']}"] = tokens
        ok = (tokens >= TIED_BOUNDS["tokens' K/V"]
              and logits <= TIED_BOUNDS["logits"])
    else:
        ok = (diff <= 0.02 and rel["conv"] <= 0.05 and rel["h"] <= 0.05
              and agree >= 0.9 and logits <= LOGITS_BOUNDS.get(
                  cfg.name.removesuffix("-reduced"), math.inf))
    return readings, ok


# the int8 checks held by tokens, not elements (`small_input_check`): at
# least 95% of the written K/V cells within 0.1 of the reference's in
# every layer, and 80% of greedy tokens equal
BY_CELLS = {"mixtral-8x7b", "granite-34b"}
# bounds of granite-moe-1b-a400m's check in bf16 (tied embeddings, 32
# experts, top-8): the share of written K/V cells within "K/V" of the
# reference's in every layer, and the last decode step's fp32 logits, as
# their largest difference over their largest magnitude
TIED_BOUNDS = {"K/V": 0.02, "tokens' K/V": 0.978, "logits": 0.029}
# the last decode step's fp32 logits, as their largest difference over
# their largest magnitude, held beside K/V and tokens where the check
# holds them: llama4-maverick-400b-a17b in bf16 (top-1 routing over 8
# experts, a shared expert), at the geometric mean of the farthest sound
# reading and the nearest fault reading (`scripts/small_check_sensitivity.py
# --arch llama4-maverick-400b-a17b --quant bf16`, the CPU: every operation
# 0.1% and 1% nudged 0.0066; each context's last page dropped 0.446; an
# H100 80GB HBM3, 700 W, read 0.00655)
LOGITS_BOUNDS = {"llama4-maverick-400b-a17b": 0.054}


def _tokens_within(pools, tol) -> float:
    """The share of written K/V cells (a token's place: page past the
    trash page, offset) whose K and V lie within `tol` of the reference's
    in every attention layer; a cell is written where the reference holds
    a non-zero K in any layer."""
    written, worst = None, None
    for x, y in pools:
        if "k" not in x:
            continue
        for n in ("k", "v"):
            a, b = x[n][1:].float(), y[n][1:].float().cpu()
            d = (a - b).abs().flatten(2).amax(-1)            # (pages, page)
            worst = d if worst is None else torch.maximum(worst, d)
        w = x["k"][1:].flatten(2).ne(0).any(-1)
        written = w if written is None else written | w
    return float((worst[written] <= tol).float().mean())


# bounds of `_xlstm_readings`: each state's largest difference between the
# devices over its largest magnitude, in the worst layer
XLSTM_BOUNDS = {"mLSTM C": 0.02, "mLSTM n": 0.02, "mLSTM m": 0.02,
                "sLSTM c": 0.12, "sLSTM n": 0.16, "sLSTM m": 0.01,
                "sLSTM h": 0.05, "logits": 0.02}


def _xlstm_readings(pools, logits_a, logits_b, active, agree):
    """Every mLSTM (C, n, m) and sLSTM (c, n, m, h) state, as its largest
    difference between the devices over its largest magnitude in the worst
    layer, and the last decode step's fp32 logits of the active slots,
    within `XLSTM_BOUNDS`. On an H100 they read: mLSTM at most 0.0062,
    sLSTM c 0.023, n 0.041, m 0.0022, h 0.0097, logits 0.0078. Replayed
    on the CPU's own inputs (`scripts/small_check_sensitivity.py
    --card`), the card rounds 0.044% of the projections' bf16 results
    one step apart from the CPU. Nudging the CPU's projections and norms
    at the card's shares ("as an H100 rounds", seeds 0-7) reads mLSTM at
    most 0.0089, sLSTM c 0.042-0.048, n 0.066-0.081, m at most 0.0031, h
    0.011-0.020, logits 0.0075-0.0097; each bound is two to three times
    the largest of those. sLSTM's c and n move most: its stabiliser m sums
    the raw forget pre-activation and its recurrence feeds h back through
    `slstm_wr`, so a sparse rounding difference grows over the 128-step
    prompt (nudging 0.1% of the projections, 2.3 times the card's share,
    already moves c by 0.14). A decode that drops the carried mLSTM state
    moves mLSTM C by 0.995 and the logits by 0.71; one that drops the
    sLSTM state moves sLSTM c, n and m by ~1.0, h by 1.45 and the logits
    by 0.18.
    mLSTM's m may be -inf only in a slot whose C and n are all zero, at
    the same places on both sides; no state may hold a NaN."""
    rel, finite = {}, True
    for a, b in pools:
        kind = "mLSTM" if "C" in a else "sLSTM"
        for n, x in a.items():
            y = b[n].cpu()
            fin = torch.isfinite(x)
            finite &= torch.equal(fin, torch.isfinite(y))
            if fin.any():
                rel[f"{kind} {n}"] = max(rel.get(f"{kind} {n}", 0.0), float(
                    (x[fin] - y[fin]).abs().max() / x[fin].abs().max()))
        finite &= (_minus_inf_only_where_idle(a)
                   and _minus_inf_only_where_idle(b))
    act = torch.from_numpy(active)
    lc, lg = logits_a[act], logits_b[act]
    rel["logits"] = float((lc - lg).abs().max() / lc.abs().max())
    ok = finite and all(rel[k] <= v for k, v in XLSTM_BOUNDS.items())
    return {"max diff over the largest": rel,
            "infinities only in idle slots' mLSTM m, alike": finite,
            "greedy tokens equal": agree}, ok


def _minus_inf_only_where_idle(pool) -> bool:
    """No NaN anywhere, and no infinity but mLSTM's m = -inf in a slot
    whose C and n are all zero (a slot that never prefilled)."""
    for name, t in pool.items():
        t = t.float()
        if torch.isnan(t).any():
            return False
        bad = ~torch.isfinite(t)
        if name == "m" and "C" in pool:
            idle = ((pool["C"].flatten(1) == 0).all(1)
                    & (pool["n"].flatten(1) == 0).all(1))
            bad &= ~(torch.isneginf(t) & idle[:, None])
        if bad.any():
            return False
    return True


def layer_counts(cfg):
    """Layers of the whole stack by kind, from `unit_pattern` (the first
    U layers) times the R repeats: attention, Mamba, mLSTM, sLSTM, dense
    MLP, MoE."""
    from repro_torch.models.model import unit_pattern, unit_size
    R = cfg.num_layers // unit_size(cfg)
    n = {"attn": 0, "mamba": 0, "mlstm": 0, "slstm": 0, "mlp": 0, "moe": 0}
    for kind, is_moe in unit_pattern(cfg):
        n[kind] += R
        if is_moe:
            n["moe"] += R
        elif cfg.d_ff:
            n["mlp"] += R
    return n


def int8_launches_per_call(cfg) -> int:
    """`linear` calls of one prefill call or decode step: four projections
    per attention layer (wq, wk, wv, wo) and per Mamba layer (in_proj,
    x_proj, dt_proj, out_proj), six per mLSTM block (up, q, k, v, the
    gates, down) and three per sLSTM block (wx, up, down: its recurrent
    `slstm_wr` is dequantized), the dense MLPs' projections (the MoE
    experts go to `moe_gemm` instead, a MoE layer's shared expert is an
    MLP that reaches it), and the lm_head unless the embeddings are
    tied."""
    n = layer_counts(cfg)
    mlp = 3 if cfg.mlp_kind == "swiglu" else 2
    shared = n["moe"] if cfg.moe is not None and cfg.moe.shared_expert_ff \
        else 0
    return (4 * (n["attn"] + n["mamba"]) + 6 * n["mlstm"] + 3 * n["slstm"]
            + mlp * (n["mlp"] + shared) + (0 if cfg.tie_embeddings else 1))


def moe_gemm_launches_per_call(cfg, quant) -> int:
    """Grouped-GEMM launches of one prefill call or decode step: each MoE
    layer's expert products (up, gate where swiglu, down) when its experts
    are int8; none otherwise."""
    if quant != "int8" or cfg.moe is None:
        return 0
    return (3 if cfg.mlp_kind == "swiglu" else 2) * layer_counts(cfg)["moe"]


def record_steps(ex):
    """Wrap a RealExecutor's `prefill` and `decode` so that each call logs
    its work and the wall time it returns: prefill as (prompt tokens,
    prompts, s), decode as (active slots, their mean context before the
    step, s). Returns the log; the executor's own code is untouched."""
    log = {"prefill": [], "decode": []}
    prefill, decode = ex.prefill, ex.decode

    def logged_prefill(tokens, lens, do_mask, block_tables):
        first, dt = prefill(tokens, lens, do_mask, block_tables)
        log["prefill"].append((int(lens[do_mask].sum()),
                               int(do_mask.sum()), dt))
        return first, dt

    def logged_decode(tokens, active, block_tables):
        ctx = ex.seq_lens.cpu().numpy()[active]
        nxt, dt = decode(tokens, active, block_tables)
        log["decode"].append((int(active.sum()), float(ctx.mean()), dt))
        return nxt, dt

    ex.prefill, ex.decode = logged_prefill, logged_decode
    return log


def moe_spans(params, kernel, quant) -> dict:
    """After the timed serve, with the tracer on: the expert products of
    the first MoE layer (`models.moe._experts` on 3 rows an expert), the
    spans they open and the grouped-GEMM launches they make. Int8 experts
    must open one `moe.gemm` a launch, one a product, and no
    `moe.dequant`; any other expert stack one `moe.dequant` a product and
    no launch."""
    from repro_torch import tracing
    from repro_torch.models import moe as moe_lib
    p = next(lay["moe"] for lay in params["layers"] if "moe" in lay)
    prods = [(p[k], eq) for k, eq in (("experts_up", "egcd,edf->egcf"),
                                      ("experts_gate", "egcd,edf->egcf"),
                                      ("experts_down", "egcf,efd->egcd"))
             if p.get(k) is not None]
    w = prods[0][0]
    w = w["q"] if isinstance(w, dict) else w
    E, d, f = w.shape
    x = {"egcd": torch.zeros(E, 1, 3, d, dtype=torch.bfloat16,
                             device=w.device),
         "egcf": torch.zeros(E, 1, 3, f, dtype=torch.bfloat16,
                             device=w.device)}
    before = kernel.launches
    tracing.drain()
    tracing.enable()
    try:
        for wp, eq in prods:
            moe_lib._experts(x[eq[:4]], wp, eq)
    finally:
        tracing.disable()
    spans = dict(collections.Counter(sp.name for sp in tracing.drain()))
    got = {"moe.gemm": spans.get("moe.gemm", 0),
           "moe.dequant": spans.get("moe.dequant", 0),
           "launches": kernel.launches - before}
    n = len(prods)
    want = ({"moe.gemm": n, "moe.dequant": 0, "launches": n}
            if quant == "int8" else
            {"moe.gemm": 0, "moe.dequant": n, "launches": 0})
    if got != want:
        fail(f"MoE spans of {n} expert products in {quant}: {got}, "
             f"expected {want}")
    return got


def main_path(arch, quant, kernels):
    """Serve 8 chat requests on the full-width `arch` in `quant` (at the
    depth `DEPTH_CUTS` gives it, else its full depth); returns the path's
    readings, its kernels' launch counts and the log of its prefill calls
    and decode steps (`record_steps`). The peak of the card's allocated
    memory is read from the engine's build to the end of its requests."""
    import numpy as np
    from repro_torch.core import chip_hour_price
    from repro_torch.launch.serve import build_engine, real_tier_hw, serve
    from repro_torch.models import model as model_lib
    from repro_torch.serving import ArrivalSpec
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(arch, device="cuda", seed=0, quant=quant,
                       layers=DEPTH_CUTS.get((arch, quant)))
    torch.cuda.synchronize()          # the weights are drawn on the card
    ex = eng.ex
    n_params = _n_weights(ex.params)
    print(f"main path {arch} {quant}: {ex.cfg.num_layers} layers "
          f"{layer_counts(ex.cfg)}, d_model "
          f"{ex.cfg.d_model}, {n_params / 1e9:.2f} B weights in "
          f"{_n_bytes(ex.params) / 2**30:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    spec = ArrivalSpec(**MAIN_SPEC)
    steps = record_steps(ex)
    hw = real_tier_hw("cuda")
    price = chip_hour_price(hw)
    # every call's fp32 logits must be finite (tied random embeddings make
    # xlstm-350m's and granite-moe's tokens say nothing)
    unembed, finite = model_lib.unembed, []

    def checked(*args, **kw):
        out = unembed(*args, **kw)
        finite.append(torch.isfinite(out).all())
        return out

    for k in kernels.values():
        k.launches = 0
    model_lib.unembed = checked
    t0 = time.perf_counter()
    try:
        reqs, meter = serve(eng, spec, price_per_hr=price,
                            log=lambda s: print(s, flush=True))
    finally:
        model_lib.unembed = unembed
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    n, calls = layer_counts(ex.cfg), (ex.n_prefill_calls, ex.n_decode_steps)
    print(f"main path {arch} {quant}: {len(reqs)} requests in {wall:.1f} s "
          f"wall, engine clock {eng.t:.2f} s, {calls[0]} prefill calls, "
          f"{calls[1]} decode steps, launches {launches}, peak memory "
          f"{peak / 2**30:.2f} GiB allocated", flush=True)
    if not all(r.finish_time is not None for r in reqs):
        fail(f"{arch} {quant}: not every request finished")
    want = sum(r.max_new_tokens for r in reqs)
    got = eng.metrics.get("repro:generation_tokens_total")
    if got != want:
        fail(f"{arch} {quant}: generated {got} tokens, expected {want}")
    expect = {"flash_attention": n["attn"] * calls[0],
              "paged_attention": n["attn"] * calls[1],
              "int8_matmul": (int8_launches_per_call(ex.cfg) * sum(calls)
                              if quant == "int8" else 0),
              "ssm_scan": n["mamba"] * sum(calls),
              "moe_gemm": moe_gemm_launches_per_call(ex.cfg, quant)
              * sum(calls)}
    if launches != expect or not all(calls):
        fail(f"{arch} {quant}: launch counts {launches} != {expect} "
             f"({calls[0]} prefill calls, {calls[1]} decode steps)")
    spans = (moe_spans(ex.params, kernels["moe_gemm"], quant)
             if ex.cfg.moe is not None else {})
    if not all(_minus_inf_only_where_idle(p) for p in ex.pools):
        fail(f"{arch} {quant}: non-finite values in the KV pools or the "
             "recurrent states (beyond an idle slot's mLSTM m = -inf)")
    if not (finite and bool(torch.stack(finite).all())):
        fail(f"{arch} {quant}: non-finite fp32 logits")
    out = {
        "arch": arch, "quant": quant, "layers": ex.cfg.num_layers,
        "weights_gib": _n_bytes(ex.params) / 2**30,
        "peak_memory_gib": peak / 2**30, "requests": len(reqs),
        "finished": sum(r.finish_time is not None for r in reqs),
        "output_tokens": int(got), "prefill_calls": calls[0],
        "decode_steps": calls[1], "engine_clock_s": eng.t,
        "tokens_per_s": got / eng.t,
        "ttft_p50_ms": 1e3 * float(np.median([r.ttft for r in reqs])),
        "hw": hw, "price_per_hr": price,
        "usd_per_mtok": meter.summary()["time_weighted_avg"],
        # C_eff is linear in the price
        "usd_per_mtok_at_1usd_hr":
            meter.summary()["time_weighted_avg"] / price,
        "launches": launches, "wall_s": wall, "moe_spans": spans,
    }
    print(f"main path {arch} {quant}: tokens {out['output_tokens']}, "
          f"tokens/s {out['tokens_per_s']:.1f}, TTFT p50 "
          f"{out['ttft_p50_ms']:.1f} ms, meter avg $/MTok "
          f"{out['usd_per_mtok']:.4f} at {hw}'s ${price}/hr "
          f"({out['usd_per_mtok_at_1usd_hr']:.4f} at $1/hr)", flush=True)
    return out, steps


def whisper_path(kernels):
    """The contiguous-cache phase: whisper-base at full width and depth (6
    encoder and 6 decoder layers, d_model 512, 8 heads of 64, vocab 51865,
    tied embeddings; random bf16 weights from seed 0) through
    `models.prefill` over `WHISPER`'s 8 slots of 1500 stubbed audio frames
    and a 440-token prompt, then 8 greedy `models.decode_step`s. The
    kernels' counts are set to 0 before it: flash 18 launches (the
    encoder's 6, the decoder's 6 causal ones and its 6 cross-attentions),
    12 of them without a mask, and no other kernel (decode attends in
    plain PyTorch on the contiguous cache, as the reference). Gates: those
    counts, finite fp32 logits of the vocabulary's width at every call,
    the cache length, finite K/V and cross-attention K/V."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config("whisper-base")
    Bw, Se, S, steps = (WHISPER[k] for k in ("batch", "frames", "prompt",
                                             "steps"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, device="cuda", generator=gen)
    frames = torch.randn(Bw, Se, cfg.d_model, generator=gen,
                         device="cuda").bfloat16()
    tokens = torch.randint(0, cfg.vocab_size, (Bw, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    print(f"contiguous API whisper-base: {cfg.encoder_layers} + "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{_n_weights(params) / 1e9:.3f} B weights in "
          f"{_n_bytes(params) / 2**30:.2f} GiB, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    flash = kernels["flash_attention"]
    for k in kernels.values():
        k.launches = 0
    flash.noncausal_launches = 0
    finite = []
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, {"tokens": tokens,
                                          "frames": frames},
                            max_len=S + steps)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    decode_ms = []
    for _ in range(steps):
        finite.append(torch.isfinite(logits).all())
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        t0 = time.perf_counter()
        logits, cache = decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
        decode_ms.append(1e3 * (time.perf_counter() - t0))
    finite.append(torch.isfinite(logits).all())
    launches = {name: k.launches for name, k in kernels.items()}
    noncausal = flash.noncausal_launches
    peak = torch.cuda.max_memory_allocated()
    L, E = cfg.num_layers, cfg.encoder_layers
    expect = {"flash_attention": E + 2 * L, "paged_attention": 0,
              "int8_matmul": 0, "ssm_scan": 0, "moe_gemm": 0}
    print(f"contiguous API whisper-base: prefill {prefill_ms:.1f} ms, "
          f"decode steps {[round(t, 2) for t in decode_ms]} ms, launches "
          f"{launches} ({noncausal} without a mask), peak memory "
          f"{peak / 2**30:.2f} GiB allocated", flush=True)
    if launches != expect or noncausal != E + L:
        fail(f"whisper-base: launch counts {launches}, {noncausal} without "
             f"a mask, != {expect}, {E + L}")
    if logits.shape != (Bw, 1, cfg.vocab_size) or \
            logits.dtype != torch.float32 or \
            not bool(torch.stack(finite).all()):
        fail(f"whisper-base: logits {tuple(logits.shape)} {logits.dtype}, "
             "or non-finite")
    if not bool((cache["len"] == S + steps).all()) or not all(
            bool(torch.isfinite(t.float()).all())
            for c in cache["layers"] for t in c.values()):
        fail("whisper-base: a wrong cache length or a non-finite cache")
    return {"arch": "whisper-base", "quant": "bf16",
            "layers": {"encoder": E, "decoder": L},
            "weights_gib": _n_bytes(params) / 2**30,
            "peak_memory_gib": peak / 2**30, "batch": Bw, "frames": Se,
            "prompt": S, "decode_steps": steps, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "launches": launches,
            "noncausal_launches": noncausal}


def small_whisper(seed=1):
    """The narrow whisper-base of `small_whisper_check`: (cfg, its
    parameters on the CPU from `seed`, a batch of 4 slots: a 32-token
    prompt and all 1500 frames, from seed 0). d_model 512, ff 1024, vocab
    1024, 2 encoder and 2 decoder layers at its own 8 heads of 64."""
    from repro_torch.configs import reduced
    from repro_torch.models import init_params
    hq, hkv, d = SMALL_HEADS["whisper-base"]
    cfg = dataclasses.replace(
        reduced("whisper-base", d_model=512, ff=1024, vocab=1024, layers=2),
        num_heads=hq, num_kv_heads=hkv, head_dim=d,
        frontend_len=WHISPER["frames"])
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, 1000, (4, 32), generator=g,
                                     dtype=torch.int32),
             "frames": torch.randn(4, cfg.frontend_len, cfg.d_model,
                                   generator=g).bfloat16()}
    return cfg, params, batch


def drive_whisper(cfg, params, batch, devices, before=lambda name: None):
    """`models.prefill` of `batch` then 8 `models.decode_step`s on each
    side of `devices` (name -> device), every side fed the greedy tokens
    of the first; `before(name)` runs before each of a side's calls.
    Returns name -> (last logits, cache) on the side's device."""
    from repro_torch.models import decode_step, prefill
    sides = {}
    for name, dev in devices.items():
        p = _tree_map(lambda t: t.to(dev), params)
        before(name)
        sides[name] = prefill(p, cfg, {k: v.to(dev) for k, v in
                                       batch.items()}, max_len=40) + (p,)
    first = next(iter(devices))
    for _ in range(8):
        tok = sides[first][0][:, -1].argmax(-1).to(torch.int32)[:, None]
        for name, (_, cache, p) in sides.items():
            before(name)
            sides[name] = decode_step(p, cfg, tok.to(devices[name]),
                                      cache) + (p,)
    return {name: (lg, cache) for name, (lg, cache, _) in sides.items()}


# the whisper check's bounds (`scripts/small_check_sensitivity.py --arch
# whisper-base`; H100 80GB HBM3, 700 W; PERF.md): the farthest sound
# reading (the card at weight seeds 1-8, the CPU with every `linear` and
# attention 0.1% or 1% nudged) against the nearest planted fault (flash
# without the last frame tile; decode without the cross-attention). The
# means sit at the geometric mean of the two: K/V 0.0019 / 0.0042, xk/xv
# 0.00060 / 0.00121. The largest K/V difference (0.0156 / 0.0342) and the
# logits (0.0090 / 0.204) keep the tighter bounds of the other bf16
# checks. The largest xk/xv difference is read, not held: one bf16 step
# (0.0156) both when sound and under the frame-tile fault.
WHISPER_BOUNDS = {"K/V": 0.02, "K/V mean": 0.0028, "xk/xv mean": 0.00085,
                  "logits": 0.029}


def whisper_readings(a, b):
    """(readings, passes `WHISPER_BOUNDS`) of two sides of `drive_whisper`:
    the largest and the mean difference of the self-attention K/V and of
    the cross-attention's xk/xv (the largest over the layers), and the
    largest difference of the last fp32 logits over their largest
    magnitude (the tied random embeddings make tokens say nothing)."""
    (la, ca), (lb, cb) = a, b
    d = {n: [(x[n].float().cpu() - y[n].float().cpu()).abs()
             for x, y in zip(ca["layers"], cb["layers"])]
         for n in ("k", "v", "xk", "xv")}
    diff = {n: max(float(t.max()) for t in ts) for n, ts in d.items()}
    mean = {n: max(float(t.mean()) for t in ts) for n, ts in d.items()}
    la, lb = la.float().cpu(), lb.float().cpu()
    logits = float((la - lb).abs().max() / la.abs().max())
    readings = {"max diff": diff, "mean diff": mean,
                "last logits' max diff over their largest": logits}
    ok = (max(diff["k"], diff["v"]) <= WHISPER_BOUNDS["K/V"]
          and max(mean["k"], mean["v"]) <= WHISPER_BOUNDS["K/V mean"]
          and max(mean["xk"], mean["xv"]) <= WHISPER_BOUNDS["xk/xv mean"]
          and logits <= WHISPER_BOUNDS["logits"])
    return readings, ok


def small_whisper_check():
    """`small_whisper` through `drive_whisper` on the card (flash) and on
    the CPU (the plain versions), on the same weights (seed 1), frames
    and tokens, both sides fed the CPU's tokens; held to
    `WHISPER_BOUNDS` by `whisper_readings`."""
    cfg, params, batch = small_whisper()
    sides = drive_whisper(cfg, params, batch, {"cpu": "cpu",
                                               "cuda": "cuda"})
    return whisper_readings(sides["cpu"], sides["cuda"])


def sim_against_real(real, steps):
    """Phase 6, one main path: the same arch, quant, engine and arrivals
    on `SimExecutor` over the step-time model of `SIM_HW`; prints the
    sim's readings beside the real tier's (`real`, `steps` from
    `main_path`) and fails unless every sim request finishes with the
    real tier's token count. Returns the readings."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import chip_hour_price
    from repro_torch.launch.serve import CARD_ENGINE, serve
    from repro_torch.serving import (ArrivalSpec, Engine, EngineConfig,
                                     SimExecutor)
    from repro_torch.simulate import HW_BY_NAME, StepTimeModel
    arch, quant = real["arch"], real["quant"]
    cfg = dataclasses.replace(get_config(arch), num_layers=real["layers"])
    stm = StepTimeModel(cfg, HW_BY_NAME[SIM_HW], quant=quant)
    eng = Engine(EngineConfig(**CARD_ENGINE), SimExecutor(cfg, stm))
    reqs, meter = serve(eng, ArrivalSpec(**MAIN_SPEC),
                        price_per_hr=chip_hour_price(SIM_HW),
                        log=lambda s: None)
    got = eng.metrics.get("repro:generation_tokens_total")
    if not all(r.finish_time is not None for r in reqs):
        fail(f"sim {arch} {quant}: not every request finished")
    if got != real["output_tokens"]:
        fail(f"sim {arch} {quant}: generated {got} tokens, the real tier "
             f"{real['output_tokens']}")
    # the decode steps at the largest batch the path reached (8 slots on
    # the card's main paths)
    batch = max(bs for bs, _, _ in steps["decode"])
    full = [(ctx, dt) for bs, ctx, dt in steps["decode"] if bs == batch]
    out = {
        "arch": arch, "quant": quant, "hw": SIM_HW,
        "sim_tokens_per_s": got / eng.t, "real_tokens_per_s":
            real["tokens_per_s"],
        "sim_ttft_p50_ms": 1e3 * float(np.median([r.ttft for r in reqs])),
        "real_ttft_p50_ms": real["ttft_p50_ms"],
        "sim_engine_clock_s": eng.t,
        "real_engine_clock_s": real["engine_clock_s"],
        "sim_usd_per_mtok": meter.summary()["time_weighted_avg"],
        "real_usd_per_mtok": real["usd_per_mtok"],
        "decode_batch": batch, "decode_steps_at_batch": len(full),
        "decode_ctx": float(np.median([c for c, _ in full])),
        "sim_decode_ms": 1e3 * float(np.median(
            [stm.decode_time(batch, c) for c, _ in full])),
        "real_decode_ms": 1e3 * float(np.median([dt for _, dt in full])),
        "prefill_calls": [(n, k) for n, k, _ in steps["prefill"]],
        "sim_prefill_ms": 1e3 * float(np.median(
            [stm.prefill_time(n, k) for n, k, _ in steps["prefill"]])),
        "real_prefill_ms": 1e3 * float(np.median(
            [dt for _, _, dt in steps["prefill"]])),
    }
    for key in ("tokens_per_s", "ttft_p50_ms", "engine_clock_s",
                "decode_ms", "prefill_ms"):
        out[f"real_over_sim_{key}"] = out[f"real_{key}"] / out[f"sim_{key}"]
    print(f"sim {arch} {quant} on {SIM_HW}: {len(reqs)}/{len(reqs)} "
          f"requests, {got} tokens; tokens/s sim "
          f"{out['sim_tokens_per_s']:.1f} real {out['real_tokens_per_s']:.1f}"
          f" (real/sim {out['real_over_sim_tokens_per_s']:.3f}); TTFT p50 "
          f"sim {out['sim_ttft_p50_ms']:.1f} real "
          f"{out['real_ttft_p50_ms']:.1f} ms "
          f"({out['real_over_sim_ttft_p50_ms']:.3f}); engine clock sim "
          f"{out['sim_engine_clock_s']:.2f} real "
          f"{out['real_engine_clock_s']:.2f} s "
          f"({out['real_over_sim_engine_clock_s']:.3f})", flush=True)
    print(f"sim {arch} {quant} on {SIM_HW}: decode step at {batch} slots, "
          f"median context {out['decode_ctx']:.0f} over {len(full)} steps: "
          f"decode_time {out['sim_decode_ms']:.2f} ms, real wall "
          f"{out['real_decode_ms']:.2f} ms "
          f"({out['real_over_sim_decode_ms']:.3f}); prefill calls "
          f"{out['prefill_calls']}: prefill_time median "
          f"{out['sim_prefill_ms']:.2f} ms, real wall "
          f"{out['real_prefill_ms']:.2f} ms "
          f"({out['real_over_sim_prefill_ms']:.3f})", flush=True)
    return out


def sim_matrix():
    """Phase 6, the paper's matrix: the reference's `paper_h100` grid with
    `hws=(SIM_HW,)`, run serially through the port's `PlanRunner`. Prints
    per (model, quant) C_eff at each lambda, the idle-to-saturation spread
    (max/min C_eff) and the penalty at lambda 1, and per model the fp8
    uplift in saturation tokens/s; fails unless there are 42 records,
    every C_eff is finite and positive, penalty = 1/U to 1e-9 and C_eff
    is non-increasing along each ladder within 5%."""
    import math
    from repro_torch.experiments import PlanRunner
    plan = paper_grid_on_card()
    t0 = time.perf_counter()
    recs = PlanRunner(plan).run(parallel=False, backend="process")
    wall = time.perf_counter() - t0
    if len(recs) != 42:
        fail(f"sim matrix: {len(recs)} records, expected 42")
    groups = {}
    for r in recs:
        if not (math.isfinite(r.c_eff) and r.c_eff > 0):
            fail(f"sim matrix: C_eff {r.c_eff} at {r.model} {r.quant} "
                 f"lambda {r.lam}")
        if not math.isclose(r.penalty, 1.0 / r.util, rel_tol=1e-9):
            fail(f"sim matrix: penalty {r.penalty} != 1/U {1 / r.util} at "
                 f"{r.model} {r.quant} lambda {r.lam}")
        groups.setdefault((r.model, r.quant), []).append(r)
    rows = []
    for (model, quant), g in groups.items():
        g.sort(key=lambda r: r.lam)
        ceffs = [r.c_eff for r in g]
        for a, b in zip(ceffs, ceffs[1:]):
            if b > a * 1.05:
                fail(f"sim matrix: C_eff rises along {model} {quant}'s "
                     f"ladder: {ceffs}")
        row = {"model": model, "quant": quant, "n_chips": g[0].n_chips,
               "price_per_hr": g[0].price_per_hr,
               "c_eff": {f"{r.lam:g}": r.c_eff for r in g},
               "spread": max(ceffs) / min(ceffs),
               "penalty_at_1": g[0].penalty, "theta_max": g[0].theta_max,
               "completed": sum(r.n_completed for r in g),
               "requests": sum(r.n_requests for r in g)}
        rows.append(row)
        print(f"sim matrix {model} {quant} x{row['n_chips']} at "
              f"${row['price_per_hr']}/hr: C_eff $/MTok by lambda "
              + " ".join(f"{k}:{v:.4f}" for k, v in row["c_eff"].items())
              + f"; spread {row['spread']:.2f}x, penalty at lambda 1 "
              f"{row['penalty_at_1']:.2f}, saturation "
              f"{row['theta_max']:.1f} tokens/s, "
              f"{row['completed']}/{row['requests']} requests", flush=True)
    by = {(r["model"], r["quant"]): r for r in rows}
    uplift = {m: by[(m, "fp8")]["theta_max"] / by[(m, "bf16")]["theta_max"]
              - 1.0 for m in PAPER_TRIO}
    print("sim matrix: fp8 uplift in saturation tokens/s: "
          + ", ".join(f"{m} {u:+.1%}" for m, u in uplift.items())
          + f"; {len(recs)} records in {wall:.1f} s", flush=True)
    return {"rows": rows, "fp8_uplift": uplift, "wall_s": wall}, recs


def paper_grid_on_card(ensemble: bool = False):
    """The reference's `paper_h100` grid (experiments/plans.py) on
    `h100-sxm`: 42 cells, `paper` protocol; with `ensemble`, its
    `paper_ensemble` axes instead (16 arrival seeds, `quick` protocol) on
    the same models, quants and chips: 672 cells."""
    from repro_torch.core import LAMBDA_LADDER
    from repro_torch.experiments import GridSpec
    kw = (dict(protocol="quick", seed_offsets=tuple(range(16)))
          if ensemble else dict(protocol="paper"))
    return GridSpec(name="paper_ensemble_on_h100_sxm" if ensemble
                    else "paper_h100_on_h100_sxm", archs=PAPER_TRIO,
                    hws=(SIM_HW,), quants=("bf16", "fp8"),
                    ladder=LAMBDA_LADDER, n_chips_by_arch=PAPER_CHIPS,
                    seed=0, **kw).expand()


def fleet_inputs(cells, device):
    """The fleet loop's packed inputs for plan cells' lanes (every lane of
    these grids rides the loop), as the jit backend packs them."""
    from repro_torch.serving import fleet_jit
    from repro_torch.serving.arrivals import synth_arrays
    from repro_torch.serving.fleet import FleetPoint
    pts = [FleetPoint(engine=c.engine_spec(), arrivals=c.arrival_spec(),
                      warmup=c.warmup, horizon=c.horizon,
                      failure_times=c.failure_times, **c.record_kw())
           for c in cells]
    md, ec, r_arr, cap, *_ = fleet_jit._pack(
        pts, [synth_arrays(p.arrivals) for p in pts])

    def on(d):
        return {k: torch.as_tensor(v, device=device) for k, v in d.items()}
    return on(md), on(ec), torch.as_tensor(r_arr, device=device), cap


def fleet_gate(got, ref):
    """The fleet loop's outputs against its plain version's (the dump
    column of the logs left out): (outputs outside the jit tolerance or,
    for integers, not equal; float entries not bitwise equal; the largest
    absolute difference of a float entry)."""
    from repro_torch.serving.precision import jit_tolerance
    rtol, atol = jit_tolerance()
    bad, inexact, err = [], 0, 0.0
    for k, r in ref.items():
        g, r = got[k].cpu(), r.cpu()
        if r.ndim == 2:
            g, r = g[:, :-1], r[:, :-1]
        if r.dtype == torch.float64:
            inexact += int((g != r).sum())
            err = max(err, float((g - r).abs().max()))
            if not torch.allclose(g, r, rtol=rtol, atol=atol):
                bad.append(k)
        elif not torch.equal(g, r):
            bad.append(k)
    return bad, inexact, err


def fp64_latency_ns() -> dict:
    """ns of one dependent float64 sum and of one dependent float64
    quotient (`__ddiv_rn`) on this card: `FP64_PROBE`, built with the
    kernels' flags under build/, runs one thread through a chain of 2^20
    sums, then one of 2^16 quotients, each launch timed with CUDA events
    after a warm-up launch."""
    import ctypes
    import math
    from repro_torch.kernels import build
    d = build.BUILD_DIR / "fp64_probe"
    d.mkdir(parents=True, exist_ok=True)
    src, lib_path = d / "fp64_chain.cu", d / "libfp64_chain.so"
    src.write_text(FP64_PROBE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, text=True,
                   timeout=300)
    fn = ctypes.CDLL(str(lib_path)).fp64_chain
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty(1, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ns = {}
    for what, y, n, divide in (("sum", 1e-3, 1 << 20, 0),
                               ("quotient", 1.0000001, 1 << 16, 1)):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for timed in (False, True):
            if timed:
                e0.record()
            err = fn(out.data_ptr(), 1.0, y, n, divide, stream)
            if timed:
                e1.record()
            if err:
                fail(f"the float64 latency probe: CUDA error {err}")
        torch.cuda.synchronize()
        if not math.isfinite(float(out.item())):
            fail(f"the float64 latency probe's {what} chain is not finite")
        ns[what] = e0.elapsed_time(e1) * 1e6 / n
    return ns


def check_fleet_loop():
    """Phase 7's kernel check: the fleet loop on the card against its
    plain version on the card, on the packed inputs of phase 6's 42-cell
    grid and of the first 512-lane chunk of its 672-lane ensemble (the
    shapes the jit backend gives it there): every integer output equal,
    every float within the jit tolerance (the count of float entries that
    are not bitwise equal printed); the grid's run with the budget cut
    skipped (the planted fault) must fail that gate. Then at each shape
    the kernel timed (CUDA events around one launch; the median of 3), the
    plain version timed once (a Python loop of small kernels over the
    rounds), and the bound: the larger of the bytes (inputs once, outputs
    once, over 3.35 TB/s) and the float64 operations of the rounds this
    run took (`FLEET_F64_PER_ROUND` each, over 34 TFLOP/s). Beside it the
    serial chain of the longest lane, which neither term sees: its rounds
    times a decode round's dependent chain (`FLEET_CHAIN`), each step at
    the latency `fp64_latency_ns` measures (its quotients at the
    quotient's, the rest at the sum's)."""
    from repro_torch.kernels.fleet_loop.kernel import fleet_loop_kernel
    from repro_torch.kernels.fleet_loop.ref import fleet_loop_ref
    lat = fp64_latency_ns()
    chain_ns = (FLEET_CHAIN["other"] * lat["sum"]
                + FLEET_CHAIN["quotients"] * lat["quotient"])
    print(f"kernel fleet_loop: a dependent float64 sum {lat['sum']:.3f} "
          f"ns, quotient {lat['quotient']:.3f} ns (one-thread probe); a "
          f"decode round's chain {chain_ns:.1f} ns", flush=True)
    shapes = []
    for what, cells in (
            ("paper_h100", paper_grid_on_card().cells),
            ("ensemble chunk 1", paper_grid_on_card(True).cells[:512])):
        md, ec, r_arr, cap = fleet_inputs(cells, "cuda")

        def timed(fn):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fn(md, ec, r_arr, cap)
            e1.record()
            torch.cuda.synchronize()
            return out, e0.elapsed_time(e1)

        got, _ = timed(fleet_loop_kernel)
        ref, plain_ms = timed(fleet_loop_ref)
        bad, inexact, err = fleet_gate(got, ref)
        if bad or got["live"].any() or got["stall"].any():
            fail(f"fleet_loop [{what}] disagrees with its plain version in "
                 f"{bad} (live {int(got['live'].sum())}, stall "
                 f"{int(got['stall'].sum())})")
        fault = ""
        if what == "paper_h100":
            fleet_loop_kernel.skip_budget_cut = True
            try:
                faulty, _ = timed(fleet_loop_kernel)
            finally:
                fleet_loop_kernel.skip_budget_cut = False
            fault_bad, _, fault_err = fleet_gate(faulty, ref)
            if not fault_bad:
                fail("fleet_loop: the gate accepts a planted fault (the "
                     "budget cut skipped)")
            fault = (f"; planted fault (the budget cut skipped): "
                     f"{fault_bad} outside it, max abs {fault_err:.3g} "
                     f"(rejected)")
            del faulty
        ms = sorted(timed(fleet_loop_kernel)[1] for _ in range(3))[1]
        B, W = r_arr.shape
        rounds = got["rounds"]
        nbytes = (18 + 8 + 1) * 8 * B + r_arr.numel() * 8 \
            + 4 * B * W * 8 + (2 + 4 * 8 + 2 * 8) * B
        longest = int(rounds.max())
        terms = {"bytes": nbytes / MEM_BW * 1e3,
                 "fp64 operations": int(rounds.sum()) * FLEET_F64_PER_ROUND
                 / FP64_PEAK * 1e3,
                 "serial chain": longest * chain_ns * 1e-6}
        v = {"shape": f"{what} on {SIM_HW}: {B} lanes ({len(cells)} padded "
                      f"to a power of two), W {W}",
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(terms["bytes"], terms["fp64 operations"]),
             "bound_by": "bytes" if terms["bytes"] >= terms[
                 "fp64 operations"] else "operations",
             "library_ms": None, "bound_terms_ms": terms,
             "inexact_entries": inexact, "rounds_longest_lane": longest,
             "rounds_total": int(rounds.sum()),
             "ns_per_round": ms * 1e6 / longest,
             "x_serial_chain": ms / terms["serial chain"]}
        print(f"kernel fleet_loop [{v['shape']}]: max_abs_err={err:.3g}, "
              f"{inexact} float entries not bitwise equal, within the jit "
              f"tolerance{fault}", flush=True)
        print(f"kernel fleet_loop [{v['shape']}]: ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} library_ms=None bound_ms={v['bound_ms']:.4f} "
              f"({v['bound_by']}; {terms}); longest lane {longest} rounds, "
              f"{v['ns_per_round']:.0f} ns a round, "
              f"{v['x_serial_chain']:.2f}x its serial chain; no PyTorch "
              f"call runs an event loop", flush=True)
        shapes.append(v)
        del md, ec, r_arr, got, ref
        torch.cuda.empty_cache()
    row = {"name": "fleet_loop", "route": "cuda",
           "source": "src/repro_torch/csrc/fleet_loop.cu",
           "replaces": "src/repro/serving/fleet_jit.py:149"}
    row.update(shapes[0])
    row["max_abs_err"] = max(v["max_abs_err"] for v in shapes)
    row["fp64_latency_ns"] = lat
    row["variants"] = shapes
    return row


def hold_records(oracle, got, what):
    """The jit backend's records against the numpy fleet's: every
    non-float field equal, every float within the jit tolerance. Returns
    (float fields, those not bitwise equal)."""
    import math
    from repro_torch.serving.precision import jit_tolerance
    rtol, atol = jit_tolerance()
    if len(oracle) != len(got):
        fail(f"fleet {what}: {len(got)} records, expected {len(oracle)}")
    n_float = inexact = 0
    for a, b in zip(oracle, got):
        for k, va in dataclasses.asdict(a).items():
            vb = getattr(b, k)
            if isinstance(va, float):
                n_float += 1
                inexact += repr(va) != repr(vb)
                ok = (math.isnan(vb) if math.isnan(va) else
                      math.isclose(va, vb, rel_tol=rtol, abs_tol=atol))
            else:
                ok = va == vb
            if not ok:
                fail(f"fleet {what}: {k} of {a.model} {a.quant} lambda "
                     f"{a.lam}: {vb!r}, the numpy fleet {va!r}")
    return n_float, inexact


def _close_tree(a, b, rtol, atol) -> bool:
    import math
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            _close_tree(a[k], b[k], rtol, atol) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(
            _close_tree(x, y, rtol, atol) for x, y in zip(a, b))
    if isinstance(a, float):
        return (math.isnan(b) if math.isnan(a) else
                math.isclose(a, b, rel_tol=rtol, abs_tol=atol))
    return a == b


def fleet_phase(h100_recs):
    """Phase 7, the jit backend's main paths: phase 6's 42-cell grid, then
    its 672-cell ensemble (16 arrival seeds), each through `PlanRunner`
    on the numpy fleet (`"vector"`, serially, timed) and on the card
    (`"jit"`: one launch of the fleet-loop kernel a chunk of at most 512
    lanes). Gates: the vector records equal phase 6's process records
    (`repr`); the jit records hold every integer field exactly and every
    float within the jit tolerance of the vector ones (the count of
    fields not bitwise equal printed); every lane rode the kernel (no
    `JitFallback`, none routed to numpy); launches exactly 1 and 2; the
    ensemble's `analyze.ensemble_bands` of both record sets agree within
    the jit tolerance. Each launch's device time comes from CUDA events
    around it (a wrapper of the kernel in this script)."""
    from repro_torch.experiments import PlanRunner
    from repro_torch.experiments.analyze import ensemble_bands
    from repro_torch.kernels.fleet_loop import ops
    from repro_torch.kernels.fleet_loop.kernel import fleet_loop_kernel
    from repro_torch.serving import fleet_jit
    from repro_torch.serving.precision import jit_tolerance
    launches_log = []
    kernel = ops.fleet_loop_kernel

    def timed_kernel(md, ec, r_arr, cap):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = kernel(md, ec, r_arr, cap)
        e1.record()
        torch.cuda.synchronize()
        launches_log.append({"lanes": int(r_arr.shape[0]),
                             "W": int(r_arr.shape[1]),
                             "ms": e0.elapsed_time(e1),
                             "rounds_longest_lane":
                                 int(out["rounds"].max())})
        return out

    ops.fleet_loop_kernel = timed_kernel
    out = {"launches": {}, "lanes_by_path": {}, "ms_per_launch": {}}
    try:
        for name, plan in (("paper_h100", paper_grid_on_card()),
                           ("ensemble", paper_grid_on_card(True))):
            n = len(plan.cells)
            t0 = time.perf_counter()
            vector = PlanRunner(plan).run(parallel=False, backend="vector")
            vector_s = time.perf_counter() - t0
            if name == "paper_h100":
                bad = [i for i, (a, b) in enumerate(zip(h100_recs, vector))
                       if repr(a) != repr(b)]
                if len(vector) != len(h100_recs) or bad:
                    fail(f"fleet: vector records differ from phase 6's "
                         f"process records at {bad}")
            del launches_log[:]
            lanes0 = dict(fleet_jit.LANES)
            fleet_loop_kernel.launches = 0
            t0 = time.perf_counter()
            jit = PlanRunner(plan).run(parallel=False, backend="jit")
            jit_s = time.perf_counter() - t0
            launches = fleet_loop_kernel.launches
            lanes = {k: fleet_jit.LANES[k] - lanes0[k] for k in lanes0}
            want = -(-n // 512)
            if lanes != {"loop": n, "fallback": 0, "numpy": 0} or \
                    launches != want:
                fail(f"fleet {name}: lanes {lanes} and {launches} "
                     f"launches; expected every one of {n} lanes on the "
                     f"kernel in {want} launch(es)")
            n_float, inexact = hold_records(vector, jit, name)
            row = {"cells": n, "vector_s": vector_s, "jit_s": jit_s,
                   "float_fields": n_float, "inexact_fields": inexact,
                   "launches": list(launches_log)}
            if name == "ensemble":
                bv, bj = ensemble_bands(vector), ensemble_bands(jit)
                if not bv or not _close_tree(bv, bj, *jit_tolerance()):
                    fail("fleet ensemble: the jit records' ensemble bands "
                         "differ from the numpy fleet's")
                row["bands"] = len(bv)
                row["widest_c_eff_halfwidth"] = max(
                    r["max_rel_halfwidth_c_eff"] for r in bv)
            out[name] = row
            out["launches"][name] = launches
            out["lanes_by_path"][name] = n
            out["ms_per_launch"][name] = [x["ms"] for x in launches_log]
            longest = max(x["rounds_longest_lane"] for x in launches_log)
            ns_round = max(x["ms"] for x in launches_log) * 1e6 / longest
            print(f"fleet {name}: {n} cells; vector {vector_s:.3f} s, jit "
                  f"{jit_s:.3f} s ({launches} launch(es): "
                  + ", ".join(f"{x['lanes']} lanes W {x['W']} "
                              f"{x['ms']:.3f} ms, longest lane "
                              f"{x['rounds_longest_lane']} rounds"
                              for x in launches_log)
                  + f"; {ns_round:.0f} ns a round); {inexact} of {n_float} float fields not "
                  f"bitwise equal to the numpy fleet's, all within "
                  f"{jit_tolerance()}"
                  + (f"; {row['bands']} ensemble bands agree, widest C_eff "
                     f"half-width {row['widest_c_eff_halfwidth']:.4f}"
                     if "bands" in row else ""), flush=True)
    finally:
        ops.fleet_loop_kernel = kernel
    return out


def live_validation(kernels):
    """Phase 8, the paper's six-phase live validation (§6.7): the real half
    of `examples/torch_serve_cost_meter.py` on the full-width llama31-8b in
    bf16 at `LIVE`'s traffic, metered at the card's entry; then the
    example's sim half on `SIM_HW`, and the real half's own schedule and
    engine on the sim tier of `SIM_HW` (priced alike) beside it. Gates:
    every request finishes, the generated tokens equal the sum of their
    `max_new_tokens`, one flash launch per attention layer per prefill
    call and one paged launch per attention layer per decode step (no
    other kernel), K/V pools finite, the meter's time-weighted average
    finite and positive. Returns the readings and the launch counts."""
    import importlib.util
    import math
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CARD_ENGINE
    from repro_torch.serving import Engine, EngineConfig, SimExecutor
    from repro_torch.simulate import HW_BY_NAME, StepTimeModel
    spec = importlib.util.spec_from_file_location(
        "torch_serve_cost_meter",
        os.path.join(ROOT, "examples", "torch_serve_cost_meter.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    eng, meter, reqs = example.real_half("cuda", **LIVE)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    ex, n, clock = eng.ex, layer_counts(eng.ex.cfg), eng.t
    calls = (ex.n_prefill_calls, ex.n_decode_steps)
    print(f"live validation: {len(reqs)} requests in {wall:.1f} s wall, "
          f"engine clock {clock:.2f} s, {calls[0]} prefill calls, "
          f"{calls[1]} decode steps, launches {launches}", flush=True)
    if not all(r.finish_time is not None for r in reqs):
        fail("live validation: not every request finished")
    want = sum(r.max_new_tokens for r in reqs)
    got = eng.metrics.get("repro:generation_tokens_total")
    if got != want:
        fail(f"live validation: generated {got} tokens, expected {want}")
    expect = {name: 0 for name in kernels}
    expect.update(flash_attention=n["attn"] * calls[0],
                  paged_attention=n["attn"] * calls[1])
    if launches != expect or not all(calls):
        fail(f"live validation: launch counts {launches} != {expect}")
    if not all(_minus_inf_only_where_idle(p) for p in ex.pools):
        fail("live validation: non-finite values in the K/V pools")
    summ = meter.summary()
    if not (math.isfinite(summ["time_weighted_avg"])
            and summ["time_weighted_avg"] > 0):
        fail(f"live validation: meter average {summ['time_weighted_avg']}")
    ttft = sorted(r.ttft for r in reqs)
    phases = _live_phases(example.REAL_PHASES, LIVE["phase_s"], reqs,
                          meter.samples)
    for ph in phases:
        print(f"live validation: {ph['lam']} req/s from t={ph['from_s']:.1f}"
              f" s: peak in flight {ph['peak_in_flight']} (at a tick), peak "
              f"waiting for a first token {ph['peak_waiting']}, TTFT p50 "
              f"{ph['ttft_p50_ms']:.1f} ms", flush=True)
    del eng, ex                       # free the card before the sim halves
    gc.collect()
    torch.cuda.empty_cache()
    _, sim_meter, sim_reqs = example.sim_half(SIM_HW)
    cfg = get_config("llama31-8b")
    same = Engine(EngineConfig(**CARD_ENGINE), SimExecutor(
        cfg, StepTimeModel(cfg, HW_BY_NAME[SIM_HW])))
    print(f"\n=== SIM tier: llama31-8b on {SIM_HW} at the real half's "
          "traffic and engine ===", flush=True)
    same_meter, same_reqs = example.six_phase(
        same, price=HW_BY_NAME[SIM_HW].price_per_chip_hr,
        phases=example.REAL_PHASES, label="sim", **LIVE)

    def readings(m, rs):
        s = {k: (v if v is None or math.isfinite(v) else None)
             for k, v in m.summary().items()}
        s["minute_costs"] = [c if math.isfinite(c) else None
                             for c in m.minute_costs()]
        s["finished"] = sum(r.finish_time is not None for r in rs)
        return s

    out = {"traffic": dict(LIVE, phases=list(example.REAL_PHASES),
                           requests=len(reqs), output_tokens=int(got)),
           "wall_s": wall, "engine_clock_s": clock,
           "prefill_calls": calls[0], "decode_steps": calls[1],
           "tokens_per_s": got / clock,
           "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
           "phases": phases,
           "real": readings(meter, reqs),
           "ticks": [(s.t, s.tps, s.inflight, s.c_eff)
                     for s in meter.samples],
           "sim_same_traffic": readings(same_meter, same_reqs),
           "sim_paper_schedule": readings(sim_meter, sim_reqs),
           "launches": launches}
    print(f"live validation: real ({SIM_HW}'s price) swing {summ['swing']} "
          f"avg {summ['time_weighted_avg']:.4f} $/MTok; sim at the same "
          f"traffic swing {out['sim_same_traffic']['swing']} avg "
          f"{out['sim_same_traffic']['time_weighted_avg']:.4f}; sim at the "
          f"paper's schedule swing {out['sim_paper_schedule']['swing']} avg "
          f"{out['sim_paper_schedule']['time_weighted_avg']:.4f}",
          flush=True)
    return out


def _live_phases(rates, phase_s, reqs, samples):
    """Per phase of `six_phase` (its requests in order, `phase_s` seconds
    of arrivals each): its start on the engine clock, the most
    requests in flight at a meter tick within it, the most requests
    waiting for a first token (queued or in prefill, the arriving one
    included) at any of its arrivals, and its requests' TTFT p50."""
    out, i = [], 0
    for lam in rates:
        n = max(1, int(lam * phase_s))
        own, i = reqs[i:i + n], i + n
        lo = own[0].arrival_time
        hi = reqs[i].arrival_time if i < len(reqs) else float("inf")
        ttft = sorted(r.ttft for r in own)
        out.append({
            "lam": lam, "from_s": lo, "requests": n,
            "peak_in_flight": max([int(s.inflight) for s in samples
                                   if lo <= s.t < hi] or [0]),
            "peak_waiting": max(sum(r.arrival_time <= q.arrival_time
                                    < r.first_token_time for r in reqs)
                                for q in own),
            "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2]})
    return out


# ---------------------------------------------------------------------------
# the fused 8-bit AdamW update (phase 3) and training (phase 9)
# ---------------------------------------------------------------------------

def adamw8bit_bytes(n: int, rows: int, last: int, g_bytes: int,
                    p_bytes: int) -> int:
    """Bytes one update of a leaf must move: g read, p read and written,
    both moments' codes read and written, and their block scales (two read,
    two written, 4 bytes each, a 256-wide block)."""
    return n * (g_bytes + 2 * p_bytes + 4) + rows * -(-last // 256) * 16


def check_adamw8bit(gen):
    """Phase 3's check of the fused 8-bit AdamW update: at llama31-8b's
    leaf shapes and xlstm-350m's ragged sLSTM width (`ADAMW_SHAPES`, bf16
    g and p; wq also with fp32 g, as accumulation gives it), 3 consecutive
    updates from a fresh state (zero codes, scales 1e-12) on the same
    gradients, the kernel against its plain version on the card: p, codes
    and scales bit for bit, with a clip scale (`ADAMW_CLIP`) on all but the
    norm scale and the embedding. The planted fault, the last 256-block of
    each row left un-re-encoded, must leave codes or scales unequal. Then
    the kernel timed (a CUDA graph of repeated in-place updates, as
    `device_ms`), the plain version with CUDA events around repeated calls
    (it is Python over chunks of rows), each beside its bound: the bytes
    of `adamw8bit_bytes` over 3.35 TB/s (its `ADAMW_F32_OPS` fp32
    operations an element take about a seventh of that time at 67
    TFLOP/s). No PyTorch call computes this function:
    `torch.optim.AdamW(fused=True)` keeps fp32 moments."""
    from repro_torch.kernels.adamw8bit.kernel import adamw8bit_kernel
    from repro_torch.kernels.adamw8bit.ref import (adamw8bit_update_ref,
                                                   num_blocks)
    hyper = dict(lr=3e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    cases = [(name, shape, torch.bfloat16) for name, shape in ADAMW_SHAPES]
    cases.append(("wq, fp32 g", dict(ADAMW_SHAPES)["wq"], torch.float32))
    variants = []
    for name, shape, g_dtype in cases:
        rows, last = math.prod(shape[:-1]), shape[-1]
        nb = num_blocks(last)
        clip = None if name in ("embed", "norm scale") else torch.tensor(
            ADAMW_CLIP, device="cuda")
        p0 = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        sides = {}
        for side in ("kernel", "plain", "fault"):
            sides[side] = [p0.clone()] + [
                t for _ in range(2) for t in (
                    torch.zeros(shape, dtype=torch.int8, device="cuda"),
                    torch.full(shape[:-1] + (nb,), 1e-12, device="cuda"))]
        del p0
        fns = {"kernel": adamw8bit_kernel, "plain": adamw8bit_update_ref,
               "fault": adamw8bit_kernel}
        for t in range(1, 4):
            g = (torch.randn(shape, generator=gen, device="cuda")
                 * 10.0 ** -t).to(g_dtype)
            tt = torch.tensor(float(t), device="cuda")
            bc = [1 - torch.pow(torch.tensor(b, device="cuda"), tt)
                  for b in (0.9, 0.999)]
            for side, state in sides.items():
                adamw8bit_kernel.skip_last_block = side == "fault"
                try:
                    fns[side](g, *state, *bc, clip, **hyper)
                finally:
                    adamw8bit_kernel.skip_last_block = False
        torch.cuda.synchronize()
        unequal = [int((a.reshape(-1).view(torch.uint8) !=
                        b.reshape(-1).view(torch.uint8)).sum())
                   for a, b in zip(sides["kernel"], sides["plain"])]
        if any(unequal):
            fail(f"adamw8bit [{name} {shape}] differs from its plain version "
                 f"after 3 updates: bytes unequal in p, m codes, m scales, "
                 f"v codes, v scales: {unequal}")
        fault = [int((a != b).sum()) for a, b in zip(sides["fault"][1:],
                                                      sides["plain"][1:])]
        if not any(fault):
            fail(f"adamw8bit [{name}]: the check accepts a planted fault "
                 f"(the last block of each row left un-re-encoded)")
        args = [g, *sides["kernel"], *bc, clip]
        del sides["fault"]
        ms = device_ms(lambda *a: adamw8bit_kernel(*a, **hyper), [args])
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        reps = 3 if rows * last > 1 << 26 else 20
        e0.record()
        for _ in range(reps):
            adamw8bit_update_ref(g, *sides["plain"], *bc, clip, **hyper)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1) / reps
        n = rows * last
        nbytes = adamw8bit_bytes(n, rows, last, g.element_size(), 2)
        bound_ms, bound_by = bound(nbytes, n * ADAMW_F32_OPS, FP32_PEAK)
        v = {"shape": f"{name} {tuple(shape)}, g {str(g_dtype)[6:]}, p "
                      f"bf16" + ("" if clip is None else
                                 f", clip {ADAMW_CLIP}"),
             "max_abs_err": 0.0, "fault": {"codes and scales unequal":
                                           sum(fault)},
             "fault_desc": "the last 256-block of each row left "
                           "un-re-encoded",
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None,
             "library_note": "none: torch.optim.AdamW(fused=True) keeps "
                             "fp32 moments",
             "share_of_bound": bound_ms / ms, "bytes": nbytes}
        print(f"kernel adamw8bit_update [{v['shape']}]: p, codes and scales "
              f"bit for bit after 3 updates; planted fault ({v['fault_desc']}"
              f"): {sum(fault)} codes and scales unequal (rejected)",
              flush=True)
        print(f"kernel adamw8bit_update [{v['shape']}]: ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms=None bound_ms="
              f"{bound_ms:.4f} ({bound_by}), {bound_ms / ms:.3f} of its "
              f"bound, {nbytes / ms / 1e6:.0f} GB/s", flush=True)
        variants.append(v)
        del sides, args, g
        torch.cuda.empty_cache()
    return variants


def train_small_run(device, seed: int, grad_clip=1.0):
    """`TRAIN_SMALL`'s steps of the narrow llama31-8b (2 layers, d_model
    512, 4 heads of 128, vocab 1024, bf16) with adamw8bit on `device`, from
    weights drawn on the CPU from `seed` and the same `SyntheticDataLoader`
    batches. Returns (each step's loss, the final parameters on the CPU)."""
    from repro_torch.configs import reduced
    from repro_torch.models import init_params
    from repro_torch.training import (SyntheticDataLoader, adamw8bit,
                                      build_train_step)
    cfg = reduced("llama31-8b", d_model=512, ff=1024, vocab=1024)
    params = _tree_map(lambda t: t.to(device), init_params(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed)))
    opt = adamw8bit(TRAIN_SMALL["lr"])
    state = opt.init(params)
    step = build_train_step(cfg, opt, remat=True, grad_clip=grad_clip)
    dl = SyntheticDataLoader(cfg.vocab_size, TRAIN_SMALL["batch"],
                             TRAIN_SMALL["seq"], seed=seed, device=device)
    losses = []
    for i in range(TRAIN_SMALL["steps"]):
        params, state, stats = step(params, state, dl.batch_at(i))
        losses.append(float(stats["loss"]))
    return losses, _tree_map(lambda t: t.cpu(), params)


def train_small_readings(a, b) -> dict:
    """Two runs of `train_small_run`: the largest difference of a step's
    loss, and the final parameters' largest and mean |difference|."""
    from repro_torch.training.optimizer import tree_leaves
    d = torch.cat([(x.float() - y.float()).abs().flatten()
                   for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1]))])
    return {"loss": max(abs(x - y) for x, y in zip(a[0], b[0])),
            "params max": float(d.max()), "params mean": float(d.mean())}


def within_train_bounds(readings: dict) -> bool:
    return all(readings[k] <= b for k, b in TRAIN_SMALL_BOUNDS.items())


def train_lockstep_run(seed: int, fault=None) -> dict:
    """`TRAIN_SMALL`'s steps of `train_small_run`'s model on the card, each
    step also taken on the CPU (the plain version) from a copy of the
    card's parameters and state before it, on the same batch: a step's
    readings see that step's differences only, not those the steps before
    it compounded. `fault` plants one on the card's side: "clip skipped"
    (its train step without the clip) or "block left unencoded" (the
    kernel's `skip_last_block`). Returns the largest over the steps of the
    loss |difference|, the grad norm's relative difference, the share of
    parameter elements not equal, and the share of moment codes more than
    1 apart."""
    from repro_torch.configs import reduced
    from repro_torch.kernels.adamw8bit.kernel import adamw8bit_kernel
    from repro_torch.models import init_params
    from repro_torch.training import (SyntheticDataLoader, adamw8bit,
                                      build_train_step)
    from repro_torch.training.optimizer import tree_leaves
    cfg = reduced("llama31-8b", d_model=512, ff=1024, vocab=1024)
    params = _tree_map(lambda t: t.cuda(), init_params(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed)))
    opt = adamw8bit(TRAIN_SMALL["lr"])
    state = opt.init(params)
    card_step = build_train_step(
        cfg, opt, remat=True,
        grad_clip=None if fault == "clip skipped" else 1.0)
    cpu_step = build_train_step(cfg, opt, remat=True, grad_clip=1.0)
    data = {d: SyntheticDataLoader(cfg.vocab_size, TRAIN_SMALL["batch"],
                                   TRAIN_SMALL["seq"], seed=seed, device=d)
            for d in ("cpu", "cuda")}

    def share(pairs, off):
        n = sum(b.numel() for _, b in pairs)
        return sum(int(off(a.cpu(), b).sum()) for a, b in pairs) / n

    out = dict.fromkeys(("loss", "grad_norm", "params off", "codes off"),
                        0.0)
    for i in range(TRAIN_SMALL["steps"]):
        to_cpu = lambda t: None if t is None else t.to(  # noqa: E731
            "cpu", copy=True)
        p_cpu, s_cpu, st_cpu = cpu_step(_tree_map(to_cpu, params),
                                        _tree_map(to_cpu, state),
                                        data["cpu"].batch_at(i))
        adamw8bit_kernel.skip_last_block = fault == "block left unencoded"
        try:
            params, state, st = card_step(params, state,
                                          data["cuda"].batch_at(i))
        finally:
            adamw8bit_kernel.skip_last_block = False
        gn = float(st_cpu["grad_norm"])
        codes = [(a, b) for a, b in zip(tree_leaves(state),
                                        tree_leaves(s_cpu))
                 if a.dtype == torch.int8]
        now = {"loss": abs(float(st["loss"]) - float(st_cpu["loss"])),
               "grad_norm": abs(float(st["grad_norm"]) - gn) / gn,
               "params off": share(list(zip(tree_leaves(params),
                                            tree_leaves(p_cpu))),
                                   lambda a, b: a != b),
               "codes off": share(codes, lambda a, b:
                                  (a.int() - b.int()).abs() > 1)}
        out = {k: max(out[k], now[k]) for k in out}
    return out


def within_lockstep_bounds(readings: dict) -> bool:
    return all(readings[k] <= b for k, b in TRAIN_LOCKSTEP_BOUNDS.items())


def small_training_check(seed: int = 1):
    """Phase 9a. Free-running: `train_small_run` on the card (the fused
    kernel) against the CPU (its plain version), held by
    `TRAIN_SMALL_BOUNDS`; the card's run with the clip skipped must fail
    them. Step by step: `train_lockstep_run`, held by
    `TRAIN_LOCKSTEP_BOUNDS`; each planted fault must fail them."""
    cpu = train_small_run("cpu", seed)
    card = train_small_run("cuda", seed)
    faulty = train_small_run("cuda", seed, grad_clip=None)
    sound, fault = (train_small_readings(cpu, card),
                    train_small_readings(cpu, faulty))
    lock = {f or "sound": train_lockstep_run(seed, f)
            for f in (None,) + TRAIN_FAULTS}
    ok = within_train_bounds(sound) and within_lockstep_bounds(lock["sound"])
    rejected = not within_train_bounds(fault) and not any(
        within_lockstep_bounds(lock[f]) for f in TRAIN_FAULTS)
    return {"losses cpu": cpu[0], "losses card": card[0],
            "losses card, clip skipped": faulty[0], "sound": sound,
            "fault (clip skipped)": fault, "bounds": TRAIN_SMALL_BOUNDS,
            "step by step": lock, "step bounds": TRAIN_LOCKSTEP_BOUNDS,
            "pass": ok, "fault rejected": rejected}


def _flag(argv, name):
    return argv[argv.index(name) + 1]


def full_width_training(kernel):
    """Phase 9b: `repro_torch.launch.train.main(TRAIN_FULL)`, llama31-8b at
    full width and depth (32 layers, 8.03 B parameters in bf16) with
    adamw8bit, its counts set to 0 before it. Gates: every loss and grad
    norm finite, the loss lower at each step than at the one before; the
    kernel launched once per leaf per step; every matrix moved from the
    initial weights (drawn again from the entry point's seed). Readings:
    each step's time on the stream (the entry point's own), tokens/s,
    peak allocated, and the optimizer's device ms a step (CUDA events
    around `update` on the trained state, after the run) beside the bound
    of its updates (`adamw8bit_bytes` of every leaf over 3.35 TB/s)."""
    import repro_torch.launch.train as train_mod
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training import adamw8bit
    from repro_torch.training.optimizer import tree_leaves
    kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, steps = train_mod.main(TRAIN_FULL)
    wall = time.perf_counter() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    leaves = tree_leaves(params)
    shapes = [tuple(p.shape) for p in leaves]
    # the initial weights, drawn as the entry point draws them
    init = init_params(get_config("llama31-8b"), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(
                           int(_flag(TRAIN_FULL, "--seed"))))
    moved = [float((a != b).float().mean())
             for a, b in zip(leaves, tree_leaves(init))]
    matrices_moved = min(m for m, s in zip(moved, shapes) if len(s) > 1)
    # the optimizer alone on the trained state, the initial weights as
    # gradients, a clip scale as the train step passes one
    opt = adamw8bit(float(_flag(TRAIN_FULL, "--lr")))
    scale = torch.tensor(0.5, device="cuda")
    opt_ms = []
    for _ in range(3):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        opt.update(init, state, params, grad_scale=scale)
        e[1].record()
        e[1].synchronize()
        opt_ms.append(e[0].elapsed_time(e[1]))
    kernel.launches = launches      # the timing's launches are not the path's
    del params, state, init, leaves
    n_steps = int(_flag(TRAIN_FULL, "--steps"))
    tokens = int(_flag(TRAIN_FULL, "--batch")) * int(_flag(TRAIN_FULL,
                                                           "--seq"))
    bound_ms = sum(adamw8bit_bytes(math.prod(s), math.prod(s[:-1]), s[-1],
                                   2, 2) for s in shapes) / MEM_BW * 1e3
    later = sorted(s["s"] for s in steps[1:]) or [steps[0]["s"]]
    out = {"arch": "llama31-8b", "layers": 32,
           "lr": float(_flag(TRAIN_FULL, "--lr")),
           "params": sum(math.prod(s) for s in shapes),
           "leaves": len(shapes), "steps": steps, "launches": launches,
           "expected_launches": len(shapes) * n_steps,
           "share_moved_least_matrix": matrices_moved,
           "share_moved_norms": [m for m, s in zip(moved, shapes)
                                 if len(s) == 1][:4],
           "wall_s": wall, "step_s_median_after_first": later[len(later) // 2],
           "tokens_per_s": tokens / later[len(later) // 2],
           "optimizer_ms": opt_ms, "optimizer_bound_ms": bound_ms,
           "peak_allocated_gib": peak}
    print(f"training llama31-8b full width: {json.dumps(out)}", flush=True)
    finite = all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                 for s in steps)
    if len(steps) != n_steps or not finite:
        fail(f"full-width training: {len(steps)} steps, losses and grad "
             f"norms {steps}")
    if not all(b["loss"] < a["loss"] for a, b in zip(steps, steps[1:])):
        fail(f"full-width training: the loss did not fall at every step: "
             f"{steps}")
    if launches != out["expected_launches"]:
        fail(f"full-width training: adamw8bit launched {launches} times, "
             f"not once per leaf per step ({out['expected_launches']})")
    if not matrices_moved > 0:
        fail("full-width training: a weight matrix kept its initial values")
    return out


def restart_check():
    """Phase 9c: `examples/torch_train_small.py`'s ~100M config on the
    card: 4 steps straight; then 2 steps, a checkpoint, a restore
    (`restore_latest`, by re-running with the same directory) and 2 more.
    The last loss must agree within the reference's 1e-2. The directories
    are deleted after."""
    import importlib.util
    import shutil
    import tempfile
    spec = importlib.util.spec_from_file_location(
        "torch_train_small", os.path.join(ROOT, "examples",
                                          "torch_train_small.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    dirs = [tempfile.mkdtemp(prefix="train_small_") for _ in range(2)]
    runs = []
    try:
        for d, steps in ((dirs[0], 4), (dirs[1], 2), (dirs[1], 4)):
            history = example.main(["--steps", str(steps),
                                    "--ckpt-dir", d])[2]
            runs.append([s["loss"] for s in history])
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    straight, resumed = runs[0][-1], runs[2][-1]
    out = {"straight": runs[0], "before": runs[1], "after restore": runs[2],
           "diff": abs(straight - resumed)}
    print(f"training restart (~100M, examples/torch_train_small.py): "
          f"{json.dumps(out)}", flush=True)
    if len(runs[2]) != 2 or not out["diff"] < 1e-2:
        fail(f"training restart: the resumed run {runs[2]} does not continue "
             f"the straight one {runs[0]} (within 1e-2)")
    return out


def sharded_restore(mesh):
    """Phase 10's checkpoint restore by placements: a narrow llama31-8b's
    bf16 parameters and adamw8bit state (codes drawn at random) saved at
    step 1 and at step 2, whose arrays are then corrupted; step 1 restored
    with `shardings` (`launch.specs`' placements on the host mesh, under
    `shardctx`) and without. Every leaf must be a DTensor on the card whose
    local tensor equals the plain restore's, bit for bit (bf16 through
    uint16), and `restore_latest` must skip the corrupt step."""
    import shutil
    import tempfile
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import reduced
    from repro_torch.launch import specs
    from repro_torch.models import init_params
    from repro_torch.parallel import shardctx
    from repro_torch.training import CheckpointManager, adamw8bit
    cfg = reduced("llama31-8b", vocab=1024, d_model=512, ff=1024)
    params = init_params(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(5))
    state = adamw8bit(1e-3).init(params)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for t in _tree_leaves(state):
        if t.dtype == torch.int8:
            t.random_(-127, 128, generator=gen)
    tree = {"params": params, "opt": state}
    shardings = {
        "params": specs.placements_tree(
            specs.param_shardings(cfg, params, mesh), mesh),
        "opt": specs.placements_tree(specs.opt_shardings(cfg, state, mesh),
                                     mesh)}
    d = tempfile.mkdtemp(prefix="sharded_restore_")
    try:
        cm = CheckpointManager(d, keep=5, async_save=False)
        cm.save(1, tree)
        cm.save(2, tree)
        with open(os.path.join(d, "step_000000002", "arrays.npz"),
                  "r+b") as f:
            f.seek(200)
            f.write(b"\x00" * 64)
        with shardctx(mesh):
            got, _ = cm.restore(1, tree, shardings)
            latest = cm.restore_latest(tree, shardings)
        plain, _ = cm.restore(1, tree, device="cuda")
    finally:
        shutil.rmtree(d, ignore_errors=True)

    def bits(t):
        t = t.to_local() if isinstance(t, DTensor) else t
        return t.view(torch.uint16) if t.dtype == torch.bfloat16 else t

    g, pl = _tree_leaves(got), _tree_leaves(plain)
    out = {"leaves": len(g),
           "dtensors on cuda": sum(isinstance(t, DTensor)
                                   and t.device.type == "cuda" for t in g),
           "locals equal": len(g) == len(pl) and all(
               torch.equal(bits(a), bits(b)) for a, b in zip(g, pl)),
           "latest step": latest[0],
           "latest equal": all(torch.equal(bits(a), bits(b)) for a, b in
                               zip(_tree_leaves(latest[1]), g))}
    print(f"parallel: sharded restore {json.dumps(out)}", flush=True)
    return out


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [] if tree is None else [tree]


# phase 11: the dry-run's cells (`launch.dryrun.run_cell`, on `h100-sxm`),
# in a child process of their own: a fake process group is process-wide
DRYRUN_CELLS = (("whisper-base", "decode_32k", False),
                ("whisper-base", "decode_32k", True),
                ("llama31-8b", "decode_32k", False))
# the reference's records of DRYRUN_CELLS, hardware-independent
# (`repro.launch.dryrun.run_cell` on the CPU, its production mesh rebuilt
# with `AxisType.Auto` axes, JAX 0.9; `tests/test_torch_dryrun.py` makes
# the whisper-base ones afresh): (argument bytes, collective bytes) a
# device
DRYRUN_REFERENCE = {("whisper-base", "16x16"): (438_238_272, 1_034_624),
                    ("whisper-base", "2x16x16"): (263_846_944, 517_312),
                    ("llama31-8b", "16x16"): (4_136_771_648, 20_316_288)}


def dryrun_child():
    """The dry-run phase's child (`chip_smoke.py --dryrun-child`; imports
    no JAX and touches no card): the counters on the unit case, each of
    DRYRUN_CELLS with its argument bytes from `launch.specs`' specs, and
    the planted fault, DRYRUN_CELLS[0] with every parameter replicated.
    Prints its results as one JSON line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(2)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    with dryrun.fake_mesh() as mesh:
        fm = FakeTensorMode()
        meta = lambda *s: torch.empty(s, dtype=torch.bfloat16,  # noqa: E731
                                      device="meta")
        x = dryrun.shard_like(meta(128, 4096), mesh,
                              (Shard(0), Replicate()), fm)
        w = dryrun.shard_like(meta(4096, 14336), mesh,
                              (Replicate(), Shard(1)), fm)
        c1, c2 = dryrun.OpCounter(), dryrun.OpCounter()
        with fm, dryrun.counting(c1):
            y = x @ w
        with fm, dryrun.counting(c2):
            y.redistribute(mesh, (Shard(0), Replicate()))
        out["unit"] = {"flops": c1.flops, "all-gather": c2.collectives[
            "all-gather"], "collectives": sum(c2.collectives.values()),
            "local operand bytes": y.to_local().numel() * 2}

    def want_bytes(arch, shape, multi_pod):
        mesh = make_production_mesh(multi_pod=multi_pod)
        _, args, sp, _ = specs.build_cell(get_config(arch),
                                          SHAPES_BY_NAME[shape], mesh)
        return specs.shard_bytes(args, sp, mesh)

    out["cells"] = []
    for arch, shape, mp in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod=mp, hw="h100-sxm",
                              save=False, verbose=False)
        rec["wall_s"] = time.perf_counter() - t0
        rec["want_argument_bytes"] = want_bytes(arch, shape, mp)
        out["cells"].append(rec)
    real = specs.param_shardings
    specs.param_shardings = lambda cfg, p, mesh, fsdp="auto": \
        specs._map2(lambda s, a, _: specs.P(), real(cfg, p, mesh, fsdp), p)
    try:
        arch, shape, mp = DRYRUN_CELLS[0]
        out["fault"] = dryrun.run_cell(arch, shape, multi_pod=mp,
                                       hw="h100-sxm", save=False,
                                       verbose=False)
    finally:
        specs.param_shardings = real
    print("DRYRUN " + json.dumps(out), flush=True)


def start_dryrun():
    """Start phase 11's child (about 30 s on the host's cores)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--dryrun-child"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), time.perf_counter()


def dryrun_gates(rec, want_bytes):
    """One record against the specs and the reference's record
    (`DRYRUN_REFERENCE`): argument bytes those of `launch.specs`' specs,
    and less the arguments no op read, XLA's (which drops unused
    arguments); FLOPs a device within [0.9, 3.5] x the analytic count
    (below 1 by the embedding lookup; whisper-base's head, whose 51,865
    words do not divide the model axis, runs whole on each rank, and its
    cross-attention is outside the analytic decode count); collective
    bytes within [1/8, 1] x XLA's, all-reduces among them (the port
    reduces bf16 partial sums where XLA reduces fp32 ones, and replicates
    the heads that do not fill the model axis where XLA splits head_dim)."""
    ref_args, ref_coll = DRYRUN_REFERENCE[(rec["arch"], rec["mesh"])]
    mem, coll = rec["memory_analysis"], rec["collective_bytes"]
    ratio = rec["cost_analysis"]["flops"] / rec["roofline"][
        "flops_per_device"]
    return {"argument bytes": mem["argument_size_in_bytes"] == want_bytes,
            "read argument bytes = reference's": mem[
                "argument_size_in_bytes"] - mem[
                "unread_argument_size_in_bytes"] == ref_args,
            "flops in [0.9, 3.5] x analytic": 0.9 <= ratio <= 3.5,
            "collectives in [1/8, 1] x reference's":
                ref_coll / 8 <= coll["total"] <= ref_coll
                and coll["all-reduce"] > 0}


def dryrun_phase(child, smi):
    """Phase 11: the dry-run. The child's three cells must end ok on 256,
    512 and 256 fake ranks and pass `dryrun_gates`; the planted fault (every
    parameter replicated) must fail the argument-bytes gate; the counters
    must be exact on the unit case (the local product's 58,720,256 FLOPs,
    one all-gather of the local operand)."""
    proc, t0 = child
    so, se = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    lines = [ln for ln in so.splitlines() if ln.startswith("DRYRUN ")]
    if proc.returncode != 0 or not lines:
        fail(f"dry-run phase: the child failed ({proc.returncode}): "
             f"{so[-2000:]} {se[-4000:]}")
    res = json.loads(lines[-1][len("DRYRUN "):])
    cells, gates = [], []
    for rec, n in zip(res["cells"], (256, 512, 256)):
        g = dryrun_gates(rec, rec["want_argument_bytes"])
        g["status ok"] = rec["status"] == "ok" and rec["n_devices"] == n
        gates.append(g)
        cells.append({
            "cell": f"{rec['arch']} x {rec['shape']} x {rec['mesh']}",
            "hw": rec["hw"], "n_devices": rec["n_devices"],
            "flops": rec["cost_analysis"]["flops"],
            "bytes accessed": rec["cost_analysis"]["bytes accessed"],
            "collective_bytes": rec["collective_bytes"],
            "memory_analysis": rec["memory_analysis"],
            "bottleneck": rec["roofline"]["bottleneck"],
            "roofline": {k: rec["roofline"][k] for k in (
                "compute_s", "memory_s", "memory_analytic_s",
                "collective_s", "roofline_frac")},
            "wall_s": rec["wall_s"], "gates": g})
    fault = dryrun_gates(res["fault"], res["cells"][0]["want_argument_bytes"])
    unit = res["unit"]
    out = {"cells": cells, "unit": unit,
           "planted fault (parameters replicated)": {
               "argument bytes": res["fault"]["memory_analysis"][
                   "argument_size_in_bytes"],
               "rejected": not fault["argument bytes"]},
           "child_wall_s": wall, "card": smi}
    print(f"dryrun: {json.dumps(out)}", flush=True)
    if not (all(all(g.values()) for g in gates)
            and out["planted fault (parameters replicated)"]["rejected"]
            and unit["flops"] == 58_720_256
            and unit["all-gather"] == unit["collectives"]
            == unit["local operand bytes"]):
        fail(f"dry-run phase: {out}")
    return out


def parallel_phase():
    """Phase 10: `repro_torch.parallel` and the mesh half of the model on
    CUDA tensors over a one-rank NCCL group (its store a `HashStore`: no
    network) and a (1, 1) ("data", "model") `DeviceMesh`
    (`launch.mesh.make_host_mesh`). Each collective against its value
    without a group: the flash-decoding combine of one shard's partial
    softmax is num / den (equal) and `decode_attention` (within 2e-4, the
    reference's own test's tolerance); the ring all-gather is x stacked
    (equal); a 4-microbatch pipeline over a one-stage mesh is the stage
    applied to each microbatch (equal). Then llama31-8b at full width and
    depth: `models.prefill` of 8 prompts of 64 tokens, then 4
    `decode_step`s with `PERF.flash_decode` under `shardctx` of the host
    mesh against the same steps without it: logits and caches equal (on
    one card every gate sends it to `decode_attention`). Multi-rank NCCL
    waits for a machine with more than one card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import model as model_lib
    from repro_torch.parallel import combine_partial_softmax, shardctx
    from repro_torch.parallel.collectives import ring_all_gather
    from repro_torch.parallel.pipeline import pipeline_apply
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    out = {}
    try:
        mesh = make_host_mesh()
        out["host_mesh"] = {"names": list(mesh.mesh_dim_names),
                            "shape": list(mesh.mesh.shape),
                            "backend": dist.get_backend()}
        gen = torch.Generator(device="cuda").manual_seed(2)
        q = torch.randn(8, 1, 40, 128, generator=gen, device="cuda")
        kc, vc = (torch.randn(8, 8, 768, 128, generator=gen, device="cuda")
                  for _ in range(2))
        cl = torch.tensor(SERVED_LENS, dtype=torch.int32, device="cuda")
        valid = torch.arange(768, device="cuda")[None, :] < cl[:, None]
        num, den, m = attn.decode_attention_partial(q, kc, vc, valid)
        got = combine_partial_softmax(num, den, m, mesh.get_group("model"))
        plain = attn.decode_attention(q, kc, vc, cl)
        out["combine"] = {
            "equal to num / den": bool(torch.equal(
                got, num / torch.clamp(den, min=1e-30))),
            "max_abs_vs_decode_attention": max_abs(got, plain)}
        x = torch.randn(6, 40, generator=gen, device="cuda")
        ring = ring_all_gather(x, mesh.get_group("data"))
        out["ring_equal"] = bool(torch.equal(ring, x[None]))
        w = torch.randn(1, 64, 64, generator=gen, device="cuda") * 0.3
        micro = torch.randn(4, 2, 64, generator=gen, device="cuda")
        stage = lambda p, h: torch.tanh(h @ p["w"])      # noqa: E731
        pipe = pipeline_apply(stage, {"w": w}, micro,
                              init_device_mesh("cuda", (1,),
                                               mesh_dim_names=("stage",)))
        out["pipeline_equal"] = bool(torch.equal(
            pipe, torch.stack([stage({"w": w[0]}, h) for h in micro])))

        cfg = get_config("llama31-8b")
        params = init_params(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (8, 64), generator=gen,
                               device="cuda", dtype=torch.int32)
        logits, cache = prefill(params, cfg, {"tokens": tokens}, max_len=68)
        token = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        sides = {}
        for name in ("without a mesh", "under shardctx"):
            lg, c, t, steps = logits, cache, token, []
            model_lib.PERF.flash_decode = True
            try:
                with shardctx(mesh if name == "under shardctx" else None):
                    for _ in range(4):
                        lg, c = decode_step(params, cfg, t, c)
                        steps.append(lg)
                        t = torch.argmax(lg[:, -1], -1).to(torch.int32)[:,
                                                                        None]
            finally:
                model_lib.PERF.flash_decode = False
            sides[name] = (steps, c)
        (a, ca), (b, cb) = sides.values()
        out["llama31-8b decode_step"] = {
            "layers": cfg.num_layers, "steps": len(a),
            "logits equal": all(torch.equal(x, y) for x, y in zip(a, b)),
            "caches equal": all(torch.equal(x[n], y[n]) for x, y in zip(
                ca["layers"], cb["layers"]) for n in ("k", "v")),
            "finite": all(bool(torch.isfinite(x).all()) for x in a)}
        del params, cache, sides, a, b, ca, cb
        out["sharded restore"] = sharded_restore(mesh)
    finally:
        dist.destroy_process_group()
    out["multi-rank NCCL"] = ("not run: waits for a machine with more than "
                              "one card")
    print(f"parallel: {json.dumps(out)}", flush=True)
    print("parallel: multi-rank NCCL waits for a machine with more than one "
          "card; its parity runs on the CPU (tests/test_torch_parallel.py, "
          "4 gloo processes)", flush=True)
    d = out["llama31-8b decode_step"]
    r = out["sharded restore"]
    if not (out["host_mesh"]["shape"] == [1, 1]
            and r["dtensors on cuda"] == r["leaves"] > 0
            and r["locals equal"] and r["latest step"] == 1
            and r["latest equal"]
            and out["combine"]["equal to num / den"]
            and out["combine"]["max_abs_vs_decode_attention"] <= 2e-4
            and out["ring_equal"] and out["pipeline_equal"]
            and d["logits equal"] and d["caches equal"] and d["finite"]):
        fail(f"parallel phase: {out}")
    return out


def main():
    if sys.argv[1:] == ["--dryrun-child"]:
        return dryrun_child()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.adamw8bit.kernel import adamw8bit_kernel
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_kernel
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm_kernel
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_kernel
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_kernel
    from repro_torch.serving import runner
    start = time.perf_counter()

    def phase(name):
        print(f"-- {name} at {time.perf_counter() - start:.1f} s",
              flush=True)

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    print(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    phase("build")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("Used", "spill", "Compiling",
                                       "warning")):
                print(f"  {name}: {line.strip()}")
    sass = sass_counts(str(build.library_path("flash_attention")))
    print(f"build: flash_attention SASS: {sass}", flush=True)
    if not (sass["HGMMA"] and sass["UTMALDG"]):
        fail(f"flash_attention's SASS holds no wgmma or no TMA load: {sass}")
    sass = sass_counts(str(build.library_path("int8_matmul")))
    print(f"build: int8_matmul SASS: {sass}", flush=True)
    if not (sass["IGMMA"] and sass["UTMALDG"]):
        fail(f"int8_matmul's SASS holds no integer wgmma or no TMA load: "
             f"{sass}")
    sass = sass_counts(str(build.library_path("moe_gemm")))
    print(f"build: moe_gemm SASS: {sass}", flush=True)
    if not (sass["HGMMA"] and sass["UTMALDG"] and sass["LDSM"]) or \
            sass["I2F"]:
        fail(f"moe_gemm's SASS must hold wgmma, TMA loads and ldmatrix and "
             f"no int-to-float conversion (I2F): {sass}")
    sass = sass_counts(str(build.library_path("paged_attention")))
    print(f"build: paged_attention SASS: {sass}", flush=True)
    if not sass["LDGSTS"]:
        fail(f"paged_attention's SASS holds no cp.async copy: {sass}")
    sass = sass_counts(str(build.library_path("ssm_scan")))
    print(f"build: ssm_scan SASS: {sass}", flush=True)
    if not (sass["LDGSTS"] or sass["UTMALDG"]):
        fail(f"ssm_scan's SASS holds no cp.async or TMA copy: {sass}")
    sass = sass_counts(str(build.library_path("fleet_loop")))
    ptx = {k: v for k, v in build.ptx_opcodes("fleet_loop").items()
           if k.endswith(".f64") and k.split(".")[0] in (
               "mul", "add", "sub", "div", "fma", "mad")}
    print(f"build: fleet_loop PTX: {ptx}; SASS: {sass}", flush=True)
    contracted = {k: v for k, v in ptx.items()
                  if k.split(".")[0] in ("fma", "mad") or ".rn." not in k}
    if contracted or not all(ptx.get(f"{op}.rn.f64") for op in (
            "mul", "add", "div")):
        fail(f"fleet_loop's PTX must round every float64 product, sum and "
             f"quotient to nearest (mul.rn, add.rn, div.rn) and hold no "
             f"fused multiply-add nor a product or sum ptxas may contract: "
             f"{ptx}")
    sass = sass_counts(str(build.library_path("adamw8bit")))
    ptx = {k: v for k, v in build.ptx_opcodes("adamw8bit").items()
           if k.endswith(".f32") and k.split(".")[0] in (
               "mul", "add", "sub", "div", "sqrt", "fma", "mad", "rcp")}
    print(f"build: adamw8bit PTX: {ptx}; SASS FFMA {sass['FFMA']} (the "
          f"source's fused multiply-adds and the expansions of div.rn and "
          f"sqrt.rn)", flush=True)
    loose = [k for k in ptx if k.startswith("mad") or ".rn." not in k]
    if loose or not all(ptx.get(f"{op}.rn.f32") for op in (
            "mul", "add", "div", "sqrt", "fma")):
        fail(f"adamw8bit's PTX must round every fp32 product, sum, quotient "
             f"and square root on its own (.rn) and fuse only what the "
             f"source writes as __fmaf_rn: {ptx}")
    # an empty log: built before
    for name in ("int8_matmul", "ssm_scan", "adamw8bit", "moe_gemm"):
        spills = [line.strip() for line in logs[name].splitlines()
                  if "spill" in line and not line.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                      "spill loads")]
        if spills:
            fail(f"ptxas spills in {name}: {spills}")

    # 3. kernels against their plain versions, then timed
    phase("kernels")
    runner.set_matmul_precision()     # the plain versions' einsums in fp32
    gen = torch.Generator(device="cuda").manual_seed(0)
    meta = {
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention/kernel.py:71"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:76"),
        "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                        "src/repro/kernels/int8_matmul/kernel.py:43"),
        "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:55"),
        "moe_gemm": ("src/repro_torch/csrc/moe_gemm.cu",
                     "no Pallas kernel: src/repro/models/moe.py apply_moe's "
                     "dequantized expert einsums, left to XLA"),
    }
    variants = {
        "paged_attention": [check_paged(gen, a) for a in ATTN_ARCHS],
        "flash_attention": [check_flash(gen, a) for a in ATTN_ARCHS]
        + check_flash_bidirectional(gen),
        "int8_matmul": check_int8(gen),
        "ssm_scan": check_ssm(gen),
        "moe_gemm": check_moe_gemm(gen),
    }
    for name, vs in variants.items():
        for v in vs:
            f = v["fault"]
            gate = (f"gate={v['gate']:.3g} (pass <= 1)" if "gate" in v
                    else "bit-exact")
            fault = (f"planted fault ({v['fault_desc']}): {f} (rejected)"
                     if f is not None else "no planted fault at this shape")
            print(f"kernel {name} [{v['shape']}]: max_abs_err="
                  f"{v['max_abs_err']:.3g} {gate}; {fault}", flush=True)
            print(f"kernel {name} [{v['shape']}]: ms={v['ms']:.4f} "
                  f"plain_ms={v['plain_ms']:.4f} library_ms="
                  f"{v['library_ms']} bound_ms={v['bound_ms']:.4f} "
                  f"({v.get('bound_term', v['bound_by'])}) "
                  f"{v.get('library_note', '')}", flush=True)
            if "tops" in v:
                print(f"kernel {name} [{v['shape']}]: {v['tops']:.1f} "
                      f"TOP/s, {v['x_bound']:.3f} x its bound", flush=True)
            for mix, m in v.get("served_mixes", {}).items():
                print(f"kernel {name} [{v['shape']}]: at the {mix} decode "
                      f"mix seq_lens={m['seq_lens']}: ms={m['ms']:.4f} "
                      f"plain_ms={m['plain_ms']:.4f} bound_ms="
                      f"{m['bound_ms']:.4f} ({m['bound_by']}), "
                      f"{m['share_of_bound']:.3f} of its bound", flush=True)
            if "served_mix" in v:
                m = v["served_mix"]
                print(f"kernel {name} [{v['shape']}]: {v['tflops']:.1f} "
                      f"TFLOP/s, {v['share_of_bound']:.3f} of its bound, "
                      f"{v['x_library']:.3f} x SDPA's time (SDPA's own "
                      f"gate against the plain version: "
                      f"{v['library_gate']:.3g})", flush=True)
                print(f"kernel {name} [{v['shape']}]: at the served mix "
                      f"kv_len={m['kv_len']}: ms={m['ms']:.4f} bound_ms="
                      f"{m['bound_ms']:.4f} ({m['bound_by']}), "
                      f"{m['share_of_bound']:.3f} of its bound, "
                      f"{m['tflops']:.1f} TFLOP/s", flush=True)
    adamw_variants = check_adamw8bit(gen)
    # the yardsticks' cuBLAS workspaces, one per stream they ran on
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    torch.cuda.empty_cache()

    # 4. small inputs: kernels on the card against plain versions on the CPU
    phase("small-input checks")
    failed = []                 # reported after the other phases have run
    for arch, quant in SMALL_CHECKS:
        readings, ok = small_input_check(arch, quant)
        print(f"small-input check {arch} {quant}: "
              f"{'pass' if ok else 'FAIL'} {json.dumps(readings)}",
              flush=True)
        if not ok:
            failed.append(f"{arch} {quant}: {readings}")
    readings, ok = small_whisper_check()
    print(f"small-input check whisper-base bf16 (prefill, decode_step): "
          f"{'pass' if ok else 'FAIL'} {json.dumps(readings)}", flush=True)
    if not ok:
        failed.append(f"whisper-base bf16: {readings}")

    # 5. main paths, one engine on the card at a time
    kernels = {"paged_attention": paged_attention_kernel,
               "flash_attention": flash_attention_kernel,
               "int8_matmul": int8_matmul_kernel,
               "ssm_scan": ssm_scan_kernel,
               "moe_gemm": moe_gemm_kernel}
    paths, steps = [], []
    for arch, quant in MAIN_PATHS:
        phase(f"main path {arch} {quant}")
        out, log = main_path(arch, quant, kernels)
        paths.append(out)
        steps.append(log)
        gc.collect()
        torch.cuda.empty_cache()
    phase("contiguous API whisper-base")
    contiguous = whisper_path(kernels)
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the sim tier on the card's entry, beside the real tier's readings
    phase("sim tier")
    t0 = time.perf_counter()
    sims = [sim_against_real(p, log) for p, log in zip(paths, steps)]
    matrix, h100_recs = sim_matrix()
    print(f"sim tier: {time.perf_counter() - t0:.1f} s", flush=True)

    # 7. the fleet's event loop on the card: the jit backend
    phase("fleet")
    t0 = time.perf_counter()
    fleet_check = check_fleet_loop()
    fleet = fleet_phase(h100_recs)
    print(f"fleet: {time.perf_counter() - t0:.1f} s", flush=True)

    # 8. the paper's six-phase live validation on the card, then the sim's
    phase("live validation")
    t0 = time.perf_counter()
    live = live_validation(kernels)
    print(f"live validation: {time.perf_counter() - t0:.1f} s", flush=True)

    # 11. the dry-run, in a child process on the host's cores meanwhile
    # 9. training on the card, every served model freed first
    phase("training")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    adamw8bit_kernel.launches = 0
    small = small_training_check()
    train_launches = {"small check (card runs)": adamw8bit_kernel.launches}
    print(f"training small check llama31-8b bf16: "
          f"{'pass' if small['pass'] and small['fault rejected'] else 'FAIL'}"
          f" {json.dumps(small)}", flush=True)
    if not (small["pass"] and small["fault rejected"]):
        failed.append(f"training small check: {small}")
    full = full_width_training(adamw8bit_kernel)
    train_launches["llama31-8b full width"] = full["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    adamw8bit_kernel.launches = 0
    restart = restart_check()
    train_launches["restart ~100M"] = adamw8bit_kernel.launches
    print(f"training: {time.perf_counter() - t0:.1f} s", flush=True)

    # 10. the parallel substrate on a one-rank NCCL group
    phase("parallel")
    gc.collect()
    torch.cuda.empty_cache()
    parallel = parallel_phase()
    # 11. the dry-run, its child alone on the host's cores: no phase is
    # timed beside it
    phase("dry-run")
    dry = dryrun_phase(start_dryrun(), smi)
    phase("done")
    print(json.dumps({"main_paths": paths}))
    print(json.dumps({"contiguous_api": contiguous}))
    print(json.dumps({"sim_tier": {"against_real": sims,
                                   "matrix": matrix}}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"live_validation": live}))
    print(json.dumps({"training": {"small_check": small, "full_width": full,
                                   "restart": restart}}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"dryrun": dry}))

    rows = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name, vs in variants.items():
        by_path = {f"{p['arch']} {p['quant']}": p["launches"][name]
                   for p in paths}
        by_path["live validation llama31-8b bf16"] = live["launches"][name]
        by_path["whisper-base bf16 contiguous"] = \
            contiguous["launches"][name]
        for v in vs:        # an attention instantiation's own launches
            if v.get("instantiation", {}).get("path") == "whisper-base":
                noncausal = contiguous["noncausal_launches"]
                v["launches"] = (noncausal if not v["instantiation"]["causal"]
                                 else contiguous["launches"][name]
                                 - noncausal)
            elif "instantiation" in v:
                v["launches"] = sum(
                    p["launches"][name] for p in paths
                    if instantiation(p["arch"]) == v["instantiation"]) + (
                    live["launches"][name] if instantiation("llama31-8b")
                    == v["instantiation"] else 0)
        row = {"name": name, "route": "cuda", "source": meta[name][0],
               "replaces": meta[name][1],
               "launches": sum(by_path.values()),
               "max_abs_err": max(v["max_abs_err"] for v in vs)}
        row.update({k: vs[0][k] for k in keys[1:]})   # the first variant
        if "served_mix" in vs[0]:
            row.update({k: vs[0][k] for k in ("tflops", "share_of_bound",
                                              "x_library")})
            row["served_mix_share_of_bound"] = \
                vs[0]["served_mix"]["share_of_bound"]
        if "served_mixes" in vs[0]:
            row["share_of_bound"] = vs[0]["share_of_bound"]
            row["served_mixes"] = vs[0]["served_mixes"]
        row["launches_by_path"] = by_path
        row["variants"] = [{k: v[k] for k in ("shape",) + keys
                            + ("instantiation", "launches",
                               "bound_term", "bound_terms_ms", "tflops",
                               "share_of_bound", "x_library", "library_gate",
                               "served_mix", "served_mixes", "tops",
                               "x_bound",
                               "library_row_major_ms")
                            if k in v}
                           for v in vs]
        rows.append(row)
    rows.append(dict(fleet_check, launches=sum(fleet["launches"].values()),
                     launches_by_path=fleet["launches"],
                     lanes=fleet["lanes_by_path"],
                     ms_per_launch=fleet["ms_per_launch"]))
    opt_ms = sorted(full["optimizer_ms"])
    rows.append({"name": "adamw8bit_update", "route": "cuda",
                 "source": "src/repro_torch/csrc/adamw8bit.cu",
                 "replaces": "src/repro/training/optimizer.py:121",
                 "launches": sum(train_launches.values()),
                 "launches_by_path": train_launches,
                 "max_abs_err": 0.0,
                 **{k: adamw_variants[0][k] for k in (
                     "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")},
                 "step_optimizer_ms": opt_ms[len(opt_ms) // 2],
                 "step_bound_ms": full["optimizer_bound_ms"],
                 "variants": adamw_variants})
    print(json.dumps({"kernels": rows}))
    print(smi)
    if failed:
        fail(f"small-input checks: {failed}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


def heads(arch):
    """(query heads, KV heads, head_dim) of the full `arch`."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


def instantiation(arch) -> dict:
    """The attention kernels' instantiation that `arch` runs: its head_dim
    and query heads per KV head."""
    hq, hkv, d = heads(arch)
    return {"head_dim": d, "group": hq // hkv}


def _n_weights(tree) -> int:
    """Parameters of a tree, a quantized weight counted once (not its
    scales)."""
    if isinstance(tree, dict):
        if "q" in tree:
            return tree["q"].numel()
        return sum(_n_weights(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_weights(v) for v in tree)
    return tree.numel()


def _n_bytes(tree) -> int:
    """Bytes of every tensor of a tree (scales included), each storage
    counted once: a K-major weight holds its matrix's bytes, its rows
    padded to a multiple of 16 where K is not one."""
    seen = {}

    def visit(t):
        if isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, list):
            for v in t:
                visit(v)
        elif isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    visit(tree)
    return sum(seen.values())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    main()
