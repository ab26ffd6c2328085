"""PyTorch and CUDA port of `repro` for one NVIDIA H100.

The subpackages mirror the reference's names. The port imports `torch`,
never `jax`, and no module of `repro`: what it shares with the reference
it keeps as its own copy. The port serves the live cost-metered server:
`launch.serve` -> `serving.Engine` -> `serving.RealExecutor` ->
`serving.runner` (attention decoders, dense or MoE, over the paged KV
pool, in bf16, int8 or fp8; attention and the int8 GEMM in the kernels of
`kernels/`, built from `csrc/`) -> `core.CostMeter`. Its sim tier
(`simulate`, `serving.SimExecutor`, `core.sweep`, `experiments`) runs the
same engine on a step-time model of a hardware-book entry (the
reference's TPUs and `h100-sxm`) and imports no torch.
"""
