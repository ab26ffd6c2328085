"""PyTorch and CUDA port of `repro` for one NVIDIA H100.

The subpackages mirror the reference's names. The port imports `torch`,
never `jax`, and no module of `repro`: what it shares with the reference
it keeps as its own copy. Slice 1 is the live cost-metered server:
`launch.serve` -> `serving.Engine` -> `serving.RealExecutor` ->
`serving.runner` (dense decoder over the paged KV pool, attention in the
kernels of `kernels/`, built from `csrc/`) -> `core.CostMeter`.
"""
