"""Dispatch for the 8-bit AdamW update of one leaf: the CUDA kernel for
tensors on the card, the plain version for tensors on the CPU. There is
no fallback: a tensor on any other device, or a CUDA input the kernel
does not take, raises."""
from __future__ import annotations

from repro_torch.kernels.adamw8bit.kernel import adamw8bit_kernel
from repro_torch.kernels.adamw8bit.ref import adamw8bit_update_ref


def adamw8bit_update(g, p, m_q, m_scale, v_q, v_scale, bc1, bc2,
                     grad_scale=None, **hyper):
    """Update p and both moments' codes and scales in place. See
    `adamw8bit_update_ref` for the arguments."""
    if p.device.type == "cpu":
        return adamw8bit_update_ref(g, p, m_q, m_scale, v_q, v_scale, bc1,
                                    bc2, grad_scale, **hyper)
    if p.device.type == "cuda":
        return adamw8bit_kernel(g, p, m_q, m_scale, v_q, v_scale, bc1, bc2,
                                grad_scale, **hyper)
    raise ValueError(f"adamw8bit_update: no version for device {p.device}")
