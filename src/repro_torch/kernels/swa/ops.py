"""Dispatch for the flash-attention kernel, forward only.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version. The
kernel has no backward yet: a CUDA call that would need gradients raises
rather than fall back to the plain version.
"""
import torch

from .kernel import swa_attention
from .ref import swa_attention_ref


def swa_op(q, k, v, *, window: int = 0):
    """Causal (optionally sliding-window) attention; see
    :func:`~repro_torch.kernels.swa.kernel.swa_attention`."""
    if q.device.type != "cuda":
        return swa_attention_ref(q, k, v, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the swa kernel is forward-only; its backward (an "
            "autograd.Function, for training) is ROADMAP.md queue 1, item 15")
    return swa_attention(q, k, v, window=window)
