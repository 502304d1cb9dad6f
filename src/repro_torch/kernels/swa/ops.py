"""Dispatch for the flash-attention kernel, with the backward of training.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version (and
plain autograd). The kernel is forward-only, as the reference's Pallas
kernel is; a CUDA call that needs gradients goes through
:class:`SwaFunction`, whose backward recomputes through the plain version,
as the reference's ``custom_vjp`` does (``src/repro/kernels/swa/ops.py``
``_swa_bwd``). A kernel that fails to build or launch raises: nothing falls
back to the plain forward.
"""
import torch

from .kernel import swa_attention
from .ref import swa_attention_ref


class SwaFunction(torch.autograd.Function):
    """The Hopper forward (one launch counted in ``swa_attention.launches``)
    with a backward that runs ``torch.autograd.grad`` of the plain version
    on detached copies of the saved q, k and v: the reference's
    ``jax.vjp`` of its oracle. Recomputing costs the plain forward's
    (b, h, s, s) float32 scores once more per backward; storing the
    probabilities instead would hold them from forward to backward."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        return swa_attention(q, k, v, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = swa_attention_ref(q, k, v, window=ctx.window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def swa_op(q, k, v, *, window: int = 0):
    """Causal (optionally sliding-window) attention; see
    :func:`~repro_torch.kernels.swa.kernel.swa_attention`. Differentiable:
    on CUDA tensors that need gradients it runs :class:`SwaFunction`."""
    if q.device.type != "cuda":
        return swa_attention_ref(q, k, v, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return SwaFunction.apply(q, k, v, window)
    return swa_attention(q, k, v, window=window)
