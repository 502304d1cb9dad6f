"""Dispatch for the fused CL kernels: ``cuda`` or ``ref``.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain PyTorch version. ``use_kernel=False`` is the caller's explicit request
for the plain version on any device (the counterpart of the reference
package's ``use_pallas=False``); it is never taken silently.
"""
from __future__ import annotations

from .kernel import cl_score_channels
from .newton import bucket_newton_stats, bucket_newton_stats_ref
from .ref import cl_score_channels_ref

def resolve_kernel_path(device, use_kernel: bool = True) -> str:
    """``"cuda"`` for a CUDA device unless ``use_kernel`` is False."""
    return "cuda" if use_kernel and device.type == "cuda" else "ref"


def score_stats_channels_op(F, theta, mask, bias, *, kind: str,
                            use_kernel: bool = True):
    """Channelized fused (eta, r, S) score statistics."""
    if resolve_kernel_path(F.device, use_kernel) == "cuda":
        return cl_score_channels(F, theta, mask, bias, kind=kind)
    return cl_score_channels_ref(F, theta, mask, bias, kind)


def bucket_newton_stats_op(kind, Zb, base, xi, W, sw=None, *,
                           use_kernel: bool = True):
    """Fused bucket Newton statistics (g, K)."""
    if resolve_kernel_path(Zb.device, use_kernel) == "cuda":
        return bucket_newton_stats(kind, Zb, base, xi, W, sw)
    return bucket_newton_stats_ref(kind, Zb, base, xi, W, sw)
