"""Dispatch for the fused CL kernels: ``cuda`` or ``ref``.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain PyTorch version. ``use_kernel=False`` is the caller's explicit request
for the plain version on any device (the counterpart of the reference
package's ``use_pallas=False``); it is never taken silently.

Every dispatcher tags the innermost active telemetry recorder (see
:func:`repro_torch.telemetry.record_kernel_trace`) with the kernel kind,
the resolved path (the ``backend=`` tag, one of :data:`KERNEL_PATHS`) and
the operand shape. A recorder keeps the first dispatch of each such tag
set, so a warm call emits no tag; with telemetry off a dispatcher builds no
tag (:func:`repro_torch.telemetry.recorder.tracing_active`).
"""
from __future__ import annotations

import torch

from ...telemetry.recorder import record_kernel_trace, tracing_active
from .kernel import cl_score_channels, ising_cl_logits
from .newton import bucket_newton_stats, bucket_newton_stats_ref
from .ref import cl_score_channels_ref, cl_score_ref, ising_cl_logits_ref
from .score import cl_score

#: the resolved dispatch paths, as recorded in telemetry ``backend=`` tags
KERNEL_PATHS = ("cuda", "ref")


def default_kernel_path(device) -> str:
    """The path taken when the caller does not ask for the plain version:
    the CUDA kernel for a CUDA device, the plain version elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def resolve_kernel_path(device, use_kernel: bool = True) -> str:
    """``"cuda"`` for a CUDA device unless ``use_kernel`` is False."""
    return default_kernel_path(device) if use_kernel else "ref"


def conditional_logits_op(x, theta, mask, bias, *, use_kernel: bool = True):
    """Masked conditional logits ``x (theta * mask) + bias`` of the
    single-channel (n, p) entry."""
    path = resolve_kernel_path(x.device, use_kernel)
    if tracing_active():
        record_kernel_trace("kernel.conditional_logits", backend=path,
                            shape=tuple(x.shape))
    if path == "cuda":
        return ising_cl_logits(x, theta, mask, bias)
    return ising_cl_logits_ref(x, theta, mask, bias)


def score_stats_op(x, theta, mask, bias, *, kind: str = "ising",
                   use_kernel: bool = True):
    """Fused (eta, r, S) pseudo-likelihood score statistics of the
    single-channel (n, p) entry; ``kind`` selects the family epilogue."""
    path = resolve_kernel_path(x.device, use_kernel)
    if tracing_active():
        record_kernel_trace("kernel.score_stats", kind=kind, backend=path,
                            shape=tuple(x.shape))
    if path == "cuda":
        return cl_score(x, theta, mask, bias, kind=kind)
    return cl_score_ref(x, theta, mask, bias, kind=kind)


def score_stats_channels_op(F, theta, mask, bias, *, kind: str,
                            use_kernel: bool = True):
    """Channelized fused (eta, r, S) score statistics."""
    path = resolve_kernel_path(F.device, use_kernel)
    if tracing_active():
        record_kernel_trace("kernel.score_stats_channels", kind=kind,
                            backend=path, shape=tuple(F.shape))
    if path == "cuda":
        return cl_score_channels(F, theta, mask, bias, kind=kind)
    return cl_score_channels_ref(F, theta, mask, bias, kind)


def bucket_newton_stats_op(kind, Zb, base, xi, W, sw=None, *,
                           use_kernel: bool = True):
    """Fused bucket Newton statistics (g, K)."""
    path = resolve_kernel_path(Zb.device, use_kernel)
    if tracing_active():
        record_kernel_trace("kernel.bucket_newton_stats", kind=kind,
                            backend=path, shape=tuple(Zb.shape))
    if path == "cuda":
        return bucket_newton_stats(kind, Zb, base, xi, W, sw)
    return bucket_newton_stats_ref(kind, Zb, base, xi, W, sw)
