"""Seed-compatible fused score entry points over the channelized kernel.

:func:`cl_score` keeps the single-channel ``(n, p)`` signature of the
Ising and Gaussian callers: it is the C = 1 view of
:func:`repro_torch.kernels.cl.kernel.cl_score_channels`. Multi-channel
kinds (Potts) are refused here with a pointer to the channelized entry;
:func:`repro_torch.kernels.cl.family.family_score_stats` builds the
channelized inputs from a model family directly.

``cl_score_padded`` / ``cl_score_channels_padded`` are the streaming-buffer
variants: zero-padded rows past ``n_seen`` add nothing to the score Gram
for every registered kind (padded feature rows are zero; for Potts because
state 0 is the reference state, whose indicator row is all zero), so only
the Gram normalizer is rescaled, from the buffer's capacity to the live
count.

Every entry point launches exactly one score kernel on CUDA tensors, which
must be all float32 or all bfloat16 (the kernel's ``TypeError`` otherwise);
eta and r come back in the input's type and S in float32. CPU tensors take
the plain version. Tile sizes are not arguments: the kernel's launch shape
follows fixed rules (``score_launch_shape``).
"""
from __future__ import annotations

from .epilogues import registered_kinds, require_epilogue
from .kernel import cl_score_channels

#: families with a registered fused-kernel epilogue, as imported: an
#: import-time snapshot kept for compatibility; live checks use
#: ``registered_kinds()`` / ``get_epilogue()``
KERNEL_KINDS = registered_kinds()


def cl_score(x, theta, mask, bias, *, kind: str = "ising"):
    """(eta, r, S) fused single-channel score statistics.

    x: (n, p); theta, mask: (p, p); bias: (p,). ``kind`` picks the family
    epilogue; multi-channel kinds raise (use :func:`cl_score_channels` or
    ``family_score_stats``). Returns eta, r of shape (n, p) in x's type and
    ``S = r^T x / n`` of shape (p, p) in float32.
    """
    ep = require_epilogue(kind)
    if ep.channels != "single":
        raise ValueError(
            f"kind {kind!r} is multi-channel (C > 1); use cl_score_channels "
            f"with (C, n, p) inputs — see repro_torch.kernels.cl.family")
    eta, r, S = cl_score_channels(x[None], theta[None], mask, bias[None],
                                  kind=kind)
    return eta[0], r[0], S[0, 0]


def ising_cl_score(x, theta, mask, bias):
    """Ising instance of :func:`cl_score`."""
    return cl_score(x, theta, mask, bias, kind="ising")


def cl_score_padded(x_pad, theta, mask, bias, n_seen: int, *,
                    kind: str = "ising"):
    """Fused score statistics over a zero-padded streaming buffer.

    ``x_pad`` is a sample buffer whose rows past ``n_seen`` are all zero.
    Zero rows add nothing to ``S = r^T X``, so the only correction is the
    normalizer: the kernel divides by the buffer's capacity, and S is
    rescaled to the live count. For the Ising kind the rows of ``r`` past
    ``n_seen`` are zero; the Gaussian residual ``x - eta`` is ``-bias``
    there, so consumers of per-sample residuals slice ``r[:n_seen]``.
    """
    eta, r, S = cl_score(x_pad, theta, mask, bias, kind=kind)
    scale = x_pad.shape[0] / max(int(n_seen), 1)
    return eta, r, S * scale


def ising_cl_score_padded(x_pad, theta, mask, bias, n_seen: int):
    """Ising instance of :func:`cl_score_padded`."""
    return cl_score_padded(x_pad, theta, mask, bias, n_seen, kind="ising")


def cl_score_channels_padded(F_pad, theta, mask, bias, n_seen: int, *,
                             kind: str):
    """Channelized :func:`cl_score_padded`: F_pad is (C, capacity, p) with
    all-zero feature rows past ``n_seen``. S is renormalized to the live
    count; per-sample consumers slice ``r[:, :n_seen]``."""
    eta, r, S = cl_score_channels(F_pad, theta, mask, bias, kind=kind)
    scale = F_pad.shape[1] / max(int(n_seen), 1)
    return eta, r, S * scale
