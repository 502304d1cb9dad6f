"""Plain PyTorch versions of the CL kernels: masked logits and the fused
channelized score statistics."""
import torch

from .epilogues import require_epilogue


def cl_logits_ref(F, theta, mask, bias):
    """Channelized masked logits ``eta_c = F_c (theta_c * mask) + b_c``.

    F: (C, n, p); theta: (C, p, p); mask: (p, p); bias: (C, p). Computes in
    F's type and returns (C, n, p) in it, as the reference does.
    """
    return (torch.einsum("cnj,cji->cni", F, theta * mask[None])
            + bias[:, None, :]).to(F.dtype)


def ising_cl_logits_ref(x, theta, mask, bias):
    """``eta = x (theta * mask) + bias``: the single-channel (n, p) entry."""
    return (x @ (theta * mask) + bias[None, :]).to(x.dtype)


def cl_score_channels_ref(F, theta, mask, bias, kind: str):
    """(eta, r, S): channelized logits, residuals, cross-channel score Gram.

    F: (C, n, p); theta: (C, p, p); mask: (p, p); bias: (C, p). Computes in
    float32 like the kernel; eta and r come back in F's type and
    ``S[c, e] = r_c^T F_e / n`` in float32.
    """
    ep = require_epilogue(kind)
    Ff = F.to(torch.float32)
    eta = torch.einsum("cnj,cji->cni", Ff,
                       (theta * mask[None]).to(torch.float32)) \
        + bias[:, None, :].to(torch.float32)
    r = ep.residual(Ff, eta)
    s = torch.einsum("cni,enj->ceij", r, Ff) / F.shape[1]
    return eta.to(F.dtype), r.to(F.dtype), s


def cl_score_ref(x, theta, mask, bias, kind: str = "ising"):
    """(eta, r, S): conditional logits, score residuals and score Gram of
    the single-channel (n, p) entry.

    x: (n, p); theta, mask: (p, p); bias: (p,). Computes in float32 like
    the kernel; eta and r come back in x's type and ``S = r^T x / n``
    (p, p) in float32. Kinds whose epilogue is multi-channel (Potts) need
    :func:`cl_score_channels_ref`.
    """
    ep = require_epilogue(kind)
    if ep.channels != "single":
        raise ValueError(
            f"kind {kind!r} is multi-channel; use cl_score_channels_ref")
    xf = x.to(torch.float32)
    eta = xf @ (theta * mask).to(torch.float32) \
        + bias[None, :].to(torch.float32)
    r = ep.residual(xf[None], eta[None])[0]
    s = r.T @ xf / x.shape[0]
    return eta.to(x.dtype), r.to(x.dtype), s


def ising_cl_score_ref(x, theta, mask, bias):
    """Ising instance of :func:`cl_score_ref`."""
    return cl_score_ref(x, theta, mask, bias, kind="ising")
