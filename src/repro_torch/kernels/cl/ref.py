"""Plain PyTorch version of the fused channelized score statistics."""
import torch

from .epilogues import require_epilogue


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
