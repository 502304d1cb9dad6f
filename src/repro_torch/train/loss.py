"""Cross-entropy LM loss with label masking and z-loss regularisation, the
port of ``repro.train.loss``.

Computed in float32 whatever the activations' type; padded-vocab logits
are safe because labels never index the padding region.
"""
from __future__ import annotations

import torch


def cross_entropy(logits, labels, *, z_loss: float = 1e-4):
    """logits: (B, S, V); labels: (B, S) integers, -1 = masked.

    Returns (mean loss, metrics dict of ``nll``, ``z_loss``, ``n_tokens``).
    """
    lf = logits.to(torch.float32)
    mask = (labels >= 0).to(torch.float32)
    safe_labels = torch.clamp(labels, min=0)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, safe_labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    zl = z_loss * torch.square(lse) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll + zl).sum() / denom
    metrics = {
        "nll": nll.sum() / denom,
        "z_loss": zl.sum() / denom,
        "n_tokens": mask.sum(),
    }
    return loss, metrics
