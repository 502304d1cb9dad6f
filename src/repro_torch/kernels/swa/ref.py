"""Plain PyTorch version of the swa kernel (materialised-score attention)."""
import math

import torch

NEG_INF = -2.0e38


def swa_attention_ref(q, k, v, *, window: int = 0):
    """Causal (optionally sliding-window) attention with GQA.

    q: (b, s, h, d); k, v: (b, s, kh, d) with h % kh == 0. Scores in float32,
    probabilities rounded to q's type before the product with v; returns
    (b, s, h, d) in q's type.
    """
    b, s, h, d = q.shape
    g = h // k.shape[2]
    k = torch.repeat_interleave(k, g, dim=2)
    v = torch.repeat_interleave(v, g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
