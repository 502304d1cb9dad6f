"""Plain PyTorch version of the Gram kernel."""
import torch


def gram_ref(s):
    """``G = s^T s / n`` in float32 for s (n, d) -> (d, d)."""
    sf = s.to(torch.float32)
    return (sf.T @ sf) / s.shape[0]
