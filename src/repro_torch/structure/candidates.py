"""Candidate-edge screening: which pairs is the lasso allowed to pick?

``session.select`` first builds a *candidate*
:class:`~repro_torch.core.graphs.Graph` and runs the group-lasso path over
its edges only. Three policies (``StructureSpec.policy``):

  full   — every pair: exact, O(p^2) candidates, data-independent.
  knn    — per-node top-k screening, union-symmetrized: keep (i, j) when
           j is among i's k most correlated nodes OR vice versa. The
           screen correlates the *edge features* ``family.edge_features(X)``
           channel-wise in float64 and takes the max |corr| over the C x C
           channel pairs, in torch on the device X lies on.
  given  — the caller's explicit edge set, in i < j order.

All policies return a plain ``Graph``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.graphs import Graph, complete_graph
from .spec import StructureSpec

__all__ = ["candidate_graph"]


def _knn_screen(X: torch.Tensor, k: int, family) -> Graph:
    """Union-of-top-k screening on max channel |correlation|."""
    n, p = X.shape
    C = family.block_dim
    F = family.edge_features(X.to(torch.float64)).reshape(n, p * C)
    F = F - F.mean(dim=0, keepdim=True)
    sd = F.std(dim=0, correction=0)
    F = F / torch.where(sd > 0.0, sd, torch.ones_like(sd))
    corr = torch.abs(F.T @ F) / max(n, 1)                       # (pC, pC)
    # max |corr| over the C x C channel block of each node pair
    score = corr.reshape(p, C, p, C).amax(dim=(1, 3))           # (p, p)
    score.fill_diagonal_(-float("inf"))
    # deterministic top-k: score descending, then node id ascending (a
    # stable sort keeps equal scores in id order)
    top = torch.sort(score, dim=1, descending=True, stable=True).indices
    top = top[:, :k].cpu().numpy()
    i = np.repeat(np.arange(p), k)
    j = top.ravel()
    keep = i != j
    a, b = np.minimum(i, j)[keep], np.maximum(i, j)[keep]
    pairs = np.unique(a.astype(np.int64) * p + b)
    return Graph(p, tuple((int(e // p), int(e % p)) for e in pairs))


def candidate_graph(spec: StructureSpec, p: int, X=None,
                    family=None) -> Graph:
    """Build the candidate-edge graph ``session.select`` searches over.

    ``X`` (an (n, p) tensor or array) and ``family`` are only consulted by
    the ``knn`` policy; ``full`` and ``given`` are shape-only.
    """
    if spec.policy == "full":
        return complete_graph(p)
    if spec.policy == "given":
        return Graph(p, tuple(sorted(spec.given_edges)))
    # knn
    if spec.knn_k >= p:
        raise ValueError(
            f"knn_k must be < p (a node has at most p-1 = {p - 1} "
            f"neighbors); got knn_k={spec.knn_k} with p={p} — use "
            f"policy 'full' to consider every pair")
    if X is None or family is None:
        raise ValueError("policy 'knn' screens on data: candidate_graph "
                         "needs X and family")
    X = torch.as_tensor(X)
    if X.ndim != 2 or X.shape[1] != p:
        raise ValueError(f"X must be (n, p={p}); got {tuple(X.shape)}")
    return _knn_screen(X, spec.knn_k, family)
