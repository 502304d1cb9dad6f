"""Pairwise Ising models in exponential-family form (paper Sec. 2.1, Sec. 5).

    p(x | theta) = exp( sum_{(ij) in E} theta_ij x_i x_j
                        + sum_i theta_i x_i - log Z(theta) ),   x in {-1,+1}^p

The flat parameter vector is ordered [singletons (p), edges (m)], matching
``Graph`` conventions. The model math is plain PyTorch written without
in-place updates, so ``torch.func`` can differentiate it; the exact
enumeration utilities (small ``p``) run in float64 on the device of the
parameters they are given.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .graphs import Graph


def as_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """``a`` as a tensor. A tensor stays on its device unless ``device``
    names another; anything else goes to ``resolve_device(device)`` (the
    CUDA card when ``device`` is None, and raises when there is none).
    Read-only numpy arrays (as JAX hands them out) are copied."""
    if isinstance(a, torch.Tensor):
        t = a if device is None else a.to(resolve_device(device))
    else:
        arr = np.asarray(a)
        if not arr.flags.writeable:
            arr = arr.copy()
        t = torch.as_tensor(arr, device=resolve_device(device))
    return t if dtype is None else t.to(dtype)


def edge_index(graph: Graph, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) int64 tensors of the edge endpoints, in edge order."""
    e = torch.as_tensor(np.asarray(graph.edges, dtype=np.int64)
                        .reshape(-1, 2), device=device)
    return e[:, 0], e[:, 1]


@dataclasses.dataclass(frozen=True)
class IsingModel:
    graph: Graph
    theta: torch.Tensor  # flat (p + m,)

    @property
    def theta_single(self) -> torch.Tensor:
        return self.theta[: self.graph.p]

    @property
    def theta_edges(self) -> torch.Tensor:
        return self.theta[self.graph.p:]


def random_model(graph: Graph, sigma_pair: float, sigma_single: float,
                 generator: torch.Generator, device=None) -> IsingModel:
    """theta_ij ~ N(0, sigma_pair), theta_i ~ N(0, sigma_single) (Sec. 5),
    float64 on ``resolve_device(device)``, drawn from ``generator`` (which
    must live on that device)."""
    dev = resolve_device(device)
    ts = sigma_single * torch.randn(graph.p, generator=generator, device=dev,
                                    dtype=torch.float64)
    te = sigma_pair * torch.randn(graph.m, generator=generator, device=dev,
                                  dtype=torch.float64)
    return IsingModel(graph, torch.cat([ts, te]))


# ----------------------------------------------------------------- helpers
def pair_matrix(graph: Graph, theta_edges: torch.Tensor) -> torch.Tensor:
    """Symmetric (p, p) coupling matrix from the edge block."""
    T = torch.zeros((graph.p, graph.p), dtype=theta_edges.dtype,
                    device=theta_edges.device)
    if not graph.m:
        return T
    rows, cols = edge_index(graph, theta_edges.device)
    return T.index_put((rows, cols), theta_edges).index_put(
        (cols, rows), theta_edges)


def conditional_logits(graph: Graph, theta: torch.Tensor,
                       X: torch.Tensor) -> torch.Tensor:
    """eta_i(x) = theta_i + sum_{j in N(i)} theta_ij x_j for each sample.

    X: (n, p) in {-1, +1}. Returns (n, p);
    p(x_i = +1 | x_N(i)) = sigmoid(2 eta_i).
    """
    p = graph.p
    T = pair_matrix(graph, theta[p:])
    return X @ T + theta[:p][None, :]


def cond_loglik(graph: Graph, theta: torch.Tensor,
                X: torch.Tensor) -> torch.Tensor:
    """Per-node conditional log-likelihood log p(x_i | x_N(i)); (n, p)."""
    eta = conditional_logits(graph, theta, X)
    return F.logsigmoid(2.0 * X * eta)


def pseudo_loglik(graph: Graph, theta: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    """Average pseudo-likelihood (Eq. 2): mean over samples, summed over
    nodes."""
    return torch.mean(torch.sum(cond_loglik(graph, theta, X), dim=1))


# ------------------------------------------------------- exact enumeration
def all_states(p: int) -> np.ndarray:
    """(2^p, p) array of all {-1, +1} configurations; row s holds the bits
    of s, lowest bit first."""
    grid = ((np.arange(2 ** p)[:, None] >> np.arange(p)[None, :]) & 1)
    return (2.0 * grid - 1.0).astype(np.float32)


def states_tensor(p: int, device, dtype=torch.float64) -> torch.Tensor:
    """:func:`all_states` as a tensor on ``device``."""
    return torch.as_tensor(all_states(p), device=device).to(dtype)


def suff_stats(graph: Graph, X: torch.Tensor) -> torch.Tensor:
    """u(x) = [x_1..x_p, x_i x_j for (ij) in E]; (n, p+m)."""
    if not graph.m:
        return torch.cat([X, X.new_zeros((X.shape[0], 0))], dim=1)
    rows, cols = edge_index(graph, X.device)
    return torch.cat([X, X[:, rows] * X[:, cols]], dim=1)


def _state_scores(graph: Graph, theta):
    """(u(x) for every state x, u(x) . theta), float64 on theta's
    device."""
    theta = as_tensor(theta, dtype=torch.float64)
    U = suff_stats(graph, states_tensor(graph.p, theta.device))
    return U, U @ theta


def log_partition(graph: Graph, theta) -> torch.Tensor:
    """Exact log Z by enumeration (float64); only for small p."""
    return torch.logsumexp(_state_scores(graph, theta)[1], dim=0)


def exact_probs(graph: Graph, theta) -> torch.Tensor:
    """(2^p,) state probabilities in :func:`all_states` order (float64)."""
    return torch.softmax(_state_scores(graph, theta)[1], dim=0)


def loglik(graph: Graph, theta, X) -> torch.Tensor:
    """Average exact log-likelihood (small p only), float64."""
    theta = as_tensor(theta, dtype=torch.float64)
    U = suff_stats(graph, as_tensor(X, theta.device, torch.float64))
    return torch.mean(U @ theta) - log_partition(graph, theta)


def exact_moments(graph: Graph, theta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[u], cov(u)) under p(x|theta), float64 — cov(u) is the full-model
    Fisher."""
    U, s = _state_scores(graph, theta)
    pr = torch.softmax(s, dim=0)
    mu = pr @ U
    centered = U - mu[None, :]
    cov = (centered * pr[:, None]).T @ centered
    return mu, cov
