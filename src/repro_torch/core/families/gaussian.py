"""Gaussian MRF family: unit-conditional-variance Gauss-Markov field.

The node conditionals are x_i | x_N(i) ~ N(h_i + sum_j T_ij x_j, 1), so each
local CL fit is a least-squares solve: the curvature hook is the constant 1
and the Newton engine converges in one step. The joint is N(mu, Sigma) with
precision I - T and mean Sigma h, valid while I - T is positive definite
(``random_params`` keeps it diagonally dominant); the exact oracle is
closed form, computed in float64 numpy on the host.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...device import resolve_device
from ..graphs import Graph
from ..ising import as_tensor, suff_stats
from .base import ModelFamily

_LOG_2PI = float(math.log(2.0 * math.pi))


@dataclasses.dataclass(frozen=True)
class GaussianMRF(ModelFamily):
    name: str = "gaussian"

    @property
    def kernel_kind(self) -> str:
        return "gaussian"

    @property
    def block_dim(self) -> int:
        return 1

    def edge_features(self, x):
        return x[..., None]

    def loglik_eta(self, eta, xi):
        r = xi - eta[..., 0, :]
        return -0.5 * r * r - 0.5 * _LOG_2PI

    def dl_deta(self, eta, xi):
        return (xi - eta[..., 0, :])[..., None, :]

    def curvature(self, eta, xi):
        kap = torch.ones_like(eta[..., 0, :])
        return kap[..., None, None, :]

    # ---------------------------------------------------- sampling hooks
    def init_draw(self, generator, p: int, device=None):
        return torch.randn(p, generator=generator,
                           device=resolve_device(device))

    def cond_draw(self, generator, eta):
        return eta[..., 0] + torch.randn(eta.shape[:-1], generator=generator,
                                         device=eta.device, dtype=eta.dtype)

    # ------------------------------------------------------------- model
    def suff_stats(self, graph: Graph, X):
        return suff_stats(graph, X)          # [x, x_i x_j]: the Ising form

    # ------------------------------------------------------------ oracle
    def _precision(self, graph: Graph, theta) -> np.ndarray:
        T = np.zeros((graph.p, graph.p))
        te = _host(theta)[graph.p:]
        for k, (i, j) in enumerate(graph.edges):
            T[i, j] = T[j, i] = te[k]
        return np.eye(graph.p) - T

    def moments(self, graph: Graph, theta):
        """(mu, Sigma) of the joint Gaussian — the closed-form oracle."""
        J = self._precision(graph, theta)
        Sigma = np.linalg.inv(J)
        mu = Sigma @ _host(theta)[: graph.p]
        return mu, Sigma

    def log_partition(self, graph: Graph, theta) -> float:
        J = self._precision(graph, theta)
        h = _host(theta)[: graph.p]
        sign, logdet = np.linalg.slogdet(J)
        if sign <= 0:
            raise ValueError("I - T is not positive definite")
        mu = np.linalg.solve(J, h)
        return float(0.5 * (h @ mu) - 0.5 * logdet
                     + 0.5 * graph.p * _LOG_2PI)

    def exact_moments(self, graph: Graph, theta) -> np.ndarray:
        mu, Sigma = self.moments(graph, theta)
        second = np.array([Sigma[i, j] + mu[i] * mu[j]
                           for (i, j) in graph.edges])
        return np.concatenate([mu, second])

    def exact_sample(self, graph: Graph, theta, n: int, generator):
        dev = as_tensor(theta).device
        mu, Sigma = self.moments(graph, theta)
        L = torch.as_tensor(np.linalg.cholesky(Sigma), device=dev)
        z = torch.randn((n, graph.p), generator=generator, device=dev,
                        dtype=torch.float64)
        X = torch.as_tensor(mu, device=dev)[None, :] + z @ L.T
        return X.to(torch.float32)

    def random_params(self, graph: Graph, generator, scale_edge: float = 0.4,
                      scale_node: float = 0.3, device=None):
        dev = resolve_device(device)
        h = scale_node * torch.randn(graph.p, generator=generator,
                                     device=dev, dtype=torch.float64)
        te = scale_edge * torch.randn(graph.m, generator=generator,
                                      device=dev, dtype=torch.float64)
        # keep I - T strictly diagonally dominant -> positive definite
        row = np.zeros(graph.p)
        te_np = np.abs(te.cpu().numpy())
        for k, (i, j) in enumerate(graph.edges):
            row[i] += te_np[k]
            row[j] += te_np[k]
        worst = float(row.max()) if graph.m else 0.0
        if worst > 0.9:
            te = te * (0.9 / worst)
        return torch.cat([h, te])


def _host(theta) -> np.ndarray:
    """A flat theta (tensor or array) as a float64 numpy array."""
    if isinstance(theta, torch.Tensor):
        theta = theta.detach().cpu().numpy()
    return np.asarray(theta, dtype=np.float64)
