"""Ising family: C = 1 logistic node conditionals over x in {-1, +1}.

The model math and the exact oracle delegate to :mod:`repro_torch.core.
ising`, so the family instance and the seed code paths agree exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from .. import ising as I
from ..graphs import Graph
from .base import ModelFamily


@dataclasses.dataclass(frozen=True)
class IsingFamily(ModelFamily):
    name: str = "ising"

    @property
    def kernel_kind(self) -> str:
        return "ising"

    @property
    def block_dim(self) -> int:
        return 1

    def edge_features(self, x):
        return x[..., None]

    def loglik_eta(self, eta, xi):
        return F.logsigmoid(2.0 * xi * eta[..., 0, :])

    def dl_deta(self, eta, xi):
        r = 2.0 * xi * torch.sigmoid(-2.0 * xi * eta[..., 0, :])
        return r[..., None, :]

    def curvature(self, eta, xi):
        r = 2.0 * xi * torch.sigmoid(-2.0 * xi * eta[..., 0, :])
        kap = r * (2.0 * xi - r)      # = 4 sigma(2 eta) sigma(-2 eta)
        return kap[..., None, None, :]

    # ---------------------------------------------------- sampling hooks
    def init_draw(self, generator, p: int, device=None):
        u = torch.rand(p, generator=generator, device=resolve_device(device))
        return torch.where(u < 0.5, 1.0, -1.0)

    def cond_draw(self, generator, eta):
        u = torch.rand(eta.shape[:-1], generator=generator,
                       device=eta.device)
        return torch.where(u < torch.sigmoid(2.0 * eta[..., 0]), 1.0, -1.0)

    # ------------------------------------------------------------- model
    def suff_stats(self, graph: Graph, X):
        return I.suff_stats(graph, X)

    # ------------------------------------------------------------ oracle
    def exact_moments(self, graph: Graph, theta) -> np.ndarray:
        mu, _ = I.exact_moments(graph, theta)
        return mu.cpu().numpy()

    def exact_sample(self, graph: Graph, theta, n: int, generator):
        from ..sampling import exact_sample
        return exact_sample(I.IsingModel(graph, I.as_tensor(theta)), n,
                            generator)

    def random_params(self, graph: Graph, generator, scale_edge: float = 0.4,
                      scale_node: float = 0.3, device=None):
        return I.random_model(graph, scale_edge, scale_node, generator,
                              device).theta
