"""Ising family: C = 1 logistic node conditionals over x in {-1, +1}."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

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
