"""Gaussian MRF family: unit-conditional-variance Gauss-Markov field.

The node conditionals are x_i | x_N(i) ~ N(h_i + sum_j T_ij x_j, 1), so each
local CL fit is a least-squares solve: the curvature hook is the constant 1
and the Newton engine converges in one step.
"""
from __future__ import annotations

import dataclasses
import math

import torch

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
