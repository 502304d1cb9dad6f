"""q-state Potts family with state-dependent couplings.

States x_i in {0, ..., q-1}; state 0 is the reference. Channel c = 1..q-1
(stored as index c-1) has features 1[x = c], so the node conditionals are
multinomial logistic channels with the reference channel's logit fixed at 0:

    p(x_i = c | x_N(i)) proportional to exp( theta_{i,c}
        + sum_{j in N(i)} theta_{ij,c} 1[x_j = c] ),   p(x_i = 0) prop. 1.

Samples are float tensors of integer states.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelFamily


@dataclasses.dataclass(frozen=True)
class PottsFamily(ModelFamily):
    q: int = 3
    name: str = "potts"

    def __post_init__(self):
        if self.q < 2:
            raise ValueError("Potts needs q >= 2 states")

    @property
    def kernel_kind(self) -> str:
        return "potts"

    @property
    def block_dim(self) -> int:
        return self.q - 1

    def _chans(self, x):
        return torch.arange(1, self.q, dtype=x.dtype, device=x.device)

    def edge_features(self, x):
        return (x[..., None] == self._chans(x)).to(x.dtype)

    def _extended(self, eta):
        """Prepend the reference channel's zero logit: (..., C, n) ->
        (..., q, n)."""
        return torch.cat([torch.zeros_like(eta[..., :1, :]), eta], dim=-2)

    def loglik_eta(self, eta, xi):
        ez = self._extended(eta)
        lse = torch.logsumexp(ez, dim=-2)
        idx = torch.clamp(xi.to(torch.int64), 0, self.q - 1)
        idx = idx.expand(ez.shape[:-2] + idx.shape[-1:])
        sel = torch.gather(ez, -2, idx[..., None, :])[..., 0, :]
        return sel - lse

    def _pi(self, eta):
        return torch.softmax(self._extended(eta), dim=-2)[..., 1:, :]

    def dl_deta(self, eta, xi):
        chans = self._chans(xi)
        shape = (1,) * (xi.ndim - 1) + (self.q - 1, 1)
        y = (xi[..., None, :] == chans.reshape(shape)).to(eta.dtype)
        return y - self._pi(eta)

    def curvature(self, eta, xi):
        pi = self._pi(eta)                                   # (..., C, n)
        eye = torch.eye(self.q - 1, dtype=eta.dtype,
                        device=eta.device)[..., :, :, None]
        diag = pi[..., :, None, :] * eye
        return diag - pi[..., :, None, :] * pi[..., None, :, :]
