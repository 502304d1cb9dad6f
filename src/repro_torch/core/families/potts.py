"""q-state Potts family with state-dependent couplings.

States x_i in {0, ..., q-1}; state 0 is the reference. Channel c = 1..q-1
(stored as index c-1) has features 1[x = c], so the node conditionals are
multinomial logistic channels with the reference channel's logit fixed at 0:

    p(x_i = c | x_N(i)) proportional to exp( theta_{i,c}
        + sum_{j in N(i)} theta_{ij,c} 1[x_j = c] ),   p(x_i = 0) prop. 1.

Samples are float tensors of integer states. The exact small-p oracle
enumerates all q^p states in float64 on the device of the parameters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import resolve_device
from ..graphs import Graph
from ..ising import as_tensor, edge_index
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

    # ---------------------------------------------------- sampling hooks
    def init_draw(self, generator, p: int, device=None):
        return torch.randint(0, self.q, (p,), generator=generator,
                             device=resolve_device(device)).to(torch.float32)

    def cond_draw(self, generator, eta):
        """A categorical draw over the q states by inverse CDF of the
        softmax (reference channel's logit 0)."""
        ez = torch.cat([torch.zeros_like(eta[..., :1]), eta], dim=-1)
        cdf = torch.softmax(ez, dim=-1).cumsum(dim=-1)
        u = torch.rand(eta.shape[:-1], generator=generator,
                       device=eta.device, dtype=cdf.dtype)
        return (cdf[..., :-1] < u[..., None]).sum(dim=-1).to(torch.float32)

    # ------------------------------------------------------------- model
    def suff_stats(self, graph: Graph, X):
        n = X.shape[0]
        F = self.edge_features(X)                            # (n, p, C)
        node = F.reshape(n, graph.p * self.block_dim)
        if not graph.m:
            return torch.cat([node, X.new_zeros((n, 0))], dim=1)
        rows, cols = edge_index(graph, X.device)
        pair = (F[:, rows, :] * F[:, cols, :]).reshape(
            n, graph.m * self.block_dim)
        return torch.cat([node, pair], dim=1)

    # ------------------------------------------------------------ oracle
    def all_states(self, p: int) -> np.ndarray:
        """(q^p, p) enumeration of all state vectors (small p only)."""
        q = self.q
        idx = np.arange(q ** p, dtype=np.int64)
        return ((idx[:, None] // q ** np.arange(p)[None, :]) % q
                ).astype(np.float32)

    def _state_scores(self, graph: Graph, theta):
        """(u(x) for every state, u(x) . theta), float64 on theta's
        device."""
        theta = as_tensor(theta, dtype=torch.float64)
        states = torch.as_tensor(self.all_states(graph.p),
                                 device=theta.device).to(torch.float64)
        U = self.suff_stats(graph, states)
        return U, U @ theta

    def exact_probs(self, graph: Graph, theta) -> torch.Tensor:
        return torch.softmax(self._state_scores(graph, theta)[1], dim=0)

    def log_partition(self, graph: Graph, theta) -> torch.Tensor:
        return torch.logsumexp(self._state_scores(graph, theta)[1], dim=0)

    def exact_moments(self, graph: Graph, theta) -> np.ndarray:
        U, s = self._state_scores(graph, theta)
        return (torch.softmax(s, dim=0) @ U).cpu().numpy()

    def exact_sample(self, graph: Graph, theta, n: int, generator):
        pr = self.exact_probs(graph, theta)
        idx = torch.multinomial(pr, n, replacement=True, generator=generator)
        states = torch.as_tensor(self.all_states(graph.p), device=pr.device)
        return states[idx]

    def random_params(self, graph: Graph, generator, scale_edge: float = 0.4,
                      scale_node: float = 0.3, device=None):
        dev = resolve_device(device)
        C = self.block_dim
        node = scale_node * torch.randn(graph.p * C, generator=generator,
                                        device=dev, dtype=torch.float64)
        edge = scale_edge * torch.randn(graph.m * C, generator=generator,
                                        device=dev, dtype=torch.float64)
        return torch.cat([node, edge])
