"""The ``ModelFamily`` contract: one estimator interface per exponential
family (Liu & Ihler 2012 Sec. 2; Liu & Ihler 2014; Mizrahi et al. 2014).

Every family is a pairwise exponential-family model over a :class:`~repro_
torch.core.graphs.Graph` whose per-node conditionals are **channelized
GLMs**: node i's conditional given its neighbors is set by a ``(C,)`` vector
of channel logits

    eta_c(x) = theta_{i,c} + sum_{j in N(i)} theta_{ij,c} * f_c(x_j),

where ``C = family.block_dim`` and ``f`` is :meth:`ModelFamily.edge_features`.
The flat parameter vector is ``[node blocks (p*C), edge blocks (m*C)]``.
Families supply closed-form per-channel score ``dl_deta`` and curvature
hooks, which is what lets the degree-bucketed engine
(:mod:`repro_torch.core.batched`) solve every family without autodiff.

Families also supply sampler draws and an exact small-p oracle
(enumeration or closed form), which the samplers' moment checks and the
centralized reference fits (:func:`fit_mple_family`,
:func:`fit_node_oracle`: plain autodiff Newton) stand on. Randomness comes
from an explicit ``torch.Generator`` on the sampling device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..graphs import Graph
from ..ising import as_tensor


class ModelFamily:
    """Abstract base for exponential-family model plugins.

    Subclasses are frozen dataclasses holding only hashable configuration,
    so a family instance can key caches. All tensor math lives in methods.
    """

    name: str

    @property
    def kernel_kind(self) -> Optional[str]:
        """Epilogue key into the fused CL kernel registry
        (:mod:`repro_torch.kernels.cl.epilogues`), or None."""
        return None

    # ------------------------------------------------------------ layout
    @property
    def block_dim(self) -> int:
        """C: size of every per-node and per-edge parameter block."""
        raise NotImplementedError

    def n_params(self, graph: Graph) -> int:
        return (graph.p + graph.m) * self.block_dim

    def node_block(self, graph: Graph, i: int) -> List[int]:
        C = self.block_dim
        return list(range(i * C, (i + 1) * C))

    def edge_block(self, graph: Graph, k: int) -> List[int]:
        C = self.block_dim
        base = graph.p * C
        return list(range(base + k * C, base + (k + 1) * C))

    def beta(self, graph: Graph, i: int,
             include_singleton: bool = True) -> List[int]:
        """Flat indices of the parameters node i estimates, block-ordered:
        singleton block first (when free), then incident-edge blocks in
        ``graph.incident_edges(i)`` order."""
        idx = self.node_block(graph, i) if include_singleton else []
        for k in graph.incident_edges(i):
            idx += self.edge_block(graph, k)
        return idx

    def node_params(self, graph: Graph, theta: torch.Tensor) -> torch.Tensor:
        """(p, C) node blocks of a flat theta."""
        C = self.block_dim
        return theta[: graph.p * C].reshape(graph.p, C)

    def edge_params(self, graph: Graph, theta: torch.Tensor) -> torch.Tensor:
        """(m, C) edge blocks of a flat theta."""
        C = self.block_dim
        return theta[graph.p * C:].reshape(graph.m, C)

    def coupling_tensor(self, graph: Graph,
                        theta: torch.Tensor) -> torch.Tensor:
        """Symmetric (p, p, C) dense coupling tensor from the edge blocks."""
        te = self.edge_params(graph, theta)
        T = torch.zeros((graph.p, graph.p, self.block_dim), dtype=te.dtype,
                        device=te.device)
        if graph.m:
            e = torch.as_tensor(np.asarray(graph.edges, dtype=np.int64),
                                device=te.device)
            T[e[:, 0], e[:, 1]] = te
            T[e[:, 1], e[:, 0]] = te
        return T

    # ----------------------------------------------------- channel hooks
    def edge_features(self, x: torch.Tensor) -> torch.Tensor:
        """Per-channel feature of a neighbor's value: (...,) -> (..., C)."""
        raise NotImplementedError

    def loglik_eta(self, eta: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """Per-sample conditional loglik: eta (..., C, n), xi (..., n) ->
        (..., n)."""
        raise NotImplementedError

    def dl_deta(self, eta: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """Closed-form d loglik / d eta: (..., C, n)."""
        raise NotImplementedError

    def curvature(self, eta: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """Closed-form -d^2 loglik / d eta^2, PSD: (..., C, C, n)."""
        raise NotImplementedError

    # --------------------------------------------------- sampling hooks
    def init_draw(self, generator: torch.Generator, p: int,
                  device=None) -> torch.Tensor:
        """(p,) initial Gibbs state on ``resolve_device(device)``, every
        site drawn independently (so n states are one draw of n * p)."""
        raise NotImplementedError

    def cond_draw(self, generator: torch.Generator,
                  eta: torch.Tensor) -> torch.Tensor:
        """Draw node values from conditionals: eta (..., C) -> (...)."""
        raise NotImplementedError

    # ------------------------------------------------------------ model
    def suff_stats(self, graph: Graph, X: torch.Tensor) -> torch.Tensor:
        """u(x): (n, n_params) in flat block order."""
        raise NotImplementedError

    def cond_logits(self, graph: Graph, theta: torch.Tensor,
                    X: torch.Tensor) -> torch.Tensor:
        """All-node channel logits: (n, p, C)."""
        h = self.node_params(graph, theta)                   # (p, C)
        Tc = self.coupling_tensor(graph, theta)              # (p, p, C)
        F = self.edge_features(X)                            # (n, p, C)
        return h[None] + torch.einsum("njc,jic->nic", F, Tc)

    def cond_loglik(self, graph: Graph, theta: torch.Tensor,
                    X: torch.Tensor) -> torch.Tensor:
        """Per-node conditional loglik log p(x_i | x_N(i)): (n, p)."""
        eta = self.cond_logits(graph, theta, X)              # (n, p, C)
        ll = self.loglik_eta(eta.permute(1, 2, 0), X.T)      # (p, n)
        return ll.T

    def pseudo_loglik(self, graph: Graph, theta: torch.Tensor,
                      X: torch.Tensor) -> torch.Tensor:
        """Average pseudo-likelihood (Eq. 2 generalized)."""
        return torch.mean(torch.sum(self.cond_loglik(graph, theta, X), dim=1))

    def pseudo_score(self, graph: Graph, theta, X) -> np.ndarray:
        """Reference flat gradient of the average pseudo-likelihood, by
        ``torch.autograd`` in float32 on the device of ``X``."""
        X = as_tensor(X, dtype=torch.float32)
        t = torch.tensor(np.asarray(theta, dtype=np.float32),
                         device=X.device, requires_grad=True)
        (g,) = torch.autograd.grad(self.pseudo_loglik(graph, t, X), t)
        return g.detach().cpu().numpy().astype(np.float64)

    # ------------------------------------------------------------ oracle
    def exact_moments(self, graph: Graph, theta) -> np.ndarray:
        """E[u(x)] under p(x | theta) — small p / closed form only."""
        raise NotImplementedError

    def exact_sample(self, graph: Graph, theta, n: int,
                     generator: torch.Generator) -> torch.Tensor:
        """n iid samples from the exact joint (small p / closed form), on
        the device of ``theta``."""
        raise NotImplementedError

    def random_params(self, graph: Graph, generator: torch.Generator,
                      scale_edge: float = 0.4, scale_node: float = 0.3,
                      device=None) -> torch.Tensor:
        """A valid random flat float64 theta on ``resolve_device(device)``
        (families enforce their own constraints, e.g. the Gaussian
        precision staying PD)."""
        raise NotImplementedError

    def sample(self, graph: Graph, theta, n: int, generator: torch.Generator,
               burnin: int = 200, thin: int = 5,
               n_chains: int = 8) -> torch.Tensor:
        """Default sampler: family-generic chromatic Gibbs."""
        from ..sampling import gibbs_sample_family
        return gibbs_sample_family(self, graph, theta, n, generator,
                                   burnin=burnin, thin=thin,
                                   n_chains=n_chains)


# ---------------------------------------------------------------- generic
def random_rows(family: ModelFamily, generator: torch.Generator, n: int,
                p: int, device=None) -> torch.Tensor:
    """(n, p) iid rows of *valid* node values via ``family.init_draw``.

    The family-generic cheap sample source for well-typed data (spin
    signs, reals, Potts states) without draws from any particular joint
    model.
    """
    return family.init_draw(generator, n * p, device).reshape(n, p)


# Reference fits shared by every family: plain autodiff Newton on the
# family criteria. Slow but definitionally correct.
def fit_mple_family(family: ModelFamily, graph: Graph, X,
                    free_idx: Optional[Sequence[int]] = None,
                    theta_fixed=None, n_iter: int = 40) -> np.ndarray:
    """Centralized joint MPLE for any family; returns full flat theta.
    Runs on the device of ``X`` (a tensor; anything else goes to the
    card)."""
    from ..estimators import fit_free
    X = as_tensor(X)
    return fit_free(lambda t: family.pseudo_loglik(graph, t, X), X,
                    family.n_params(graph), free_idx, theta_fixed, n_iter)


def fit_node_oracle(family: ModelFamily, graph: Graph, X, i: int,
                    include_singleton: bool = True, theta_fixed=None,
                    n_iter: int = 40) -> np.ndarray:
    """Node i's local CL fit by autodiff Newton — the per-node oracle.

    Returns the ``family.beta(graph, i, include_singleton)``-ordered local
    parameter vector (block layout identical to the batched engine's).
    """
    from ..estimators import newton_maximize, node_design
    C = family.block_dim
    X = as_tensor(X)
    theta_fixed = (torch.zeros(family.n_params(graph), dtype=X.dtype,
                               device=X.device)
                   if theta_fixed is None
                   else as_tensor(theta_fixed, X.device, X.dtype))
    F = family.edge_features(node_design(graph, X, i))      # (n, deg, C)
    xi = X[:, i]
    lead = 1 if include_singleton else 0
    d = (lead + F.shape[1]) * C
    offset = theta_fixed[family.node_block(graph, i)]

    def fun(w):
        Wb = w.reshape(lead + F.shape[1], C)
        eta = torch.einsum("njc,jc->nc", F, Wb[lead:])       # (n, C)
        eta = eta + (Wb[0][None, :] if include_singleton
                     else offset[None, :])
        return torch.mean(family.loglik_eta(eta.T, xi))

    w = newton_maximize(fun, X.new_zeros(d), n_iter=n_iter)
    return w.cpu().numpy()
