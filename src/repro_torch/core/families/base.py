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

This slice carries the layout and channel hooks; samplers, exact oracles
and ``random_params`` come with the sampler slice.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..graphs import Graph


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
