"""One-step consensus combiners (paper Sec. 3.1, Eq. 4-5, 7).

``combine(graph, fits, scheme)`` is the legacy facade kept for the seed
API; schemes now live as pluggable strategy objects in the combiner
registry (:mod:`repro_torch.core.combiners` — ``register_combiner`` /
``get_combiner`` / ``registered_combiners``), which is what the
estimation-plan API (:mod:`repro_torch.api`), the streaming simulator, and the
conformance harness dispatch through. An unknown scheme name raises a
``ValueError`` listing the registered combiners.

Schemes (see :mod:`repro_torch.core.combiners` for the strategy objects):
  uniform        — Linear-Uniform, w = 1
  diagonal       — Linear-Diagonal, w^i_a = 1 / Vhat^i_aa        (Prop 4.7)
  optimal        — Linear-Opt,     w_a = Vhat_a^{-1} e           (Prop 4.6)
  max            — Max-Diagonal,   pick argmax 1 / Vhat^i_aa     (Prop 4.4)
  weighted_vote  — variance-weighted voting (weighted median)    (2014)
  matrix         — matrix consensus with W^i = Hhat^i (Eq. 7)    (Cor 4.2)
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .combiners import TRUST_RADIUS, get_combiner  # noqa: F401  (shared)
from .estimators import LocalFit
from .graphs import Graph

#: the seed's scheme tuple, kept name-stable; the full live axis is
#: ``repro_torch.core.combiners.registered_combiners()``
SCHEMES = ("uniform", "diagonal", "optimal", "max", "matrix")


def empirical_cross_cov(fits: List[LocalFit],
                        owners_a: List[Tuple[int, int]]) -> np.ndarray:
    """Vhat_alpha: sample covariance of influence columns s^i_a (Prop 4.6)."""
    cols = np.stack([fits[i].s[:, pos] for (i, pos) in owners_a], axis=1)
    n = cols.shape[0]
    return cols.T @ cols / n


def combine(graph: Graph, fits: List[LocalFit], scheme: str,
            include_singleton: bool = True,
            theta_fixed: Optional[np.ndarray] = None,
            family=None) -> np.ndarray:
    """One-step consensus estimate; returns the full flat theta vector.

    Thin shim over the combiner registry: resolves ``scheme`` by name
    (raising ``ValueError`` with the registered names on an unknown one)
    and runs the strategy's vectorized grouped driver — numerics are
    unchanged from the historical inline implementation (the 1e-10 golden
    fixtures pin this). See :class:`repro_torch.core.combiners.Combiner`.
    """
    return get_combiner(scheme).combine(
        graph, fits, include_singleton=include_singleton,
        theta_fixed=theta_fixed, family=family)


def mse(theta_hat: np.ndarray, theta_star: np.ndarray,
        free: Optional[Sequence[int]] = None) -> float:
    """||theta_hat - theta*||^2 over the estimated coordinates."""
    d = theta_hat - theta_star
    if free is not None:
        d = d[np.asarray(free)]
    return float(d @ d)
