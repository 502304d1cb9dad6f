"""The observer-side any-time diagnostic of the streaming stack.

:func:`pseudo_score` is the exact gradient of the average pseudo-likelihood
at an arbitrary theta, in one fused kernel pass over a (zero-padded) sample
buffer. The :class:`StreamingEstimator` of the reference package comes with
the streaming slice of the port.
"""
from __future__ import annotations

import numpy as np

from ..core.families import ISING
from ..core.graphs import Graph
from ..kernels.cl.epilogues import get_epilogue
from ..kernels.cl.family import fused_pseudo_score


def pseudo_score(graph: Graph, theta: np.ndarray, x_pad, n_seen: int,
                 family=None, use_kernel: bool = True) -> np.ndarray:
    """Exact flat gradient of the average pseudo-likelihood at ``theta``
    over the first ``n_seen`` rows of ``x_pad`` (an (n, p) tensor).

    Families whose ``kernel_kind`` has a registered epilogue (Ising,
    Gaussian, Potts) run one fused pass (see
    :func:`repro_torch.kernels.cl.family.fused_pseudo_score`).
    """
    if family is None:
        family = ISING
    theta = np.asarray(theta, dtype=np.float64)
    if n_seen <= 0:
        return np.zeros(family.n_params(graph))
    if get_epilogue(getattr(family, "kernel_kind", None)) is None:
        raise NotImplementedError(
            f"family {family.name!r} has no fused-kernel epilogue; the "
            f"autodiff pseudo-score comes with the sampler slice of the port")
    return fused_pseudo_score(family, graph, theta, x_pad, n_seen,
                              use_kernel=use_kernel)
