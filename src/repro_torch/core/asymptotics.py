"""Parameter ownership: which nodes estimate which flat parameters.

Pure Python; the exact-variance oracles of the reference package come in a
later slice of the port.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

from .graphs import Graph


def param_owners(graph: Graph, include_singleton: bool = True,
                 family=None) -> Dict[int, List[Tuple[int, int]]]:
    """flat param index -> [(node i, position of that param in beta_i)].

    With a ``family``, ownership is over parameter *blocks*: every scalar of
    a node block is owned by its node, every scalar of an edge block by both
    endpoints, and positions follow ``family.beta`` block order. The default
    (``family=None``) is the scalar Ising layout. Cached per (graph,
    include_singleton, family); treat the returned dict as read-only.
    """
    return _param_owners_cached(graph, include_singleton, family)


@functools.lru_cache(maxsize=128)
def _param_owners_cached(graph: Graph, include_singleton: bool,
                         family) -> Dict[int, List[Tuple[int, int]]]:
    owners: Dict[int, List[Tuple[int, int]]] = {}
    for i in range(graph.p):
        beta = (graph.beta(i, include_singleton) if family is None
                else family.beta(graph, i, include_singleton))
        for pos, a in enumerate(beta):
            owners.setdefault(a, []).append((i, pos))
    return owners


def free_indices(graph: Graph, include_singleton: bool = True,
                 family=None) -> np.ndarray:
    C = 1 if family is None else family.block_dim
    if include_singleton:
        return np.arange((graph.p + graph.m) * C)
    return np.arange(graph.p * C, (graph.p + graph.m) * C)
