"""Graph structures for pairwise graphical models / sensor networks.

A ``Graph`` is an immutable container of ``p`` nodes and undirected edges
``(i, j)`` with ``i < j``. The flat parameter vector of a family on a graph
is ordered ``[node blocks (p*C), edge blocks (m*C)]`` (singletons first,
then edges in ``graph.edges`` order).

Host-side numpy only; the PyTorch port keeps its own copy so that it never
imports the JAX package. Generators are seeded ``np.random.RandomState``
draws and give the same edge tuples as the reference package.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np

Edge = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Graph:
    p: int
    edges: Tuple[Edge, ...]

    def __post_init__(self):
        seen = set()
        for (i, j) in self.edges:
            if not (0 <= i < j < self.p):
                raise ValueError(f"bad edge ({i},{j}) for p={self.p}")
            if (i, j) in seen:
                raise ValueError(f"duplicate edge ({i},{j})")
            seen.add((i, j))

    @property
    def m(self) -> int:
        return len(self.edges)

    @property
    def n_params(self) -> int:
        """Size of the scalar (C = 1) flat parameter vector."""
        return self.p + self.m

    @property
    def adjacency(self) -> np.ndarray:
        A = np.zeros((self.p, self.p), dtype=np.float32)
        if self.edges:
            e = np.asarray(self.edges, dtype=np.int64)
            A[e[:, 0], e[:, 1]] = 1.0
            A[e[:, 1], e[:, 0]] = 1.0
        return A

    @property
    def edge_index(self) -> Dict[Edge, int]:
        """Edge -> position in the edge block of the flat parameter vector."""
        return {e: k for k, e in enumerate(self.edges)}

    def neighbors(self, i: int) -> List[int]:
        return sorted(_incidence(self)[1][i])

    def degree(self, i: int) -> int:
        return len(_incidence(self)[0][i])

    def incident_edges(self, i: int) -> List[int]:
        """Edge-block indices of edges touching node i (in edges order)."""
        return list(_incidence(self)[0][i])

    def beta(self, i: int, include_singleton: bool = True) -> List[int]:
        """Flat-parameter indices in beta_i = {alpha : i in alpha}."""
        idx = [i] if include_singleton else []
        idx += [self.p + k for k in self.incident_edges(i)]
        return idx

    def greedy_coloring(self) -> np.ndarray:
        """Proper vertex coloring, greedy largest-degree-first.

        Returns a (p,) int array of color ids in [0, n_colors); nodes of one
        color are mutually non-adjacent, so a Gibbs sweep may update a whole
        color class at once.
        """
        return _greedy_coloring_cached(self).copy()


def _incidence(graph: Graph):
    """Per node: incident edge indices (edge order) and the other endpoints,
    built in one O(m) pass and kept on the graph instance.

    The reference scans every edge per node (O(p*m)). A cache keyed by the
    graph would not do either: hashing a frozen graph hashes its whole edge
    tuple, which at p in the thousands made the per-node lookups of one fit
    cost most of its wall time.
    """
    found = graph.__dict__.get("_incidence")
    if found is not None:
        return found
    inc: List[List[int]] = [[] for _ in range(graph.p)]
    oth: List[List[int]] = [[] for _ in range(graph.p)]
    for k, (a, b) in enumerate(graph.edges):
        inc[a].append(k)
        oth[a].append(b)
        inc[b].append(k)
        oth[b].append(a)
    found = (tuple(tuple(v) for v in inc), tuple(tuple(v) for v in oth))
    object.__setattr__(graph, "_incidence", found)
    return found


@functools.lru_cache(maxsize=64)
def _greedy_coloring_cached(graph: Graph) -> np.ndarray:
    nbrs = {i: set() for i in range(graph.p)}
    for (a, b) in graph.edges:
        nbrs[a].add(b)
        nbrs[b].add(a)
    colors = np.full(graph.p, -1, dtype=np.int64)
    order = sorted(range(graph.p), key=lambda i: -len(nbrs[i]))
    for i in order:
        used = {colors[j] for j in nbrs[i] if colors[j] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


# ---------------------------------------------------------------- factories
def chain_graph(p: int) -> Graph:
    return Graph(p, tuple((i, i + 1) for i in range(p - 1)))


def star_graph(p: int) -> Graph:
    """Node 0 is the hub; nodes 1..p-1 are leaves."""
    return Graph(p, tuple((0, i) for i in range(1, p)))


def grid_graph(rows: int, cols: int) -> Graph:
    edges = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                edges.append((i, i + 1))
            if r + 1 < rows:
                edges.append((i, i + cols))
    return Graph(rows * cols, tuple(sorted(set(edges))))


def complete_graph(p: int) -> Graph:
    return Graph(p, tuple((i, j) for i in range(p) for j in range(i + 1, p)))


def scale_free_graph(p: int, m: int = 1, seed: int = 0) -> Graph:
    """Barabasi-Albert preferential attachment (Barabasi & Albert, 1999)."""
    rng = np.random.RandomState(seed)
    edges = set()
    degrees = np.zeros(p, dtype=np.int64)
    for i in range(m + 1):
        for j in range(i + 1, m + 1):
            edges.add((i, j))
            degrees[i] += 1
            degrees[j] += 1
    for new in range(m + 1, p):
        targets = set()
        while len(targets) < m:
            probs = degrees[:new] / degrees[:new].sum()
            t = int(rng.choice(new, p=probs))
            targets.add(t)
        for t in targets:
            edges.add((min(t, new), max(t, new)))
            degrees[t] += 1
            degrees[new] += 1
    return Graph(p, tuple(sorted(edges)))


def euclidean_graph(p: int, radius: float = 0.15, seed: int = 0) -> Graph:
    """Random geometric graph on [0,1]^2 connecting nodes within ``radius``."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(p, 2)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    edges = tuple(
        (i, j) for i in range(p) for j in range(i + 1, p)
        if d2[i, j] <= radius ** 2
    )
    return Graph(p, edges)
