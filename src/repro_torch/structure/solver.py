"""Warm-started group-lasso regularization paths over candidate edges.

Neighborhood selection is p independent penalized conditional fits

    max_w  l^i(w)  -  lambda * sum_{edge blocks b} ||w_b||_2,

one per node, over the candidate graph: the paper's local CL objectives
plus a group penalty on the C-wide edge blocks. All of them are solved at
once by ADMM splitting on the batched engine:

  w-update — the smooth proximal solve is
             :func:`repro_torch.core.batched.prox_update_flat` (quadratic
             penalty ``rho/2 (w - (z - u))^2``, zero linear term): one damped
             Newton solve per degree bucket, each iteration one Newton-kernel
             launch on the card;
  z-update — :func:`repro_torch.core.batched.group_soft_threshold_flat`
             over every node's vector at once (threshold lambda/rho), where
             exact zeros appear, so the support is read off z with no
             epsilon;
  u-update — scaled dual ascent.

(w, z, u) are flat float64 arrays in :func:`~repro_torch.core.batched.
local_layout` order, so a round costs one prox call and a few vectorised
numpy passes, not a loop over nodes. The lambda grid is walked
coldest-first (largest lambda, sparsest model), each lambda's (w, z, u)
seeding the next. A ``lambda == 0`` grid entry short-circuits to the
caller's dense unpenalized fit, which pins the path's dense end to the fit
verb.

Model selection is extended BIC over the path (Chen & Chen 2008; Foygel &
Drton 2010 for graphical models): per node,

    EBIC_i(lambda) = -2 n ll_i + df_i (log n + 2 gamma log(p - 1)),

summed over nodes; ``ll_i`` is node i's average conditional loglik at its
iterate and ``df_i`` counts selected edge-block scalars.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.batched import (degree_buckets, group_soft_threshold_flat,
                            local_layout, prox_update_flat)
from ..core.graphs import Graph
from .spec import StructureSpec

__all__ = ["auto_lambda_grid", "lasso_path", "node_logliks", "ebic_scores",
           "edge_supports", "debias_to_support"]

#: float64 elements of one gathered neighbour-feature chunk in
#: :func:`node_logliks` (1 GiB)
_GATHER_ELEMS = 1 << 27


@functools.lru_cache(maxsize=64)
def _edge_blocks(graph: Graph, family, include_singleton: bool):
    """(node, edge, slot) of every (node, incident edge) block in node order
    and ``graph.incident_edges`` order: the block's node, its edge id, and
    its first slot in :func:`local_layout`'s flat vector of all nodes'
    local vectors. Read-only arrays."""
    off, _ = local_layout(graph, family, include_singleton)
    C, lead = family.block_dim, int(include_singleton)
    deg = np.array([len(graph.incident_edges(i)) for i in range(graph.p)],
                   dtype=np.int64)
    node = np.repeat(np.arange(graph.p, dtype=np.int64), deg)
    edge = np.asarray([k for i in range(graph.p)
                       for k in graph.incident_edges(i)], dtype=np.int64)
    pos = np.arange(node.size, dtype=np.int64) \
        - np.repeat(np.cumsum(deg) - deg, deg)
    slot = off[node] + (lead + pos) * C
    for a in (node, edge, slot):
        a.setflags(write=False)
    return node, edge, slot


def _block_norms(flat: np.ndarray, slot: np.ndarray, C: int) -> np.ndarray:
    """Euclidean norm of every C-wide block starting at ``slot``."""
    return np.linalg.norm(flat[slot[:, None] + np.arange(C)], axis=1)


def _flat(vectors: Sequence[np.ndarray]) -> np.ndarray:
    return (np.concatenate([np.asarray(v, dtype=np.float64) for v in vectors])
            if len(vectors) else np.zeros(0))


def auto_lambda_grid(graph: Graph, X, family,
                     spec: StructureSpec) -> Tuple[float, ...]:
    """Geometric lambda grid scaled to the data, descending.

    lambda_max is the group-lasso activation bound: the largest candidate
    edge-block norm of the average-pseudo-loglik gradient at theta = 0,
    ``max_(i,j) ||(1/n) sum_t dl/deta_c(0) f_c(x_j)||_2`` over both
    orientations, the smallest lambda at which every edge block of the
    penalized solution is exactly zero. The grid is ``n_lambdas`` points
    geometric down to ``lambda_max * lambda_min_ratio``. Computed in
    float64 on the device ``X`` (a tensor or array) lies on.
    """
    X = torch.as_tensor(X).to(torch.float64)
    n, p = X.shape
    C = family.block_dim
    if not graph.edges:
        return tuple(np.geomspace(1.0, spec.lambda_min_ratio,
                                  spec.n_lambdas))
    F = family.edge_features(X)                                  # (n, p, C)
    eta0 = torch.zeros((p, C, n), dtype=torch.float64, device=X.device)
    r = family.dl_deta(eta0, X.T)                                # (p, C, n)
    # G[c, i, j] = sum_t r[i, c, t] F[t, j, c]
    G = torch.einsum("ict,tjc->cij", r, F)
    e = torch.as_tensor(np.asarray(graph.edges, dtype=np.int64),
                        device=X.device)
    g_ab = G[:, e[:, 0], e[:, 1]].T / n                          # (m, C)
    g_ba = G[:, e[:, 1], e[:, 0]].T / n
    lam_max = max(float(torch.linalg.norm(g_ab, dim=1).max()),
                  float(torch.linalg.norm(g_ba, dim=1).max()))
    lam_max = max(lam_max, 1e-8)
    return tuple(float(l) for l in
                 np.geomspace(lam_max, lam_max * spec.lambda_min_ratio,
                              spec.n_lambdas))


def lasso_path(graph: Graph, X: torch.Tensor, lambdas: Sequence[float],
               spec: StructureSpec, family, *,
               include_singleton: bool = True,
               theta_fixed: Optional[torch.Tensor] = None,
               dense_thetas: Optional[Sequence[np.ndarray]] = None,
               use_kernel: bool = True,
               recorder=None) -> List[List[np.ndarray]]:
    """Walk the descending lambda grid; return per-lambda sparse iterates.

    Returns ``zs[l][i]``: node i's ``family.beta``-ordered iterate at
    ``lambdas[l]``, with exact zeros on unselected edge blocks. The ADMM
    state (w, z, u) carries across lambdas (warm starts); each lambda runs
    at most ``spec.admm_rounds`` rounds with a primal/dual residual early
    stop at ``spec.admm_tol``. A ``lambda == 0`` entry copies
    ``dense_thetas`` (the caller's unpenalized fit on the same candidate
    graph) instead of iterating. ``X`` is an (n, p) tensor on the device
    the prox solves run on; ``use_kernel=False`` asks for the plain Newton
    statistics; a telemetry ``recorder`` gets every round's
    ``prox_bucket_solve`` spans.
    """
    C = family.block_dim
    lead = 1 if include_singleton else 0
    off, _ = local_layout(graph, family, include_singleton)
    size = int(off[-1])
    w, z, u = np.zeros(size), np.zeros(size), np.zeros(size)
    zero_lam = np.zeros(size)
    rho = float(spec.admm_rho)
    rho_vec = np.full(size, rho)

    out: List[List[np.ndarray]] = []
    for lam in lambdas:
        if lam == 0.0:
            if dense_thetas is None:
                raise ValueError(
                    "lambda == 0 in the grid needs dense_thetas — the "
                    "unpenalized fit on the candidate graph (session."
                    "select supplies it automatically)")
            z = _flat(dense_thetas)
            w = z.copy()
            u = np.zeros_like(z)
            out.append(np.split(z.copy(), off[1:-1]))
            continue
        thr = lam / rho
        for _ in range(spec.admm_rounds):
            w = prox_update_flat(
                graph, X, z - u, zero_lam, rho_vec, w, include_singleton,
                theta_fixed, None, spec.newton_iters, family, use_kernel,
                recorder).astype(np.float64)
            z_old = z
            z = group_soft_threshold_flat(w + u, thr, C, off, lead)
            u = u + w - z
            r_prim = float(np.abs(w - z).max()) if size else 0.0
            s_dual = rho * (float(np.abs(z - z_old).max()) if size else 0.0)
            if max(r_prim, s_dual) < spec.admm_tol:
                break
        out.append(np.split(z.copy(), off[1:-1]))
    return out


def edge_supports(graph: Graph, zs: Sequence[np.ndarray], family,
                  include_singleton: bool = True) -> np.ndarray:
    """(p, m) bool: does node i's iterate select candidate edge k?

    Reads exact zeros off the thresholded iterates: block norm > 0 means
    selected. Rows are only meaningful for edges incident to the node.
    """
    node, edge, slot = _edge_blocks(graph, family, include_singleton)
    sup = np.zeros((graph.p, graph.m), dtype=bool)
    sup[node, edge] = _block_norms(_flat(zs), slot, family.block_dim) > 0.0
    return sup


def vote_masses(graph: Graph, fits, family,
                include_singleton: bool = True) -> np.ndarray:
    """(p, m) vote mass of node i on candidate edge k: the inverse sandwich
    variance of its edge block (the mean of the block's V diagonal, floored
    at 1e-12) from the dense fit's ``fits``; 1 where k is not incident to
    i."""
    node, edge, slot = _edge_blocks(graph, family, include_singleton)
    mass = np.ones((graph.p, graph.m))
    dv = _flat([np.diag(np.asarray(f.V)) for f in fits])
    blk = dv[slot[:, None] + np.arange(family.block_dim)].mean(axis=1)
    mass[node, edge] = 1.0 / np.maximum(blk, 1e-12)
    return mass


def debias_to_support(graph: Graph, zs: Sequence[np.ndarray],
                      dense_thetas: Sequence[np.ndarray], family,
                      include_singleton: bool = True) -> List[np.ndarray]:
    """Dense estimates masked to each iterate's support: refit-free
    debiasing.

    The lasso iterate's support is right but its surviving blocks are
    shrunk toward zero, so scoring a path point at z itself makes sparse
    models look worse than they are. This keeps the unpenalized fit's
    values on the selected blocks and exact zeros elsewhere.
    """
    C = family.block_dim
    _, _, slot = _edge_blocks(graph, family, include_singleton)
    t = _flat(dense_thetas).copy()
    drop = slot[_block_norms(_flat(zs), slot, C) == 0.0]
    t[(drop[:, None] + np.arange(C)).ravel()] = 0.0
    lens = [len(np.asarray(d)) for d in dense_thetas]
    return np.split(t, np.cumsum(lens)[:-1])


def node_logliks(graph: Graph, X, zs: Sequence[np.ndarray], family,
                 include_singleton: bool = True,
                 theta_fixed=None) -> np.ndarray:
    """(p,) average conditional loglik of each node at its own iterate.

    Evaluated with the family's closed-form channel likelihood on the
    node's beta-ordered local vector, in float64 on the device ``X`` (a
    tensor or array) lies on, one batch per degree bucket: eta of a bucket's
    k nodes is the lead block (or the fixed singleton) plus the gathered
    neighbour features times the edge blocks.
    """
    X = torch.as_tensor(X).to(torch.float64)
    n, p = X.shape
    dev = X.device
    C = family.block_dim
    lead = 1 if include_singleton else 0
    F = family.edge_features(X)                                  # (n, p, C)
    node_tf = (None if theta_fixed is None else torch.as_tensor(
        np.asarray(theta_fixed, dtype=np.float64)[: p * C].reshape(p, C),
        device=dev))
    off, _ = local_layout(graph, family, include_singleton)
    flat = _flat(zs)
    out = np.zeros(p)
    for b in degree_buckets(graph):
        d = b.deg_pad
        degs = b.mask.sum(axis=1).astype(np.int64)
        # (k, lead + d, C) local vectors, zeros on padded blocks
        cols = np.arange((lead + d) * C)[None, :]
        valid = cols < ((lead + degs) * C)[:, None]
        idx = np.where(valid, off[b.nodes][:, None] + cols, 0)
        Z = torch.as_tensor(np.where(valid, flat[idx], 0.0),
                            device=dev).reshape(len(b.nodes), lead + d, C)
        step = max(1, _GATHER_ELEMS // max(1, d * n * C))
        for s in range(0, len(b.nodes), step):
            rows = slice(s, s + step)
            nodes = torch.as_tensor(b.nodes[rows], dtype=torch.int64,
                                    device=dev)
            nbrs = torch.as_tensor(b.nbrs[rows], dtype=torch.int64,
                                   device=dev)
            Zr = Z[rows]
            eta = torch.einsum("nkdc,kdc->kcn", F[:, nbrs, :], Zr[:, lead:])
            if lead:
                eta = eta + Zr[:, 0, :, None]
            elif node_tf is not None:
                eta = eta + node_tf[nodes][:, :, None]
            ll = family.loglik_eta(eta, X[:, nodes].T)           # (k, n)
            out[b.nodes[rows]] = ll.mean(dim=1).cpu().numpy()
    return out


def ebic_scores(graph: Graph, X, path: Sequence[Sequence[np.ndarray]],
                family, spec: StructureSpec,
                include_singleton: bool = True,
                theta_fixed=None,
                debias_thetas: Optional[Sequence[np.ndarray]] = None
                ) -> np.ndarray:
    """Extended-BIC score of every path point (lower is better).

    With ``debias_thetas`` (the dense unpenalized fit on the same graph)
    each point's likelihood is evaluated at the support-masked dense
    estimates (:func:`debias_to_support`) instead of the shrunk iterates.
    """
    n, p = X.shape
    C = family.block_dim
    complexity = math.log(n) + 2.0 * spec.ebic_gamma * math.log(max(p - 1, 1))
    scores = np.zeros(len(path))
    for l, zs in enumerate(path):
        ts = (debias_to_support(graph, zs, debias_thetas, family,
                                include_singleton)
              if debias_thetas is not None else zs)
        ll = node_logliks(graph, X, ts, family, include_singleton,
                          theta_fixed)
        sup = edge_supports(graph, zs, family, include_singleton)
        df = C * sup.sum(axis=1)                                # (p,)
        scores[l] = float(np.sum(-2.0 * n * ll + df * complexity))
    return scores
