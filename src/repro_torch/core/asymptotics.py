"""Exact asymptotic analysis (paper Sec. 4): per-node information matrices,
influence functions s^i, cross-estimator covariances, and the asymptotic
variance of every consensus scheme — all computed by enumeration at theta*,
in float64 on the device of the model's parameters (per-state gradients
and Hessians through ``torch.func.vmap``); the combination over owners is
host numpy.

Only usable for small p (2^p states); the paper's small-model experiments
(star graphs, 4x4 grid) use exactly this machinery.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, hessian, vmap

from .graphs import Graph
from .ising import (IsingModel, conditional_logits, exact_moments,
                    exact_probs, states_tensor)


@dataclasses.dataclass
class ExactLocal:
    """Population quantities of node i's CL estimator at theta*."""
    i: int
    beta: List[int]     # flat param indices
    H: np.ndarray       # (d, d) -E[grad^2 l^i(theta*)]
    V: np.ndarray       # (d, d) sandwich Hinv J Hinv (= Hinv, info-unbiased)
    S: np.ndarray       # (2^p, d) influence s^i(x) = Hinv grad l^i(theta*, x)
    probs: np.ndarray   # (2^p,) state probabilities


def _state_cond_loglik(graph: Graph, theta, x) -> torch.Tensor:
    """(1, p) conditional logliks of one state x (1, p), written as
    -softplus(-2 x eta), which equals log sigmoid(2 x eta): logsigmoid's
    backward resizes a buffer under vmap, which PyTorch warns is
    deprecated."""
    return -F.softplus(-2.0 * x * conditional_logits(graph, theta, x))


def _sandwich(model: IsingModel, free, per_state_fn):
    """Exact (H, V, S, probs) of the criterion whose value at one state x
    is ``per_state_fn(theta, x)``, over the coordinates ``free`` at
    theta*: G = per-state gradients, H = -E[per-state Hessian],
    J = E[g g^T] (E[g] = 0 at theta*), V = Hinv J Hinv, S = G Hinv^T."""
    theta = model.theta.to(torch.float64)
    states = states_tensor(model.graph.p, theta.device)
    probs = exact_probs(model.graph, theta)
    idx = torch.as_tensor(np.asarray(free, dtype=np.int64),
                          device=theta.device)

    def f(w, x):
        return per_state_fn(theta.index_put((idx,), w), x[None, :])

    w_star = theta[idx]
    # chunks of 4096 states bound the per-state intermediates' memory
    G = vmap(grad(f), in_dims=(None, 0), chunk_size=4096)(
        w_star, states)                                           # (S, d)
    Hs = vmap(hessian(f), in_dims=(None, 0), chunk_size=4096)(
        w_star, states)                                           # (S,d,d)
    H = -torch.einsum("s,sab->ab", probs, Hs)
    J = (G * probs[:, None]).T @ G
    Hinv = torch.linalg.inv(H)
    V = Hinv @ J @ Hinv
    S = G @ Hinv.T
    return tuple(t.cpu().numpy() for t in (H, V, S, probs))


def exact_local(model: IsingModel, i: int,
                include_singleton: bool = True) -> ExactLocal:
    """Node i's CL estimator at theta*: its exact H, sandwich V and
    influence functions over all 2^p states."""
    graph = model.graph
    beta = graph.beta(i, include_singleton)
    H, V, S, probs = _sandwich(
        model, beta, lambda t, x: _state_cond_loglik(graph, t, x)[0, i])
    return ExactLocal(i=i, beta=beta, H=H, V=V, S=S, probs=probs)


def exact_locals(model: IsingModel,
                 include_singleton: bool = True) -> List[ExactLocal]:
    return [exact_local(model, i, include_singleton)
            for i in range(model.graph.p)]


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


# --------------------------------------------- exact consensus covariances
def cross_cov(locals_: List[ExactLocal], a: int,
              owners_a: List[Tuple[int, int]]) -> np.ndarray:
    """V_alpha (Prop 4.6): cov(s^i_a, s^j_a) across owner nodes, exact."""
    probs = locals_[0].probs
    cols = np.stack([locals_[i].S[:, pos] for (i, pos) in owners_a], axis=1)
    return (cols * probs[:, None]).T @ cols


def exact_consensus_variance(model: IsingModel, locals_: List[ExactLocal],
                             scheme: str,
                             include_singleton: bool = True
                             ) -> Tuple[float, Dict[int, float]]:
    """Asymptotic var of one-step consensus per Thm 4.1/4.3 with exact weights.

    scheme in {"uniform", "diagonal", "optimal", "max"}. Returns
    (tr V over free params, per-param variance dict).
    """
    owners = param_owners(model.graph, include_singleton)
    per_param: Dict[int, float] = {}
    for a, own in owners.items():
        Va = cross_cov(locals_, a, own)                  # (k, k)
        diag = np.array([locals_[i].V[pos, pos] for (i, pos) in own])
        k = len(own)
        if scheme == "uniform":
            w = np.ones(k)
        elif scheme == "diagonal":
            w = 1.0 / diag
        elif scheme == "max":
            w = np.zeros(k)
            w[int(np.argmin(diag))] = 1.0                # Prop 4.4
        elif scheme == "optimal":
            w = np.linalg.solve(Va + 1e-12 * np.eye(k), np.ones(k))  # 4.6
        else:
            raise ValueError(scheme)
        w = w / w.sum()
        per_param[a] = float(w @ Va @ w)
    tr = float(sum(per_param.values()))
    return tr, per_param


def exact_joint_mple_variance(model: IsingModel,
                              include_singleton: bool = True
                              ) -> Tuple[float, np.ndarray]:
    """Exact asymptotic covariance of joint MPLE (Godambe sandwich)."""
    graph = model.graph
    free = free_indices(graph, include_singleton)
    _, V, _, _ = _sandwich(
        model, free, lambda t, x: torch.sum(_state_cond_loglik(graph, t, x)))
    return float(np.trace(V)), V


def exact_mle_variance(model: IsingModel,
                       include_singleton: bool = True
                       ) -> Tuple[float, np.ndarray]:
    """Cramer-Rao floor: V = Fisher^-1 on the free block (exact)."""
    _, fisher = exact_moments(model.graph, model.theta)
    free = free_indices(model.graph, include_singleton)
    V = np.linalg.inv(fisher.cpu().numpy()[np.ix_(free, free)])
    return float(np.trace(V)), V


def efficiency(tr_v: float, tr_v_mle: float) -> float:
    """Paper Sec. 5: asymptotic efficiency tr(V)/tr(V_mle) (1 = optimal)."""
    return tr_v / tr_v_mle
