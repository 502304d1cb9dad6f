"""M-estimators for Ising models: local conditional-likelihood (CL) fits,
joint MPLE, and exact MLE (paper Sec. 2.2-2.3, Sec. 3).

Every estimator is a Newton maximizer of a concave criterion, with
gradients and Hessians from ``torch.func``. Parameters are flat vectors
over [singletons, edges]; ``free_idx`` selects the coordinates being
estimated (the paper's small experiments fix the singletons). Estimators
run on the device of the samples they are given: a tensor stays where it
is, anything else goes to the CUDA card. ``fit_all_local``'s default
``method="batched"`` is the session's degree-bucketed engine, which takes
its Newton statistics from the CUDA kernel on the card.

The per-node record :class:`LocalFit` holds numpy arrays, as the
reference engine returns them, so the host-side combiners run unchanged on
either package's fits.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, jacrev

from .graphs import Graph
from .ising import as_tensor, log_partition, pseudo_loglik, suff_stats


@dataclasses.dataclass
class LocalFit:
    """Result of one sensor's local estimator (paper Eq. 3) + diagnostics."""
    i: int
    beta: List[int]            # flat parameter indices this node estimates
    theta: np.ndarray          # (d,) local estimate theta^i_{beta_i}
    H: np.ndarray              # (d, d) empirical Hessian  -mean grad^2
    J: np.ndarray              # (d, d) empirical Fisher    mean g g^T
    V: np.ndarray              # (d, d) sandwich H^-1 J H^-1
    s: np.ndarray              # (n, d) influence H^-1 grad l(theta_hat; x_k)


# ---------------------------------------------------------------- solvers
def hessian(fun):
    """w -> the Hessian of ``fun`` at w, reverse over reverse: at these
    widths it runs in about half the time of ``torch.func.hessian``'s
    forward over reverse, whose forward-mode rules go through Python
    decompositions on every call."""
    return jacrev(grad(fun))


def newton_maximize(fun, w0: torch.Tensor, n_iter: int = 40,
                    ridge: float = 1e-8, max_step: float = 5.0
                    ) -> torch.Tensor:
    """Maximize a (strictly) concave ``fun`` by ``n_iter`` damped Newton
    iterations (no early exit), each step capped at norm ``max_step``."""
    g_fn, h_fn = grad(fun), hessian(fun)
    eye = torch.eye(w0.shape[0], dtype=w0.dtype, device=w0.device)
    w = w0
    for _ in range(n_iter):
        H = h_fn(w) - ridge * eye          # keep negative definite
        # no error check (as the reference): a singular H gives non-finite
        # steps rather than an exception, and the card needs no sync
        d = torch.linalg.solve_ex(H, g_fn(w))[0]  # Newton step is w - d
        norm = torch.linalg.norm(d)
        d = torch.where(norm > max_step, d * (max_step / (norm + 1e-30)), d)
        w = w - d
    return w


# ---------------------------------------------------------- local CL fits
def node_design(graph: Graph, X: torch.Tensor, i: int) -> torch.Tensor:
    """Neighbor design matrix Z (n, deg(i)) ordered like incident_edges(i)."""
    others = [graph.edges[k][0] if graph.edges[k][1] == i
              else graph.edges[k][1] for k in graph.incident_edges(i)]
    return X[:, others] if others else X.new_zeros((X.shape[0], 0))


def _cl_objective(Z: torch.Tensor, xi: torch.Tensor, offset,
                  include_singleton: bool):
    """(fun, d): average conditional loglik of one node's CL criterion.

    ``w`` is ordered singleton-first (when free) then incident-edge
    couplings; ``offset`` is the fixed singleton theta_i otherwise.
    """
    if include_singleton:
        def fun(w):
            eta = w[0] + Z @ w[1:]
            return torch.mean(F.logsigmoid(2.0 * xi * eta))
        d = 1 + Z.shape[1]
    else:
        def fun(w):
            eta = offset + Z @ w
            return torch.mean(F.logsigmoid(2.0 * xi * eta))
        d = Z.shape[1]
    return fun, d


def node_cl_fn(graph: Graph, X: torch.Tensor, i: int,
               include_singleton: bool, theta_fixed: torch.Tensor):
    """Returns (fun, d) where fun(w) is node i's average conditional loglik.

    ``w`` is ordered as ``graph.beta(i, include_singleton)``: singleton first
    (if free) then incident-edge couplings.
    """
    Z = node_design(graph, X, i)
    return _cl_objective(Z, X[:, i], theta_fixed[i], include_singleton)


def _solve_cl(Z: torch.Tensor, xi: torch.Tensor, offset,
              include_singleton: bool, n_iter: int):
    """Node i's local CL solve: returns (w, H, J, V, s). ``offset`` is the
    fixed singleton theta_i (only used when include_singleton=False)."""
    n = Z.shape[0]
    fun, d = _cl_objective(Z, xi, offset, include_singleton)
    w = newton_maximize(fun, Z.new_zeros(d), n_iter=n_iter)

    # per-sample score at w_hat; dl/deta = 2 x sigmoid(-2 x eta)
    eta = (w[0] + Z @ w[1:]) if include_singleton else (offset + Z @ w)
    r = 2.0 * xi * torch.sigmoid(-2.0 * xi * eta)            # (n,)
    G = r[:, None] * Z                                       # (n, deg)
    if include_singleton:
        G = torch.cat([r[:, None], G], dim=1)                # (n, d)
    J = (G.T @ G) / n
    H = -hessian(fun)(w)
    Hinv = torch.linalg.inv(H + 1e-9 * torch.eye(d, dtype=Z.dtype,
                                                 device=Z.device))
    V = Hinv @ J @ Hinv
    s = G @ Hinv.T
    return w, H, J, V, s


def fit_local_cl(graph: Graph, X, i: int, include_singleton: bool = True,
                 theta_fixed=None, n_iter: int = 40) -> LocalFit:
    """Fit node i's conditional-likelihood M-estimator and its asymptotics."""
    X = as_tensor(X)
    theta_fixed = (X.new_zeros(graph.n_params) if theta_fixed is None
                   else as_tensor(theta_fixed, X.device, X.dtype))
    Z = node_design(graph, X, i)
    w, H, J, V, s = _solve_cl(Z, X[:, i], theta_fixed[i], include_singleton,
                              n_iter)
    w, H, J, V, s = (t.cpu().numpy() for t in (w, H, J, V, s))
    return LocalFit(i=i, beta=graph.beta(i, include_singleton), theta=w,
                    H=H, J=J, V=V, s=s)


def fit_all_local_loop(graph: Graph, X, include_singleton: bool = True,
                       theta_fixed=None) -> List[LocalFit]:
    """Seed per-node loop with autodiff Hessians, kept as the reference
    path; ``fit_all_local`` dispatches to the degree-bucketed engine."""
    X = as_tensor(X)
    return [fit_local_cl(graph, X, i, include_singleton, theta_fixed)
            for i in range(graph.p)]


def fit_all_local(graph: Graph, X, include_singleton: bool = True,
                  theta_fixed=None, method: str = "batched",
                  sample_weight=None, warm_start: Optional[Sequence] = None,
                  family=None) -> List[LocalFit]:
    """Fit all p local CL estimators.

    Thin shim over the estimation-plan API: method="batched" (default)
    builds the equivalent default :class:`repro_torch.api.Plan` and runs
    the cached session's local-fit engine on the device of ``X`` (degree
    buckets, each solved by damped Newton on the Newton kernel's
    statistics on the card). method="loop" is the seed per-node Ising path
    (autodiff). ``sample_weight``, ``warm_start`` and ``family`` are
    extensions of the batched engine — see
    :func:`repro_torch.core.batched.fit_all_local_batched`; the loop path
    does not support them.
    """
    if method == "batched":
        from .families import get_family
        X = as_tensor(X)
        fam_name = "ising" if family is None else getattr(family, "name", "")
        try:
            registered = family is None or get_family(fam_name) is family
        except KeyError:
            registered = False
        if registered:
            from ..api import Plan
            from ..api.session import EstimationSession
            plan = Plan(graph=graph, family=fam_name,
                        include_singleton=include_singleton)
            sess = EstimationSession.for_plan(plan, device=X.device)
            return sess.fit_local(X, sample_weight=sample_weight,
                                  warm_start=warm_start, want_influence=True,
                                  theta_fixed=theta_fixed)
        # unregistered family instance: call the engine directly (no plan
        # can name it; sessions require registry families)
        from .batched import fit_all_local_batched
        tf = (None if theta_fixed is None
              else as_tensor(theta_fixed, X.device, X.dtype))
        sw = (None if sample_weight is None
              else as_tensor(sample_weight, X.device))
        return fit_all_local_batched(graph, X, include_singleton, tf,
                                     sample_weight=sw,
                                     warm_start=warm_start, family=family)
    if method == "loop":
        if sample_weight is not None or warm_start is not None:
            raise ValueError(
                "sample_weight/warm_start require method='batched'")
        if family is not None and family.name != "ising":
            raise ValueError(
                "method='loop' implements only the Ising family; "
                f"use method='batched' for {family.name!r}")
        return fit_all_local_loop(graph, X, include_singleton, theta_fixed)
    raise ValueError(f"unknown method {method!r}")


# ------------------------------------------------------------- joint fits
def fit_free(base_fn, X: torch.Tensor, n_params: int, free_idx,
             theta_fixed, n_iter: int) -> np.ndarray:
    """Newton over the ``free_idx`` coordinates of ``base_fn``'s flat
    theta, the rest held at ``theta_fixed`` (zeros by default); returns
    the full flat theta. The objective sets the free coordinates with an
    out-of-place ``index_put``, which ``torch.func`` can trace."""
    tf = (X.new_zeros(n_params) if theta_fixed is None
          else as_tensor(theta_fixed, X.device, X.dtype))
    if free_idx is None:
        free_idx = np.arange(n_params)
    idx = torch.as_tensor(np.asarray(free_idx, dtype=np.int64),
                          device=X.device)
    w = newton_maximize(lambda w: base_fn(tf.index_put((idx,), w)), tf[idx],
                        n_iter=n_iter)
    return tf.index_put((idx,), w).cpu().numpy()


def fit_mple(graph: Graph, X, free_idx: Optional[Sequence[int]] = None,
             theta_fixed=None, n_iter: int = 40) -> np.ndarray:
    """Joint MPLE (Eq. 2) over ``free_idx``; returns full flat theta."""
    X = as_tensor(X)
    return fit_free(lambda t: pseudo_loglik(graph, t, X), X,
                     graph.n_params, free_idx, theta_fixed, n_iter)


def fit_mle_exact(graph: Graph, X, free_idx: Optional[Sequence[int]] = None,
                  theta_fixed=None, n_iter: int = 40) -> np.ndarray:
    """Exact MLE by enumeration (small p only); returns full flat theta."""
    X = as_tensor(X)
    mean_u = torch.mean(suff_stats(graph, X), dim=0)

    def ll(theta):
        return theta @ mean_u - log_partition(graph, theta).to(theta.dtype)

    return fit_free(ll, X, graph.n_params, free_idx, theta_fixed, n_iter)
