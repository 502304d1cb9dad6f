"""Joint MPLE via ADMM (paper Sec. 3.2, Thm 3.1), on the batched proximal
engine.

The joint optimization (Eq. 6) decomposes into per-node proximal updates
plus a weighted linear-consensus average and a dual ascent step;
initializing theta_bar at a consistent one-step estimator (and lambda = 0)
keeps every iterate asymptotically consistent, the "any-time" property.
Every primal round of :func:`admm_mple_family` is one
:func:`~repro_torch.core.batched.prox_update_flat` call: one damped Newton
solve per degree bucket, whose iterations each take one Newton-kernel
launch on the card. The consensus and dual steps run on the host over flat
index arrays. :func:`admm_mple` is the seed Ising loop kept as the
reference: one autodiff Newton prox solve per node and round.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..telemetry.recorder import NULL_RECORDER
from .asymptotics import param_owners
from .batched import local_layout, prox_update_flat
from .consensus import combine
from .estimators import (LocalFit, _cl_objective, newton_maximize,
                         node_design)
from .families import ISING
from .graphs import Graph
from .ising import as_tensor


@dataclasses.dataclass
class ADMMResult:
    trajectory: np.ndarray        # (n_iters + 1, n_params) theta_bar iterates
    primal_residual: np.ndarray   # (n_iters,) ||theta^i - theta_bar|| rms


def _prox_solve(Z, xi, offset, lam, rho, tbar_beta, w0,
                include_singleton: bool, n_iter: int) -> torch.Tensor:
    """Node-i ADMM primal update:
    argmax l^i(w) - lam'w - sum rho/2 (w - tbar)^2."""
    ll, _ = _cl_objective(Z, xi, offset, include_singleton)

    def obj(w):
        return ll(w) - lam @ w - torch.sum(rho * (w - tbar_beta) ** 2) / 2.0

    return newton_maximize(obj, w0, n_iter=n_iter)


def admm_mple(graph: Graph, X, n_iters: int = 30, init: str = "diagonal",
              fits: Optional[List[LocalFit]] = None,
              include_singleton: bool = True,
              theta_fixed: Optional[np.ndarray] = None,
              newton_iters: int = 15) -> ADMMResult:
    """Run ADMM on the joint Ising MPLE objective, node by node (the seed
    loop; :func:`admm_mple_family` is the batched engine).

    init: "zero" (theta_bar = 0, rho = 1) or "uniform"/"diagonal"
    (theta_bar = the corresponding one-step linear consensus, rho = its
    weights), matching Fig. 3(c). Runs on the device of ``X`` (a tensor;
    anything else goes to the card). The penalties are
    :func:`rho_from_fits`' in the seed's scalar layout.
    """
    X = as_tensor(X)
    if theta_fixed is None:
        theta_fixed = np.zeros(graph.n_params)
    theta_fixed = np.asarray(theta_fixed, dtype=np.float64)
    tf = torch.as_tensor(theta_fixed, device=X.device).to(X.dtype)

    if init == "zero":
        theta_bar = np.array(theta_fixed, copy=True)
        rhos = rho_from_fits(graph, None, "uniform", include_singleton)
    else:
        if fits is None:
            raise ValueError(f"admm init {init!r} needs local fits")
        theta_bar = combine(graph, fits, init, include_singleton,
                            theta_fixed)
        rhos = rho_from_fits(graph, fits, init, include_singleton)

    owners = param_owners(graph, include_singleton)
    betas = [np.asarray(graph.beta(i, include_singleton), dtype=np.int64)
             for i in range(graph.p)]
    lambdas = [np.zeros(len(b)) for b in betas]
    # local estimates start at the consensus value restricted to beta_i
    thetas = [np.array(theta_bar[b]) for b in betas]
    designs = [node_design(graph, X, i) for i in range(graph.p)]

    def dev(a):
        return torch.as_tensor(a, device=X.device).to(X.dtype)

    traj = [np.array(theta_bar, copy=True)]
    resid = []
    for _ in range(n_iters):
        # 1) local proximal updates
        for i in range(graph.p):
            thetas[i] = _prox_solve(
                designs[i], X[:, i], tf[i], dev(lambdas[i]), dev(rhos[i]),
                dev(theta_bar[betas[i]]), dev(thetas[i]),
                include_singleton, newton_iters).cpu().numpy()
        # 2) weighted linear consensus
        new_bar = np.array(theta_bar, copy=True)
        for a, own in owners.items():
            num, den = 0.0, 0.0
            for (i, pos) in own:
                num += rhos[i][pos] * thetas[i][pos]
                den += rhos[i][pos]
            new_bar[a] = num / den
        theta_bar = new_bar
        # 3) dual ascent
        r2, cnt = 0.0, 0
        for i in range(graph.p):
            diff = thetas[i] - theta_bar[betas[i]]
            lambdas[i] = lambdas[i] + rhos[i] * diff
            r2 += float(diff @ diff)
            cnt += len(betas[i])
        resid.append(np.sqrt(r2 / max(cnt, 1)))
        traj.append(np.array(theta_bar, copy=True))

    return ADMMResult(trajectory=np.stack(traj),
                      primal_residual=np.asarray(resid))


def rho_from_fits(graph: Graph, fits, scheme: str,
                  include_singleton: bool = True,
                  family=None) -> List[np.ndarray]:
    """Per-node penalty vectors rho^i_{beta_i} matching consensus weights:
    "uniform" (or no fits) gives unit penalties, "diagonal" the inverse
    sandwich-variance diagonals of the local fits. Block order follows
    ``family.beta`` (the scalar layout when ``family=None``)."""
    rhos = []
    for i in range(graph.p):
        beta = (graph.beta(i, include_singleton) if family is None
                else family.beta(graph, i, include_singleton))
        if scheme == "uniform" or fits is None:
            rhos.append(np.ones(len(beta)))
        elif scheme == "diagonal":
            rhos.append(1.0 / np.maximum(np.diag(fits[i].V), 1e-12))
        else:
            raise ValueError(
                f"ADMM penalty scheme must be 'uniform' or 'diagonal', "
                f"got {scheme!r}")
    return rhos


def admm_mple_family(graph: Graph, X: torch.Tensor, n_iters: int = 30,
                     init: str = "diagonal",
                     fits: Optional[List[LocalFit]] = None,
                     include_singleton: bool = True,
                     theta_fixed: Optional[np.ndarray] = None,
                     newton_iters: int = 15, family=None,
                     sample_weight: Optional[torch.Tensor] = None,
                     rho0: float = 1.0,
                     use_kernel: bool = True, recorder=None) -> ADMMResult:
    """Joint MPLE via ADMM over any registered family.

    init: "zero" (theta_bar = theta_fixed, rho = rho0) or
    "uniform"/"diagonal" (theta_bar = that one-step consensus of ``fits``,
    rho = its weights, "uniform" scaled by ``rho0``), matching Fig. 3(c).
    ``X`` is an (n, p) tensor on the device the prox solves run on;
    ``sample_weight`` and ``use_kernel`` are as in
    :func:`~repro_torch.core.batched.prox_update_batched`. A telemetry
    ``recorder`` gets one ``admm_iter`` span per round, holding that
    round's ``prox_bucket_solve`` spans and an ``admm.primal_residual``
    observation.
    """
    rec = NULL_RECORDER if recorder is None else recorder
    fam = ISING if family is None else family
    n_params = fam.n_params(graph)
    if theta_fixed is None:
        theta_fixed = np.zeros(n_params)
    theta_fixed = np.asarray(theta_fixed, dtype=np.float64)

    if init == "zero":
        theta_bar = np.array(theta_fixed, copy=True)
        rhos = rho_from_fits(graph, None, "uniform", include_singleton, fam)
    else:
        if fits is None:
            raise ValueError(f"admm init {init!r} needs local fits")
        theta_bar = combine(graph, fits, init, include_singleton,
                            theta_fixed, family=fam)
        rhos = rho_from_fits(graph, fits, init, include_singleton, fam)
    if init in ("zero", "uniform") and rho0 != 1.0:
        rhos = [r * float(rho0) for r in rhos]

    # all nodes' local vectors laid end to end in node order (slot s
    # estimates parameter param[s]); consensus sums owners in node order
    _, param = local_layout(graph, fam, include_singleton)
    rho = np.concatenate(rhos).astype(np.float64)
    owned = np.zeros(n_params, dtype=bool)
    owned[param] = True
    den = np.zeros(n_params)
    np.add.at(den, param, rho)
    lam = np.zeros(len(param))
    flat = theta_bar[param]
    tf = torch.as_tensor(theta_fixed, device=X.device).to(X.dtype)

    traj = [np.array(theta_bar, copy=True)]
    resid = []
    for it in range(n_iters):
        with rec.span("admm_iter", it=it):
            # 1) batched local proximal updates (one solve per bucket)
            flat = prox_update_flat(
                graph, X, theta_bar[param], lam, rho, flat,
                include_singleton, tf, sample_weight, newton_iters, fam,
                use_kernel, recorder).astype(np.float64)
            # 2) weighted linear consensus, summed over owners in node order
            num = np.zeros(n_params)
            np.add.at(num, param, rho * flat)
            theta_bar = theta_bar.copy()
            theta_bar[owned] = num[owned] / den[owned]
            # 3) dual ascent
            diff = flat - theta_bar[param]
            lam = lam + rho * diff
            resid.append(np.sqrt(float(diff @ diff) / max(len(param), 1)))
            traj.append(np.array(theta_bar, copy=True))
            if rec.enabled:
                rec.observe("admm.primal_residual", resid[-1], it=it)

    return ADMMResult(trajectory=np.stack(traj),
                      primal_residual=np.asarray(resid))
