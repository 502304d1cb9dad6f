"""Batched local-estimator engine: degree-bucketed Newton-IRLS over
exponential-family models, in PyTorch.

The paper's local CL estimators (Eq. 3) are p independent node-conditional
GLM fits. Nodes are grouped into **degree buckets** (degree padded up to the
next power of four); within a bucket all k neighbor designs are stacked into
a ``(k, C, d, n)`` tensor and solved together by batched damped Newton
steps, with each family's closed-form score ``r = dl/deta`` and curvature
``kappa = -d2l/deta2``. The per-iteration score and curvature Gram come from
:func:`repro_torch.kernels.cl.ops.bucket_newton_stats_op` (the CUDA kernel on
the card). Newton systems are solved by a batched, unpivoted Gauss-Jordan
sweep (the systems are sign-definite).

Padding is exact: padded design columns are zero, so their gradient entries
vanish and the Hessian is block-diagonal with a ``-1`` placeholder on padded
coordinates; the Newton direction on real coordinates is untouched.

Per-node parameters are flat in **coordinate-major block layout**
``[singleton block (C), edge block (C) per incident edge]``, matching
``family.beta``.

Streaming support: ``sample_weight`` (a 0/1 prefix mask per node) and
``warm_start`` (previous per-node thetas) as in the reference engine.

Observability: a telemetry ``recorder`` (the allocation-free
``NULL_RECORDER`` when None) gets one ``bucket_solve`` (fit) or
``prox_bucket_solve`` (ADMM primal) span per degree bucket, with the Newton
iteration counts and dispatch seconds observed only when it is live.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels.cl.epilogues import get_epilogue
from ..kernels.build import LIBRARIES
from ..kernels.cl.ops import bucket_newton_stats_op
from ..telemetry.recorder import NULL_RECORDER
from .estimators import LocalFit
from .families import ISING
from .graphs import Graph

# Backtracking candidates for clipped Newton steps, largest first so ties at
# the optimum keep the full step; 0 is the "every direction hurts" escape.
_LS_CAND = np.array([1.0, 0.5, 0.25, 0.125, 0.0625, 0.015625, 0.0],
                    dtype=np.float32)
# Gradient-direction scales tried alongside the Newton candidates: when the
# Hessian is near-singular the Newton direction can be useless at every
# scale, but a small enough ascent step along the gradient of a concave
# criterion always improves off-optimum.
_LS_GRAD = np.array([1.0, 0.25, 0.0625, 0.015625, 0.00390625],
                    dtype=np.float32)


def _backtrack_step(objective, W, dirn, g, max_step):
    """Pick, per node, the best step among scaled Newton and gradient
    candidates by the concave per-node ``objective``; returns (k, d) steps.

    The update is ``W - step``, so Newton candidates are ``s * dirn`` and
    ascent candidates ``-s * g_unit``.
    """
    k = W.shape[0]
    dev = W.device
    ncand = torch.as_tensor(_LS_CAND, device=dev).to(W.dtype)[:, None, None] \
        * dirn[None]
    gnorm = torch.linalg.norm(g, dim=1, keepdim=True)
    gdir = -g * (max_step / (gnorm + 1e-30))
    gcand = torch.as_tensor(_LS_GRAD, device=dev).to(W.dtype)[:, None, None] \
        * gdir[None]
    steps = torch.cat([ncand, gcand], dim=0)                 # (c, k, d)
    vals = objective(W[None] - steps)
    vals = torch.where(torch.isfinite(vals), vals,
                       torch.full_like(vals, -float("inf")))
    best = torch.argmax(vals, dim=0)                         # (k,)
    return steps[best, torch.arange(k, device=dev)]


def _pad_degree(deg: int) -> int:
    """Bucket width for a node of degree ``deg``: next power of 4 (min 1)."""
    pad = 1
    while pad < deg:
        pad *= 4
    return pad


@dataclasses.dataclass(frozen=True)
class DegreeBucket:
    """All nodes whose padded degree is ``deg_pad``, with gather metadata."""
    deg_pad: int
    nodes: np.ndarray      # (k,) node indices, ascending
    nbrs: np.ndarray       # (k, deg_pad) neighbor indices, 0-padded
    mask: np.ndarray       # (k, deg_pad) 1.0 on real columns, 0.0 on padding


@functools.lru_cache(maxsize=64)
def _degree_buckets_cached(graph: Graph):
    by_pad: Dict[int, List[int]] = {}
    nbrs_of: Dict[int, List[int]] = {}
    for i in range(graph.p):
        ks = graph.incident_edges(i)
        others = [graph.edges[k][0] if graph.edges[k][1] == i
                  else graph.edges[k][1] for k in ks]
        nbrs_of[i] = others
        by_pad.setdefault(_pad_degree(len(others)), []).append(i)

    buckets = []
    for deg_pad in sorted(by_pad):
        nodes = np.asarray(sorted(by_pad[deg_pad]), dtype=np.int32)
        k = len(nodes)
        nbrs = np.zeros((k, deg_pad), dtype=np.int32)
        mask = np.zeros((k, deg_pad), dtype=np.float32)
        for row, i in enumerate(nodes):
            d = len(nbrs_of[i])
            nbrs[row, :d] = nbrs_of[i]
            mask[row, :d] = 1.0
        buckets.append(DegreeBucket(deg_pad=deg_pad, nodes=nodes,
                                    nbrs=nbrs, mask=mask))
    return tuple(buckets)


def degree_buckets(graph: Graph) -> List[DegreeBucket]:
    """Group nodes by padded degree; columns follow
    ``graph.incident_edges(i)`` (edge order), as ``family.beta`` does.
    Cached per graph."""
    return list(_degree_buckets_cached(graph))


def _gauss_jordan_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched solve A @ X = B for sign-definite A via Gauss-Jordan.

    A: (k, d, d) uniformly positive- or negative-definite (no pivoting
    needed); B: (k, d, m). One unpivoted sweep of rank-1 updates, the same
    arithmetic as the reference's.
    """
    d = A.shape[-1]
    M = torch.cat([A, B], dim=2)                     # (k, d, d + m)
    for i in range(d):
        piv = M[:, i, :] / M[:, i, i][:, None]       # (k, d + m)
        coef = M[:, :, i]                            # (k, d)
        M = M - coef[:, :, None] * piv[:, None, :]
        M[:, i, :] = piv                             # pivot row normalized
    return M[:, :, d:]


def _solver_dtype(dtype: torch.dtype) -> torch.dtype:
    """Newton/solver state type for a design type: bfloat16 designs keep
    float32 solver state; float32/float64 pass through."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _bucket_design(family, X, nodes, nbrs, mask, offsets,
                   include_singleton: bool):
    """Build the channelized (k, C, d, n) bucket design + targets/masks.

    Returns ``(Zb, xi, base, cmask)``: per-channel stacked designs, node
    samples, fixed-singleton block offsets folded into ``base`` (k, C, n),
    and the d-length coordinate mask. ``offsets``: (k, C) fixed singleton
    blocks.
    """
    C = family.block_dim
    # (n, k, deg_pad, C): family features of the gathered neighbor values
    F = family.edge_features(X[:, nbrs])
    Zt = F.permute(1, 3, 2, 0) * mask.to(F.dtype)[:, None, :, None]
    xi = X[:, nodes].T                                       # (k, n)
    k, _, _, n = Zt.shape

    if include_singleton:
        ones = torch.ones((k, C, 1, n), dtype=Zt.dtype, device=Zt.device)
        Zb = torch.cat([ones, Zt], dim=2).contiguous()       # (k, C, d, n)
        cmask = torch.cat([torch.ones((mask.shape[0], 1), dtype=mask.dtype,
                                      device=mask.device), mask], dim=1)
        base = torch.zeros((k, C, n), dtype=Zt.dtype, device=Zt.device)
    else:
        Zb = Zt.contiguous()
        cmask = mask
        base = (offsets[:, :, None]
                * torch.ones((k, C, n), dtype=Zt.dtype, device=Zt.device))
    return Zb, xi.contiguous(), base, cmask


def _flat_coord_mask(cmask: torch.Tensor, C: int) -> torch.Tensor:
    """(k, d) coordinate mask -> (k, d*C) flat-parameter mask."""
    k, d = cmask.shape
    return cmask[:, :, None].expand(k, d, C).reshape(k, d * C)


def _channel_ops(family, Zb, base, xi, sw, weighted, denom,
                 use_kernel: bool = True):
    """Channelized-GLM contraction closures shared by the bucket solvers,
    in the flat coordinate-major (k, d*C) layout.

    C == 1 keeps the single-channel matmul forms. Returns
    ``(score_curvature, curvature_matrix, avg_loglik, score_matrix,
    newton_stats)``; ``newton_stats`` is the per-iteration hot path. A
    family whose ``kernel_kind`` has a registered epilogue takes it through
    the fused kernel dispatch, which reads the design in its own type; a
    family without one takes the closed-form hooks, ``grad_vec(r)`` and
    ``curvature_matrix(kap)``, as the reference's engine does. The choice
    depends on the family alone. The other closures contract in the solver
    type (``denom``'s): a bfloat16 design is promoted once here, where the
    reference's type promotion did it per contraction.
    """
    k, C, d, _ = Zb.shape
    dC = d * C
    kernel_in = (Zb, base, xi)
    cdtype = denom.dtype
    Zb, base, xi = (t.to(cdtype) for t in kernel_in)
    Z1 = Zb[:, 0] if C == 1 else None

    def eta_of(W):
        if C == 1:
            return base + torch.einsum("kdn,kd->kn", Z1, W)[:, None, :]
        return base + torch.einsum("kcdn,kdc->kcn", Zb, W.reshape(k, d, C))

    def score_curvature(W):
        eta = eta_of(W)
        r = family.dl_deta(eta, xi)                          # (k, C, n)
        kap = family.curvature(eta, xi)                      # (k, C, C, n)
        if weighted:
            r = r * sw[:, None, :]
            kap = kap * sw[:, None, None, :]
        return r, kap

    def grad_vec(r):
        if C == 1:
            return torch.einsum("kdn,kn->kd", Z1, r[:, 0])
        return torch.einsum("kcdn,kcn->kdc", Zb, r).reshape(k, dC)

    def curvature_matrix(kap):
        if C == 1:
            return (Z1 * kap[:, 0, 0][:, None, :]) @ Z1.transpose(1, 2)
        H = torch.einsum("kcdn,kcen,kefn->kdcfe", Zb, kap, Zb)
        return H.reshape(k, dC, dC)

    def avg_loglik(Ws):
        # per-node average conditional loglik for a (c, k, d*C) stack of
        # candidate parameter points; returns (c, k)
        if C == 1:
            etas = base[None] \
                + torch.einsum("kdn,akd->akn", Z1, Ws)[:, :, None, :]
        else:
            Wb = Ws.reshape(Ws.shape[0], k, d, C)
            etas = base[None] + torch.einsum("kcdn,akdc->akcn", Zb, Wb)
        ll = family.loglik_eta(etas, xi[None])
        if weighted:
            ll = ll * sw[None]
        return ll.sum(dim=2) / denom[None, :]

    def score_matrix(r):
        if C == 1:
            return Z1 * r[:, 0][:, None, :]                  # (k, d, n)
        n = Zb.shape[-1]
        return (Zb * r[:, :, None, :]).permute(0, 2, 1, 3).reshape(k, dC, n)

    kind = getattr(family, "kernel_kind", None)
    fused_kind = kind if get_epilogue(kind) is not None else None

    def newton_stats(W):
        if fused_kind is not None:
            return bucket_newton_stats_op(fused_kind, *kernel_in, W,
                                          sw if weighted else None,
                                          use_kernel=use_kernel)
        r, kap = score_curvature(W)
        return grad_vec(r), curvature_matrix(kap)

    return score_curvature, curvature_matrix, avg_loglik, score_matrix, \
        newton_stats


def _damped_newton(W, newton_stats, objective, denom, curvature_shifts,
                   n_iter: int, tol: float, max_step: float, guarded: bool,
                   grad_shift=None):
    """The bucket-wide damped Newton loop of the fit and proximal solvers.

    Each iteration takes (g, K) from ``newton_stats`` (one kernel launch on
    the card), forms ``g / denom`` (then ``grad_shift(g, W)``) and
    ``-K / denom`` minus each of ``curvature_shifts`` in turn, and steps
    along the clipped Newton direction; with ``guarded``, an untrusted
    direction is replaced by a backtracking search on ``objective``. The
    reference's while_loop becomes a Python loop whose stop test reads one
    device scalar (the step's inf-norm) per iteration. Returns (W, iters).
    """
    it = 0
    delta = float("inf")
    while it < n_iter and delta > tol:
        g_raw, K_raw = newton_stats(W)           # fused score + Gram
        # the kernel returns float32 statistics; a float64 solver state
        # promotes them explicitly, as on the TPU
        g = g_raw.to(W.dtype) / denom[:, None]
        if grad_shift is not None:
            g = grad_shift(g, W)
        H = -K_raw.to(W.dtype) / denom[:, None, None]
        for shift in curvature_shifts:
            H = H - shift
        dirn = _gauss_jordan_solve(H, g[..., None])[..., 0]  # (k, dC)
        # an untrusted direction: non-finite (curvature underflow at a
        # saturated point) or clipped (outside Newton's trust region); NaN
        # directions are zeroed so they cannot poison the bucket-wide stop
        finite = torch.all(torch.isfinite(dirn), dim=1, keepdim=True)
        dirn = torch.where(finite, dirn, torch.zeros_like(dirn))
        norm = torch.linalg.norm(dirn, dim=1, keepdim=True)
        untrusted = (norm > max_step) | ~finite
        dirn = torch.where(norm > max_step,
                           dirn * (max_step / (norm + 1e-30)), dirn)
        if guarded and bool(torch.any(untrusted)):
            # guard an untrusted direction with a per-node backtracking
            # search over Newton + gradient candidates
            step = _backtrack_step(objective, W, dirn, g, max_step)
        else:
            step = dirn
        delta = float(torch.max(torch.abs(step)))
        W = W - step
        it += 1
    return W, it


def _bucket_system(family, X, nodes, nbrs, mask, offsets, sw,
                   include_singleton: bool, weighted: bool,
                   use_kernel: bool):
    """The bucket design and what the fit and proximal solvers derive from
    it: the :func:`_channel_ops` closures, the identity, the
    padded-coordinate diagonal and the per-node weight totals ``denom``,
    all in the solver type."""
    n = X.shape[0]
    Zb, xi, base, cmask = _bucket_design(family, X, nodes, nbrs, mask,
                                         offsets, include_singleton)
    k, C, d, _ = Zb.shape
    cdtype = _solver_dtype(Zb.dtype)
    eye = torch.eye(d * C, dtype=cdtype, device=Zb.device)
    # -1 on padded diagonals keeps the (exactly block-diagonal) system
    # uniformly negative definite without touching the real block's
    # Newton direction.
    cflat = _flat_coord_mask(cmask, C).to(cdtype)
    pad_diag = (1.0 - cflat)[:, :, None] * eye[None, :, :]
    if weighted:
        sw = sw.to(cdtype)
        denom = torch.clamp(torch.sum(sw, dim=1), min=1.0)   # (k,)
    else:
        denom = torch.full((k,), float(n), dtype=cdtype, device=Zb.device)
    ops = _channel_ops(family, Zb, base, xi, sw, weighted, denom, use_kernel)
    return ops, eye, pad_diag, denom


def _solve_bucket_impl(X, nodes, nbrs, mask, offsets, W0, sw,
                       include_singleton: bool, n_iter: int,
                       weighted: bool = False, guarded: bool = False,
                       family=ISING, tol: float = 2e-6,
                       ridge: float = 1e-8, max_step: float = 5.0,
                       want_influence: bool = True,
                       use_kernel: bool = True):
    """Solve every node of one degree bucket together.

    X: (n, p) samples; nodes: (k,); nbrs: (k, deg_pad); mask: (k, deg_pad);
    offsets: (k, C) fixed singleton blocks (used when
    include_singleton=False); W0: (k, d*C) Newton start; sw: (k, n)
    per-node sample weights, only read when ``weighted``. ``tol`` is on the
    damped step's inf-norm, just above the float32 jitter floor.

    Returns (W, H, J, V, S, I) with leading bucket dimension k and flat
    parameter dimension d*C; padded coordinates are exactly zero in W and
    carry a ``-1`` placeholder diagonal in the Newton system. ``I`` is the
    (k,) Newton-iteration count (bucket-wide, broadcast per node).
    """
    (score_curvature, curvature_matrix, objective, score_matrix,
     newton_stats), eye, pad_diag, denom = _bucket_system(
        family, X, nodes, nbrs, mask, offsets, sw, include_singleton,
        weighted, use_kernel)
    W = W0.to(eye.dtype)
    W, it = _damped_newton(W, newton_stats, objective, denom,
                           (ridge * eye[None, :, :], pad_diag), n_iter, tol,
                           max_step, guarded)
    k, dC = W.shape
    I = torch.full((k,), it, dtype=torch.int32)

    # sandwich diagnostics at W_hat (closed forms; no autodiff). Under 0/1
    # weights the masked-out samples' scores are zeroed, so J/H average only
    # the live samples.
    r, kap = score_curvature(W)
    G = score_matrix(r)                                      # (k, dC, n)
    J = G @ G.transpose(1, 2) / denom[:, None, None]
    H = curvature_matrix(kap) / denom[:, None, None]         # = -hessian
    Hreg = H + 1e-9 * eye[None, :, :] + pad_diag
    Hinv = _gauss_jordan_solve(Hreg, eye.expand(Hreg.shape))
    V = Hinv @ J @ Hinv.transpose(1, 2)
    if want_influence:
        S = G.transpose(1, 2) @ Hinv.transpose(1, 2)         # (k, n, dC)
    else:
        # only the Linear-Opt combiner reads the per-sample influence stack
        S = torch.zeros((k, 0, dC), dtype=W.dtype, device=W.device)
    return W, H, J, V, S, I


def _bucket_weights(sample_weight, nodes: np.ndarray, n: int):
    """Per-bucket (k, n) weight rows from a global (n,) or per-node (p, n)
    sample-weight tensor; ``None`` means unweighted."""
    if sample_weight is None:
        return None
    if sample_weight.ndim == 1:
        return sample_weight[None, :].expand(len(nodes), n).contiguous()
    idx = torch.as_tensor(nodes, dtype=torch.int64,
                          device=sample_weight.device)
    return sample_weight[idx].contiguous()


def _bucket_warm_start(warm_start, b: DegreeBucket, dC: int, lead: int,
                       C: int, dtype, device) -> torch.Tensor:
    """Stack per-node warm-start thetas into the bucket's padded (k, d*C).

    Values pass through float32, as in the reference engine."""
    W0 = np.zeros((len(b.nodes), dC), dtype=np.float32)
    if warm_start is not None:
        degs = b.mask.sum(axis=1).astype(np.int64)
        for row, i in enumerate(b.nodes):
            w = warm_start[int(i)]
            if w is None:
                continue
            di = (lead + int(degs[row])) * C
            W0[row, :di] = np.asarray(w, dtype=np.float32)[:di]
    return torch.as_tensor(W0, device=device).to(dtype)


def fit_all_local_batched(graph: Graph, X: torch.Tensor,
                          include_singleton: bool = True,
                          theta_fixed: Optional[torch.Tensor] = None,
                          n_iter: int = 40,
                          sample_weight: Optional[torch.Tensor] = None,
                          warm_start: Optional[Sequence] = None,
                          family=None,
                          want_influence: bool = True,
                          use_kernel: bool = True,
                          iters: Optional[dict] = None,
                          recorder=None) -> List[LocalFit]:
    """Fit all p local CL estimators via degree-bucketed batched solves.

    Returns ``List[LocalFit]`` ordered by node, with numpy fields trimmed
    back to each node's true block count; local parameter vectors follow
    ``family.beta(graph, i, include_singleton)`` block order. ``X`` is an
    (n, p) tensor on the device the fit runs on.

      sample_weight — ``(n,)`` shared or ``(p, n)`` per-node 0/1 observation
        masks over the sample pool (a tensor on X's device).
      warm_start — optional length-p sequence of previous per-node thetas
        (``None`` entries allowed) used to seed Newton.
      want_influence — False skips the (n, d) per-sample influence stacks
        (``LocalFit.s`` comes back with zero rows).
      use_kernel — False asks for the plain PyTorch Newton statistics on
        any device (the CUDA kernel otherwise runs on CUDA tensors).
      iters — optional dict that receives each bucket's Newton iteration
        count, keyed by ``deg_pad``.
      recorder — a telemetry recorder: one ``bucket_solve`` span per
        bucket, then ``engine.newton_iters`` and ``engine.bucket_dispatch_s``
        observations (``compiled`` tags a dispatch that built the kernel
        libraries).
    """
    if family is None:
        family = ISING
    rec = NULL_RECORDER if recorder is None else recorder
    C = family.block_dim
    dev = X.device
    if theta_fixed is None:
        theta_fixed = torch.zeros(family.n_params(graph), dtype=X.dtype,
                                  device=dev)
    node_tf = theta_fixed[: graph.p * C].reshape(graph.p, C)
    n = X.shape[0]
    lead = 1 if include_singleton else 0
    cdtype = _solver_dtype(X.dtype)
    off, param = local_layout(graph, family, include_singleton)

    out: List[Optional[LocalFit]] = [None] * graph.p
    for b in degree_buckets(graph):
        k = len(b.nodes)
        nodes = torch.as_tensor(b.nodes, dtype=torch.int64, device=dev)
        nbrs = torch.as_tensor(b.nbrs, dtype=torch.int64, device=dev)
        mask = torch.as_tensor(b.mask, device=dev)
        offsets = node_tf[nodes]
        dC = (b.deg_pad + lead) * C
        sw = _bucket_weights(sample_weight, b.nodes, n)
        W0 = _bucket_warm_start(warm_start, b, dC, lead, C, cdtype, dev)
        if rec.enabled:
            b0, t0 = LIBRARIES.builds, time.perf_counter()
        with rec.span("bucket_solve", deg_pad=b.deg_pad, k=k):
            W, H, J, V, S, I = _solve_bucket_impl(
                X, nodes, nbrs, mask, offsets, W0, sw, include_singleton,
                n_iter, sample_weight is not None, warm_start is not None,
                family, want_influence=want_influence, use_kernel=use_kernel)
            # the host copies wait for the device: the span covers it all
            W, H, J, V, S = (t.cpu().numpy() for t in (W, H, J, V, S))
        if iters is not None:
            iters[b.deg_pad] = int(I[0])
        if rec.enabled:
            dt = time.perf_counter() - t0
            rec.observe("engine.newton_iters", int(I[0]), deg_pad=b.deg_pad)
            rec.observe("engine.bucket_dispatch_s", dt, deg_pad=b.deg_pad,
                        compiled=LIBRARIES.builds > b0)
        degs = b.mask.sum(axis=1).astype(np.int64)
        for row, i in enumerate(b.nodes):
            i = int(i)
            di = (lead + int(degs[row])) * C
            out[i] = LocalFit(
                i=i, beta=param[off[i]:off[i + 1]].tolist(),
                theta=W[row, :di].copy(), H=H[row, :di, :di].copy(),
                J=J[row, :di, :di].copy(), V=V[row, :di, :di].copy(),
                s=S[row, :, :di].copy())
    return out  # type: ignore[return-value]


# ------------------------------------------------------- proximal updates
def _solve_bucket_prox_impl(X, nodes, nbrs, mask, offsets, W0, sw, lam, rho,
                            tbar, include_singleton: bool, n_iter: int,
                            weighted: bool = False, family=ISING,
                            tol: float = 2e-6, ridge: float = 1e-8,
                            max_step: float = 5.0, use_kernel: bool = True):
    """ADMM primal update for a whole degree bucket.

    Maximizes, per node,  ``l^i(w) - lam'w - sum_a rho_a (w_a - tbar_a)^2/2``
    with the fit solver's Newton machinery: the prox terms only shift the
    gradient by ``-lam - rho*(w - tbar)`` and the Hessian by
    ``-diag(rho)``, so the bucket stays uniformly negative definite, and
    each iteration takes its (g, K) from the same ``newton_stats`` hook
    (one Newton-kernel launch on the card). lam, rho, tbar: (k, d*C) with
    zeros on padded coordinates. Returns W.
    """
    (_, _, avg_loglik, _, newton_stats), eye, pad_diag, denom = \
        _bucket_system(family, X, nodes, nbrs, mask, offsets, sw,
                       include_singleton, weighted, use_kernel)
    W = W0.to(eye.dtype)
    lam, rho, tbar = (t.to(eye.dtype) for t in (lam, rho, tbar))
    rho_diag = rho[:, :, None] * eye[None, :, :]

    def objective(Ws):
        # (c, k): penalized criterion for a stack of candidate points
        pen = (lam[None] * Ws).sum(dim=2) \
            + 0.5 * (rho[None] * (Ws - tbar[None]) ** 2).sum(dim=2)
        return avg_loglik(Ws) - pen

    W, _ = _damped_newton(
        W, newton_stats, objective, denom,
        (rho_diag, ridge * eye[None, :, :], pad_diag), n_iter, tol, max_step,
        guarded=True, grad_shift=lambda g, W: g - lam - rho * (W - tbar))
    return W


@functools.lru_cache(maxsize=64)
def local_layout(graph: Graph, family, include_singleton: bool):
    """(off, param) of all nodes' local vectors laid end to end in node
    order: node i holds slots ``off[i]:off[i + 1]``, and slot s estimates
    flat parameter ``param[s]`` (``family.beta`` order). Cached per
    (graph, family, include_singleton); read-only arrays."""
    betas = [family.beta(graph, i, include_singleton)
             for i in range(graph.p)]
    off = np.concatenate([[0], np.cumsum([len(b) for b in betas])]
                         ).astype(np.int64)
    param = np.asarray([a for b in betas for a in b], dtype=np.int64)
    off.setflags(write=False)
    param.setflags(write=False)
    return off, param


def _shrink_blocks(blocks: np.ndarray, thr: float) -> np.ndarray:
    """Each row of ``blocks`` scaled by ``max(0, 1 - thr / ||row||_2)``."""
    norms = np.linalg.norm(blocks, axis=1)
    scale = np.where(norms > thr,
                     1.0 - thr / np.where(norms > 0.0, norms, 1.0), 0.0)
    return blocks * scale[:, None]


def group_soft_threshold_flat(v: np.ndarray, thr: float, block_dim: int,
                              off: np.ndarray, lead: int = 1) -> np.ndarray:
    """Group soft-thresholding of every node's local vector at once.

    ``v`` holds all nodes' ``family.beta``-ordered vectors end to end as
    :func:`local_layout` lays them out (node i at slots
    ``off[i]:off[i + 1]``). The proximal operator of
    ``thr * sum_blocks ||w_block||_2``: each node's first ``lead`` blocks
    (the unpenalized singleton block, when free) pass through untouched;
    every following ``block_dim``-wide edge block ``g`` of every node is
    scaled by ``max(0, 1 - thr / ||g||_2)`` in one vectorised pass —
    shrunk toward zero and EXACTLY zeroed once its norm falls below
    ``thr``, which is what lets structure learning read the support off the
    iterate with no epsilon tolerance. At C = 1 this is the scalar
    soft-threshold. Bit for bit the reference's per-node function applied
    node by node.
    """
    v = np.asarray(v, dtype=np.float64)
    if v.size != off[-1]:
        raise ValueError(f"vector of length {v.size}; the layout holds "
                         f"{int(off[-1])} slots")
    lens = np.diff(off) - lead * block_dim
    if np.any(lens < 0) or np.any(lens % block_dim):
        bad = int(np.flatnonzero((lens < 0) | (lens % block_dim))[0])
        raise ValueError(
            f"node {bad}'s vector of length {int(off[bad + 1] - off[bad])} is "
            f"not lead={lead} plus whole blocks of size {block_dim}")
    out = v.copy()
    if thr > 0.0 and lens.sum() > 0:
        free = np.ones(v.size, dtype=bool)
        free[(off[:-1, None] + np.arange(lead * block_dim)).ravel()] = False
        edge = np.flatnonzero(free)
        out[edge] = _shrink_blocks(out[edge].reshape(-1, block_dim),
                                   thr).ravel()
    return out


def prox_update_flat(graph: Graph, X: torch.Tensor, bar: np.ndarray,
                     lam: np.ndarray, rho: np.ndarray, start: np.ndarray,
                     include_singleton: bool = True,
                     theta_fixed: Optional[torch.Tensor] = None,
                     sample_weight: Optional[torch.Tensor] = None,
                     n_iter: int = 15, family=None,
                     use_kernel: bool = True, recorder=None) -> np.ndarray:
    """:func:`prox_update_batched` on the concatenated local vectors of
    :func:`local_layout`: consensus views ``bar``, duals ``lam``,
    penalties ``rho`` and Newton starts ``start``, each one flat array.
    Returns the updated local vectors, flat, in the solver type. The
    per-node inputs pass through float32, as in the reference engine.
    ``recorder`` gets one ``prox_bucket_solve`` span per bucket and an
    ``engine.prox_dispatch_s`` observation."""
    if family is None:
        family = ISING
    rec = NULL_RECORDER if recorder is None else recorder
    C = family.block_dim
    dev = X.device
    if theta_fixed is None:
        theta_fixed = torch.zeros(family.n_params(graph), dtype=X.dtype,
                                  device=dev)
    node_tf = theta_fixed[: graph.p * C].reshape(graph.p, C)
    off, _ = local_layout(graph, family, include_singleton)
    n = X.shape[0]
    lead = 1 if include_singleton else 0
    cdtype = _solver_dtype(X.dtype)

    out = np.zeros(off[-1], dtype=np.float64 if cdtype == torch.float64
                   else np.float32)
    for b in degree_buckets(graph):
        dC = (b.deg_pad + lead) * C
        degs = b.mask.sum(axis=1).astype(np.int64)
        # (k, dC) gather of each row's local vector, zeros on padding
        cols = np.arange(dC)[None, :]
        valid = cols < ((lead + degs) * C)[:, None]
        idx = np.where(valid, off[b.nodes][:, None] + cols, 0)

        def rows(flat):
            return torch.as_tensor(
                np.where(valid, flat[idx], 0.0).astype(np.float32),
                device=dev)
        nodes = torch.as_tensor(b.nodes, dtype=torch.int64, device=dev)
        if rec.enabled:
            b0, t0 = LIBRARIES.builds, time.perf_counter()
        with rec.span("prox_bucket_solve", deg_pad=b.deg_pad,
                      k=len(b.nodes)):
            W = _solve_bucket_prox_impl(
                X, nodes,
                torch.as_tensor(b.nbrs, dtype=torch.int64, device=dev),
                torch.as_tensor(b.mask, device=dev), node_tf[nodes],
                rows(start), _bucket_weights(sample_weight, b.nodes, n),
                rows(lam), rows(rho), rows(bar), include_singleton, n_iter,
                sample_weight is not None, family, use_kernel=use_kernel)
            W = W.cpu().numpy()
        if rec.enabled:
            rec.observe("engine.prox_dispatch_s", time.perf_counter() - t0,
                        deg_pad=b.deg_pad, compiled=LIBRARIES.builds > b0)
        out[idx[valid]] = W[valid]
    return out


def prox_update_batched(graph: Graph, X: torch.Tensor,
                        theta_bar, lambdas: Sequence[np.ndarray],
                        rhos: Sequence[np.ndarray],
                        thetas0: Optional[Sequence] = None,
                        include_singleton: bool = True,
                        theta_fixed: Optional[torch.Tensor] = None,
                        sample_weight: Optional[torch.Tensor] = None,
                        n_iter: int = 15, family=None,
                        use_kernel: bool = True,
                        recorder=None) -> List[np.ndarray]:
    """Batched ADMM primal update across all nodes (one solve per bucket).

    ``lambdas`` / ``rhos`` are length-p lists of ``beta_i``-length vectors;
    ``theta_bar`` is the full flat consensus iterate or, for asynchronous
    streaming where every node holds its own consensus view, a length-p
    list of ``beta_i``-length vectors. ``thetas0`` are optional warm starts
    (a node without one starts at its consensus view). ``sample_weight``,
    ``family``, ``use_kernel`` and ``recorder`` are as in
    :func:`prox_update_flat`; ``X`` is an (n, p) tensor on the device
    the solve runs on. Returns the updated per-node theta vectors (numpy,
    in the solver type).
    """
    if family is None:
        family = ISING
    off, param = local_layout(graph, family, include_singleton)
    if isinstance(theta_bar, (list, tuple)):
        bar = np.concatenate([np.asarray(b, dtype=np.float64)
                              for b in theta_bar])
    else:
        bar = np.asarray(theta_bar, dtype=np.float64)[param]
    # warm starts where given; the consensus view elsewhere
    start = bar.copy()
    if thetas0 is not None:
        for i, t0 in enumerate(thetas0):
            if t0 is not None:
                start[off[i]:off[i + 1]] = np.asarray(t0, dtype=np.float64)
    out = prox_update_flat(
        graph, X, bar, np.concatenate(lambdas), np.concatenate(rhos), start,
        include_singleton, theta_fixed, sample_weight, n_iter, family,
        use_kernel, recorder)
    return np.split(out, off[1:-1])
