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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels.cl.ops import bucket_newton_stats_op
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
    newton_stats)``; ``newton_stats`` is the per-iteration hot path through
    the fused kernel dispatch (a family without a registered epilogue
    raises there), and reads the design in its own type. The other
    closures contract in the solver type (``denom``'s): a bfloat16 design is
    promoted once here, where the reference's type promotion did it per
    contraction.
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

    def newton_stats(W):
        return bucket_newton_stats_op(family.kernel_kind, *kernel_in, W,
                                      sw if weighted else None,
                                      use_kernel=use_kernel)

    return score_curvature, curvature_matrix, avg_loglik, score_matrix, \
        newton_stats


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
    n = X.shape[0]
    Zb, xi, base, cmask = _bucket_design(family, X, nodes, nbrs, mask,
                                         offsets, include_singleton)
    k, C, d, _ = Zb.shape
    dC = d * C
    cdtype = _solver_dtype(Zb.dtype)
    dev = Zb.device
    W = W0.to(cdtype)
    eye = torch.eye(dC, dtype=cdtype, device=dev)
    # -1 on padded diagonals keeps the (exactly block-diagonal) system
    # uniformly negative definite without touching the real block's
    # Newton direction.
    cflat = _flat_coord_mask(cmask, C).to(cdtype)
    pad_diag = (1.0 - cflat)[:, :, None] * eye[None, :, :]
    if weighted:
        sw = sw.to(cdtype)
        denom = torch.clamp(torch.sum(sw, dim=1), min=1.0)   # (k,)
    else:
        denom = torch.full((k,), float(n), dtype=cdtype, device=dev)

    score_curvature, curvature_matrix, objective, score_matrix, \
        newton_stats = _channel_ops(family, Zb, base, xi, sw, weighted, denom,
                                    use_kernel)

    # The reference's bucket-wide while_loop: a Python loop whose stop test
    # reads one device scalar (the step's inf-norm) per iteration.
    it = 0
    delta = float("inf")
    while it < n_iter and delta > tol:
        g_raw, K_raw = newton_stats(W)           # fused score + Gram
        # the kernel returns float32 statistics; a float64 solver state
        # promotes them explicitly, as on the TPU
        g = g_raw.to(cdtype) / denom[:, None]
        H = -K_raw.to(cdtype) / denom[:, None, None] \
            - ridge * eye[None, :, :] - pad_diag
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
            # warm starts only: guard an untrusted direction with a per-node
            # backtracking search over Newton + gradient candidates
            step = _backtrack_step(objective, W, dirn, g, max_step)
        else:
            step = dirn
        delta = float(torch.max(torch.abs(step)))
        W = W - step
        it += 1
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
        S = torch.zeros((k, 0, dC), dtype=cdtype, device=dev)
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
                          iters: Optional[dict] = None) -> List[LocalFit]:
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
    """
    if family is None:
        family = ISING
    C = family.block_dim
    dev = X.device
    if theta_fixed is None:
        theta_fixed = torch.zeros(family.n_params(graph), dtype=X.dtype,
                                  device=dev)
    node_tf = theta_fixed[: graph.p * C].reshape(graph.p, C)
    n = X.shape[0]
    lead = 1 if include_singleton else 0
    cdtype = _solver_dtype(X.dtype)

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
        W, H, J, V, S, I = _solve_bucket_impl(
            X, nodes, nbrs, mask, offsets, W0, sw, include_singleton,
            n_iter, sample_weight is not None, warm_start is not None,
            family, want_influence=want_influence, use_kernel=use_kernel)
        if iters is not None:
            iters[b.deg_pad] = int(I[0])
        W, H, J, V, S = (t.cpu().numpy() for t in (W, H, J, V, S))
        degs = b.mask.sum(axis=1).astype(np.int64)
        for row, i in enumerate(b.nodes):
            i = int(i)
            di = (lead + int(degs[row])) * C
            out[i] = LocalFit(
                i=i, beta=family.beta(graph, i, include_singleton),
                theta=W[row, :di].copy(), H=H[row, :di, :di].copy(),
                J=J[row, :di, :di].copy(), V=V[row, :di, :di].copy(),
                s=S[row, :, :di].copy())
    return out  # type: ignore[return-value]
