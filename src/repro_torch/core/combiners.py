"""Pluggable one-step consensus combiners behind a registry.

The paper's combination methods (Sec. 3.1, Eq. 4-5, 7) — and their sequel
framing as interchangeable moment-matching strategies over exponential
families (Liu & Ihler 2014) — are *strategies*, not branches: each one turns
the per-owner local estimates of a shared parameter into one consensus
value. This module mirrors the model-family registry
(:mod:`repro_torch.core.families`): a combiner is a small strategy object
registered by name via :func:`register_combiner`, resolved by
:func:`get_combiner`, and enumerated by :func:`registered_combiners`; the
estimation-plan API (:mod:`repro_torch.api`), ``consensus.combine``, the streaming
simulator, benchmarks, and the conformance harness all dispatch through it.

Each combiner declares what it ``needs`` — ``"variance"`` (the sandwich
diagonal), ``"influence"`` (per-sample influence columns, the expensive
second-order cross-covariance input of Linear-Opt), ``"hessian"`` (full
local Hessians) — so a compiled session only computes or retains the
second-order objects some *requested* combiner actually asks for, and
``scalars_per_shared_param`` — the per-parameter message size the shared
communication accounting bills (``None`` marks a combiner that is not
distributable as one message round, e.g. the matrix reference).

Registered combiners:

  uniform        — Linear-Uniform, w = 1                          (Eq. 4)
  diagonal       — Linear-Diagonal, w^i_a = 1 / Vhat^i_aa         (Prop 4.7)
  optimal        — Linear-Opt, w_a = Vhat_a^{-1} e                (Prop 4.6)
  max            — Max-Diagonal voting: argmax 1 / Vhat^i_aa      (Prop 4.4)
  weighted_vote  — variance-weighted voting: owners vote for their estimate
                   with mass 1 / Vhat^i_aa and the weighted *median* wins —
                   the soft generalization of max-voting suggested by the
                   moment-matching view (Liu & Ihler 2014): with two owners
                   it coincides with max-voting (up to ties), with larger
                   owner sets it is robust to any minority of diverged
                   owners without collapsing to a single voter.
  matrix         — matrix consensus W^i = Hhat^i (Eq. 7)          (Cor 4.2)
  trimmed_mean   — Byzantine-robust coordinate-wise trimmed mean: symmetric
                   order-statistic trimming for larger owner sets, plus an
                   anchored compatibility filter (candidates statistically
                   incompatible with the home owner are discarded) that
                   stays meaningful at the paper's two-owner edge blocks.
  krum           — Krum-style nearest-neighbor selection (Blanchard et al.
                   2017 adapted to scalar owner candidates): the candidate
                   with the smallest summed distance to its nearest
                   neighbors wins; exact score ties prefer the home owner,
                   so a lying peer can never displace the home's own data.

Each combiner also declares its ``breakdown_point`` — the fraction of
Byzantine (arbitrarily corrupted) owner candidates it tolerates before the
combined value can be driven arbitrarily far. The classical linear schemes
all have breakdown 0 (one lying owner moves the mean arbitrarily); the
voting/robust schemes trade statistical efficiency for a positive one.

The grouped vectorized driver (pad per-node fits into dense float64 stacks,
group parameters by owner count, batch every group's weighting) is the
engine previously inlined in ``consensus.combine``; its numerics are pinned
to 1e-10 by the golden fixtures, so strategies only supply *weights*.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from .asymptotics import free_indices, param_owners
from .graphs import Graph

#: estimates beyond this magnitude mark a diverged local fit
#: (quasi-separation); shared with repro_torch.stream's warm-start reset and
#: message guards so streaming disqualifies owners exactly when combine does
TRUST_RADIUS = 25.0


class Combiner:
    """One consensus combination strategy.

    Subclasses either override :meth:`group_weights` (linear/voting schemes
    that fit the grouped driver) or :meth:`combine` wholesale (the matrix
    reference). ``needs`` declares which second-order inputs the strategy
    reads so sessions can skip producing the rest.
    """

    name: str = ""
    #: subset of {"variance", "influence", "hessian"}
    needs: frozenset = frozenset()
    #: scalars per shared parameter in a one-step message (None: the
    #: combiner is not expressible as one distributable message round)
    scalars_per_shared_param: Optional[int] = None
    #: fraction of Byzantine owner candidates tolerated before the combined
    #: value can be driven arbitrarily far (0.0 for the linear schemes)
    breakdown_point: float = 0.0
    #: True for robust combiners whose streaming fusion anchors on the
    #: receiver's OWN candidate — the simulator then passes ``own_index``
    #: to :meth:`combine_candidates` (third-party combiners with the plain
    #: single-argument signature are never handed the extra keyword)
    anchored: bool = False

    # ------------------------------------------------------------- strategy
    def group_weights(self, est: np.ndarray, diag: np.ndarray,
                      bad: np.ndarray,
                      cols: Optional[np.ndarray]) -> np.ndarray:
        """(P, k) combination weights for one owner-count group.

        est — (P, k) owner estimates (zeroed where ``bad``); diag — (P, k)
        sandwich-variance diagonals (``inf`` where ``bad``); bad — (P, k)
        disqualified-owner mask; cols — (P, k, n) per-sample influence
        columns, only provided when ``"influence" in self.needs``.
        """
        raise NotImplementedError

    def combine_candidates(self, cands: List[Tuple[float, float]]) -> float:
        """Streaming-side combination of ``(estimate, variance)`` candidate
        pairs for ONE parameter — the simulator's receiver-side fuse of its
        own fit with possibly-stale peer views. Only combiners implementing
        this are streamable one-step schemes."""
        raise NotImplementedError(
            f"combiner {self.name!r} is not a streamable one-step scheme")

    def filter_mask(self, cands: List[Tuple[float, float]],
                    own_index: Optional[int] = None
                    ) -> Optional[np.ndarray]:
        """(k,) boolean keep mask a *filtering* robust combiner would apply
        to ``cands`` before averaging, or None when the strategy does not
        reject candidates (linear and voting schemes select/weight instead
        of discarding). The observability hook behind the streaming
        simulator's robust-combiner rejection counters — it must match
        what :meth:`combine_candidates` actually drops."""
        return None

    # --------------------------------------------------------------- driver
    def combine(self, graph: Graph, fits, include_singleton: bool = True,
                theta_fixed: Optional[np.ndarray] = None,
                family=None) -> np.ndarray:
        """One-step consensus estimate; returns the full flat theta vector.

        Vectorized over the owner structure: parameters are grouped by owner
        count and every group's weights/averages are computed with batched
        float64 array ops (no per-parameter Python loop). Single-owner
        parameters — the singleton blocks — pass the local estimate through
        exactly. With a ``family``, ownership runs over the family's
        parameter *blocks*; the default is the scalar Ising layout.
        """
        n_params = graph.n_params if family is None else family.n_params(graph)
        if theta_fixed is None:
            theta_fixed = np.zeros(n_params, dtype=np.float64)
        theta = np.array(theta_fixed, dtype=np.float64, copy=True)

        # pad per-node results into dense (p, dmax) float64 stacks
        dmax = max(len(f.theta) for f in fits)
        theta_mat = np.zeros((graph.p, dmax), dtype=np.float64)
        vdiag_mat = np.ones((graph.p, dmax), dtype=np.float64)
        for f in fits:
            d = len(f.theta)
            theta_mat[f.i, :d] = f.theta
            vdiag_mat[f.i, :d] = np.diag(f.V)
        s_pad = None
        if "influence" in self.needs:
            n = fits[0].s.shape[0]
            if n == 0:
                raise ValueError(
                    f"combiner {self.name!r} needs per-sample influence "
                    f"columns, but the local fits were computed without "
                    f"them (want_influence=False / a plan whose combiners "
                    f"did not request 'influence')")
            s_pad = np.zeros((graph.p, n, dmax), dtype=np.float64)
            for f in fits:
                s_pad[f.i, :, :len(f.theta)] = f.s

        for k, (aidx, node, pos) in _owner_groups_of(
                graph, include_singleton, family).items():
            est = theta_mat[node, pos]                          # (P, k)
            diag = np.maximum(vdiag_mat[node, pos], 1e-12)
            # Robustness guard: a saturated/diverged local fit
            # (quasi-separation, e.g. high-degree hubs at small n) yields
            # non-finite estimates or a deceptively tiny Vhat. Treat such
            # owners as infinite-variance so every weighting scheme zeroes
            # them out; keep uniform truly uniform only over sane owners.
            bad = (~np.isfinite(est)) | (~np.isfinite(diag)) \
                | (np.abs(est) > TRUST_RADIUS)
            est = np.where(bad, 0.0, est)
            all_bad = bad.all(axis=1)

            if k == 1:
                # exact passthrough: a parameter with one owner (the
                # singletons) IS the local estimate under every scheme.
                theta[aidx] = np.where(all_bad, 0.0, est[:, 0])
                continue

            diag = np.where(bad, np.inf, diag)
            cols = s_pad[node, :, pos] if s_pad is not None else None
            w = self.group_weights(est, diag, bad, cols)
            w = np.where(bad, 0.0, w)
            wsum = np.where(all_bad, 1.0, w.sum(axis=1))
            theta[aidx] = np.where(all_bad, 0.0, (w * est).sum(axis=1) / wsum)
        return theta


@functools.lru_cache(maxsize=128)
def _owner_groups_of(graph: Graph, include_singleton: bool, family):
    """:func:`_owner_groups` of a graph's owner structure, cached like
    :func:`param_owners` (the grouping walks every parameter in Python);
    treat the returned arrays as read-only."""
    return _owner_groups(param_owners(graph, include_singleton, family))


def _owner_groups(owners: Dict[int, List[Tuple[int, int]]]):
    """Group params by owner count k -> (param_idx (P,), node (P,k), pos (P,k)).

    Owner counts are tiny (1 for singletons, 2 for edges), so grouping by k
    turns the per-parameter Python loop into a handful of batched array ops.
    """
    by_k: Dict[int, List[Tuple[int, List[Tuple[int, int]]]]] = {}
    for a, own in owners.items():
        by_k.setdefault(len(own), []).append((a, own))
    out = {}
    for k, items in by_k.items():
        aidx = np.array([a for a, _ in items], dtype=np.int64)
        node = np.array([[i for (i, _) in own] for _, own in items],
                        dtype=np.int64)
        pos = np.array([[p_ for (_, p_) in own] for _, own in items],
                       dtype=np.int64)
        out[k] = (aidx, node, pos)
    return out


# ------------------------------------------------------------- strategies
class UniformCombiner(Combiner):
    """Linear-Uniform (Eq. 4): every sane owner weighs 1."""
    name = "uniform"
    needs = frozenset()
    scalars_per_shared_param = 1     # estimate only; unit weights not sent

    def group_weights(self, est, diag, bad, cols):
        return np.where(bad, 0.0, 1.0)

    def combine_candidates(self, cands):
        return float(np.mean([e for e, _ in cands]))


class DiagonalCombiner(Combiner):
    """Linear-Diagonal (Prop 4.7): inverse-variance weights."""
    name = "diagonal"
    needs = frozenset({"variance"})
    scalars_per_shared_param = 2     # estimate + 1/Vhat_aa weight

    def group_weights(self, est, diag, bad, cols):
        return 1.0 / diag

    def combine_candidates(self, cands):
        w = np.array([1.0 / v for _, v in cands])
        e = np.array([e for e, _ in cands])
        return float((w @ e) / w.sum())


class MaxCombiner(Combiner):
    """Max-Diagonal voting (Prop 4.4): the min-variance owner wins."""
    name = "max"
    needs = frozenset({"variance"})
    scalars_per_shared_param = 2     # estimate + weight; receiver argmaxes

    def group_weights(self, est, diag, bad, cols):
        w = np.zeros_like(est)
        w[np.arange(est.shape[0]), np.argmin(diag, axis=1)] = 1.0
        return w

    def combine_candidates(self, cands):
        return min(cands, key=lambda c: c[1])[0]


class WeightedVoteCombiner(Combiner):
    """Variance-weighted voting (Liu & Ihler 2014's moment-matching view of
    voting): each owner votes for its estimate with mass 1 / Vhat^i_aa; the
    weighted *median* of the votes wins. With two owners this coincides
    with max-voting (up to exact weight ties); with larger owner sets it
    stays robust to any minority of diverged owners without handing the
    whole decision to a single voter the way argmax does."""
    name = "weighted_vote"
    needs = frozenset({"variance"})
    scalars_per_shared_param = 2     # estimate + vote mass

    def group_weights(self, est, diag, bad, cols):
        # one-hot weights at the weighted-median owner, so the grouped
        # driver's weighted average reduces to the winning vote exactly
        w = 1.0 / diag                                        # 0 where bad
        order = np.argsort(est, axis=1, kind="stable")
        w_s = np.take_along_axis(w, order, axis=1)
        cum = np.cumsum(w_s, axis=1)
        half = 0.5 * cum[:, -1:]
        # first sorted position whose cumulative vote mass reaches half;
        # zero-mass (bad) positions can never be first to cross
        med = np.argmax(cum >= half, axis=1)
        onehot = np.zeros_like(est)
        rows = np.arange(est.shape[0])
        onehot[rows, order[rows, med]] = 1.0
        return onehot

    def combine_candidates(self, cands):
        order = sorted(range(len(cands)), key=lambda i: cands[i][0])
        masses = np.array([1.0 / cands[i][1] for i in order])
        cum = np.cumsum(masses)
        med = int(np.argmax(cum >= 0.5 * cum[-1]))
        return float(cands[order[med]][0])


class TrimmedMeanCombiner(Combiner):
    """Byzantine-robust coordinate-wise trimmed mean.

    Two filters compose, then the surviving candidates are plainly
    averaged:

    * **symmetric order-statistic trim** — drop the ``floor(trim * k)``
      smallest and largest estimates among the sane candidates (the
      classical coordinate-wise trimmed mean; breakdown point = ``trim``).
      With the paper's two-owner edge blocks this trims nothing, which is
      why the second filter exists;
    * **anchored compatibility filter** — candidates farther than
      ``kappa * sqrt(V_anchor + V_cand)`` from the *home* candidate
      (column 0 convention: the lowest-index sane owner in the batch
      driver, the receiver's own fit in streaming fusion) are discarded.
      Since the streamed variances shrink as 1/n_i, any fixed-magnitude
      lie (sign-flip, colluding constant) is eventually rejected, while
      honest candidates — estimates of the same truth — stay within a few
      standard errors of the anchor.

    A Byzantine *peer* therefore never moves the combined value beyond the
    compatibility radius of the home's own data; only a corrupted home
    (which no per-parameter rule can fix at two owners) breaks it.
    """
    name = "trimmed_mean"
    needs = frozenset({"variance"})
    scalars_per_shared_param = 2     # estimate + variance (the filter input)
    anchored = True

    def __init__(self, trim: float = 0.25, kappa: float = 3.0) -> None:
        if not (0.0 <= trim < 0.5):
            raise ValueError(
                f"trim fraction must be in [0.0, 0.5), got {trim!r} "
                f"(trimming half or more of the owners from each side "
                f"leaves nothing to average)")
        if not (kappa > 0.0 and np.isfinite(kappa)):
            raise ValueError(f"kappa must be a finite positive "
                             f"compatibility radius, got {kappa!r}")
        self.trim = float(trim)
        self.kappa = float(kappa)
        self.breakdown_point = float(trim)

    def _keep_mask(self, est: np.ndarray, var: np.ndarray,
                   bad: np.ndarray, anchor: np.ndarray) -> np.ndarray:
        """(P, k) keep mask: symmetric trim ∩ anchored compatibility."""
        P, k = est.shape
        rows = np.arange(P)
        a_e = est[rows, anchor]
        a_v = np.where(np.isfinite(var[rows, anchor]),
                       var[rows, anchor], 0.0)
        tol = self.kappa * np.sqrt(np.maximum(a_v[:, None] + var, 1e-24))
        keep = np.abs(est - a_e[:, None]) <= tol
        # symmetric trim among sane candidates: rank sane estimates
        # ascending (bad pushed to the end) and drop t from each side
        sane = (~bad).sum(axis=1)
        t = np.minimum((self.trim * sane).astype(np.int64),
                       np.maximum(sane - 1, 0) // 2)
        order = np.argsort(np.where(bad, np.inf, est), axis=1, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(rank, order, np.broadcast_to(np.arange(k), (P, k)),
                          axis=1)
        keep &= (rank >= t[:, None]) & (rank < (sane - t)[:, None])
        # the anchor itself always survives (it is its own reference)
        keep[rows, anchor] = True
        return keep & ~bad

    def group_weights(self, est, diag, bad, cols):
        anchor = np.argmax(~bad, axis=1)         # first sane owner = home
        return self._keep_mask(est, diag, bad, anchor).astype(np.float64)

    def filter_mask(self, cands, own_index=None):
        est = np.array([[e for e, _ in cands]])
        var = np.array([[v for _, v in cands]])
        bad = ~np.isfinite(est) | ~np.isfinite(var)
        anchor = np.array([0 if own_index is None else int(own_index)])
        return self._keep_mask(est, var, bad, anchor)[0]

    def combine_candidates(self, cands, own_index=None):
        keep = self.filter_mask(cands, own_index=own_index)
        est = np.array([e for e, _ in cands])
        return float(np.mean(est[keep]))


class KrumCombiner(Combiner):
    """Krum-style nearest-neighbor selection over owner candidates.

    Each sane candidate is scored by the summed squared distance to its
    ``q = max(k_sane - t - 2, 1)`` nearest other candidates (``t =
    floor((k_sane - 1) / 2)`` assumed Byzantines, the Krum rule of
    Blanchard et al. 2017 collapsed to per-coordinate scalars); the lowest
    score wins. Exact score ties — in particular the unavoidable tie at
    the paper's two-owner edge blocks, where both candidates see the same
    single distance — resolve to the *home* candidate (column 0 in the
    batch driver, the receiver's own fit in streaming fusion): when
    geometry cannot distinguish honest from lying, trust your own data.
    Needs no transmitted variance, so its messages are as cheap as
    Linear-Uniform's.
    """
    name = "krum"
    needs = frozenset()
    scalars_per_shared_param = 1     # estimate only (distances need no V)
    breakdown_point = 0.5
    anchored = True

    @staticmethod
    def _scores(est: np.ndarray, bad: np.ndarray) -> np.ndarray:
        """(P, k) Krum scores (inf where bad)."""
        d2 = (est[:, :, None] - est[:, None, :]) ** 2          # (P, k, k)
        k = est.shape[1]
        eye = np.eye(k, dtype=bool)
        invalid = bad[:, :, None] | bad[:, None, :] | eye
        d2 = np.where(invalid, np.inf, d2)
        d2_sorted = np.sort(d2, axis=2)
        sane = (~bad).sum(axis=1)
        t = np.maximum(sane - 1, 0) // 2
        q = np.maximum(sane - t - 2, 1)
        take = np.minimum(q, np.maximum(sane - 1, 1))          # (P,)
        idx = np.arange(k)
        mask = idx[None, None, :] < take[:, None, None]
        scores = np.where(mask & np.isfinite(d2_sorted),
                          d2_sorted, 0.0).sum(axis=2)
        return np.where(bad, np.inf, scores)

    def group_weights(self, est, diag, bad, cols):
        scores = self._scores(est, bad)
        # argmin takes the FIRST minimum: column order is owner (node)
        # order, so exact ties resolve to the lowest-index sane owner —
        # the home-sensor convention
        winner = np.argmin(scores, axis=1)
        onehot = np.zeros_like(est)
        onehot[np.arange(est.shape[0]), winner] = 1.0
        return onehot

    def combine_candidates(self, cands, own_index=None):
        est = np.array([[e for e, _ in cands]])
        bad = ~np.isfinite(est)
        scores = self._scores(est, bad)[0]
        if own_index is not None and np.isfinite(scores[own_index]) \
                and scores[own_index] <= scores.min():
            return float(est[0, own_index])
        return float(est[0, int(np.argmin(scores))])


class OptimalCombiner(Combiner):
    """Linear-Opt (Prop 4.6): weights from the empirical cross-covariance
    of the owners' influence columns, with a diagonal fallback when the
    covariance is degenerate."""
    name = "optimal"
    needs = frozenset({"variance", "influence"})
    scalars_per_shared_param = 2     # + the n influence samples, billed
    #                                  separately (see stream.costs)

    def group_weights(self, est, diag, bad, cols):
        n = cols.shape[-1]
        Va = cols @ cols.transpose(0, 2, 1) / n               # (P, k, k)
        k = est.shape[1]
        finite = np.isfinite(Va).all(axis=(1, 2))
        Va = np.where(finite[:, None, None], Va, np.eye(k))
        w = np.linalg.solve(Va + 1e-10 * np.eye(k),
                            np.ones((est.shape[0], k, 1)))[..., 0]
        fallback = (bad.any(axis=1) | ~finite
                    | (np.abs(w.sum(axis=1)) < 1e-12))
        return np.where(fallback[:, None], 1.0 / diag, w)


class MatrixCombiner(Combiner):
    """Matrix consensus with W^i = Hhat^i (Eq. 7, Cor 4.2).

    Not distributable (global matrix inverse) — included as the reference
    point that is asymptotically equivalent to joint MPLE.

    Diverged local fits (non-finite theta/H, or estimates outside the
    shared trust radius) are *excluded* from the information sums — the
    same disqualification rule the grouped driver applies — instead of
    poisoning the global solve with NaNs; parameters whose every
    contributing fit was excluded fall back to ``theta_fixed`` through the
    ridge term.
    """
    name = "matrix"
    needs = frozenset({"hessian"})
    scalars_per_shared_param = None

    def combine(self, graph, fits, include_singleton=True, theta_fixed=None,
                family=None):
        n_params = graph.n_params if family is None else family.n_params(graph)
        if theta_fixed is None:
            theta_fixed = np.zeros(n_params, dtype=np.float64)
        theta = np.array(theta_fixed, dtype=np.float64, copy=True)
        free = free_indices(graph, include_singleton, family)
        pos_of = {int(a): k for k, a in enumerate(free)}
        d = len(free)
        W_sum = np.zeros((d, d))
        Wt_sum = np.zeros(d)
        for f in fits:
            if not (np.all(np.isfinite(f.theta)) and np.all(np.isfinite(f.H))
                    and np.max(np.abs(f.theta)) <= TRUST_RADIUS):
                continue
            idx = np.array([pos_of[a] for a in f.beta])
            W_sum[np.ix_(idx, idx)] += f.H
            Wt_sum[idx] += f.H @ f.theta
        sol = np.linalg.solve(W_sum + 1e-10 * np.eye(d), Wt_sum)
        theta[free] = sol
        return theta


# --------------------------------------------------------------- registry
_REGISTRY: Dict[str, Combiner] = {}


def register_combiner(combiner: Combiner) -> Combiner:
    """Register (or replace) a combiner instance under ``combiner.name``."""
    if not combiner.name:
        raise ValueError("combiner needs a non-empty name")
    _REGISTRY[combiner.name] = combiner
    return combiner


def get_combiner(name: str) -> Combiner:
    """Resolve a combiner by registry name; unknown names fail loudly with
    the list of registered schemes (never fall through silently)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown combiner scheme {name!r}; registered combiners: "
            f"{[c.name for c in registered_combiners()]}") from None


def registered_combiners() -> Tuple[Combiner, ...]:
    """All registered combiners, name-sorted (the conformance axis)."""
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def streamable_combiners() -> Tuple[Combiner, ...]:
    """Combiners usable as streaming one-step schemes: distributable as one
    message round AND able to fuse (estimate, variance) candidate pairs on
    the receiver — detected by the subclass *overriding*
    ``combine_candidates`` (never by executing it on fabricated data,
    which would let one misbehaving third-party combiner break simulator
    construction for every scheme). Registration order (paper order
    first)."""
    return tuple(
        c for c in _REGISTRY.values()
        if c.scalars_per_shared_param is not None
        and type(c).combine_candidates is not Combiner.combine_candidates)


#: canonical instances — the paper's four schemes, the matrix reference,
#: and the 2014 variance-weighted-voting addition (the registry's proof of
#: pluggability)
UNIFORM = register_combiner(UniformCombiner())
DIAGONAL = register_combiner(DiagonalCombiner())
OPTIMAL = register_combiner(OptimalCombiner())
MAX = register_combiner(MaxCombiner())
MATRIX = register_combiner(MatrixCombiner())
WEIGHTED_VOTE = register_combiner(WeightedVoteCombiner())
TRIMMED_MEAN = register_combiner(TrimmedMeanCombiner())
KRUM = register_combiner(KrumCombiner())
