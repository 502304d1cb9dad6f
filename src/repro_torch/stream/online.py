"""Online local estimators: incremental, warm-started re-fits over a stream.

Each sensor's conditional-likelihood M-estimator (paper Eq. 3) is an average
over its observed samples, so as chunks arrive the optimum moves only
O(new/total). :class:`StreamingEstimator` pools arrivals into a
shape-stable :class:`~repro_torch.stream.buffer.SampleBuffer` on the
device, tracks how far into the pool each sensor has seen (prefix counts),
and re-fits every node through the degree-bucketed batched engine with
per-node fit weights built on the device and the previous thetas as Newton
warm starts: on the card every Newton iteration of a refit is one
weighted launch of the Newton kernel. Any registered family streams.

:func:`pseudo_score` is the observer-side any-time diagnostic: the exact
gradient of the average pseudo-likelihood at an arbitrary theta, in one
fused score-kernel pass over the padded buffer.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.batched import fit_all_local_batched
from ..core.combiners import TRUST_RADIUS
from ..core.estimators import LocalFit
from ..core.families import ISING
from ..core.graphs import Graph
from ..kernels.cl.epilogues import get_epilogue
from ..kernels.cl.family import fused_pseudo_score
from ..telemetry.recorder import NULL_RECORDER
from .buffer import SampleBuffer, discount_table


class StreamingEstimator:
    """Bank of all p per-node online CL estimators over a shared pool.

    The pool model: the environment draws i.i.d. samples x_1, x_2, ...;
    sensor i has observed the first ``counts[i]`` of them. ``refit()``
    updates every node's local fit to its current prefix (optionally a
    sliding ``window`` of it, or ``discount``-weighted by age).

    Obtain instances through ``repro_torch.api.Plan(...).session().
    stream()``, which binds family, fixed coordinates, capacity, Newton
    budget, window and device to one plan. The pool lives on ``device``
    (the CUDA card when None).
    """

    def __init__(self, graph: Graph, include_singleton: bool = True,
                 theta_fixed: Optional[np.ndarray] = None,
                 capacity: int = 64, n_iter: int = 40,
                 family=None, want_influence: bool = True,
                 window: Optional[int] = None,
                 discount: Optional[float] = None, device=None,
                 recorder=None) -> None:
        if window is not None and int(window) < 1:
            raise ValueError(
                f"sliding window must be >= 1 sample (None disables it), "
                f"got {window!r}")
        if discount is not None and not (0.0 < float(discount) <= 1.0):
            raise ValueError(
                f"discount must be in (0.0, 1.0] (1.0 = no forgetting, "
                f"None disables it), got {discount!r}")
        self.window = None if window is None else int(window)
        self.discount = None if discount is None else float(discount)
        #: telemetry recorder; the shared allocation-free NULL_RECORDER
        #: unless an owner (session or simulator) injects a live one
        self.recorder = NULL_RECORDER if recorder is None else recorder
        self.graph = graph
        self.family = ISING if family is None else family
        #: False skips the (n, d) per-sample influence stacks on every
        #: re-fit (LocalFit.s then has zero rows)
        self.want_influence = want_influence
        self.include_singleton = include_singleton
        n_params = self.family.n_params(graph)
        self.theta_fixed = (np.zeros(n_params, dtype=np.float64)
                            if theta_fixed is None
                            else np.asarray(theta_fixed, dtype=np.float64))
        self.n_iter = n_iter
        self.buffer = SampleBuffer(graph.p, capacity=capacity, device=device)
        self.counts = np.zeros(graph.p, dtype=np.int64)
        self.versions = np.zeros(graph.p, dtype=np.int64)
        self.fits: Optional[List[LocalFit]] = None
        self._warm: Optional[List[Optional[np.ndarray]]] = None
        self._fit_counts = np.full(graph.p, -1, dtype=np.int64)

    @property
    def device(self) -> torch.device:
        return self.buffer.device

    # ------------------------------------------------------------ ingestion
    def extend_pool(self, rows) -> None:
        """Append environment samples to the shared pool (nobody has seen
        them yet until ``advance``/``ingest`` says so)."""
        self.buffer.append(rows)

    def advance(self, counts) -> None:
        """Move per-node seen-counts forward (monotone, clipped to pool)."""
        counts = np.minimum(np.asarray(counts, dtype=np.int64), self.buffer.n)
        if np.any(counts < self.counts):
            raise ValueError("seen-counts must be monotone nondecreasing")
        self.counts = counts

    def ingest(self, rows) -> None:
        """Append rows and let every node see the whole pool: feeding the
        same data in k chunks or at once yields the same fits (to Newton
        tolerance)."""
        self.extend_pool(rows)
        self.advance(np.full(self.graph.p, self.buffer.n, dtype=np.int64))

    @property
    def n_pool(self) -> int:
        return self.buffer.n

    @property
    def effective_counts(self) -> np.ndarray:
        """Per-node effective sample sizes: the total fit weight each node
        places on the pool (``counts`` without a window or discount), from
        the counts alone on the host."""
        seen = self.counts if self.window is None \
            else np.minimum(self.counts, self.window)
        if self.discount is None or self.discount >= 1.0:
            return seen.astype(np.float64)
        table = discount_table(self.discount, self.buffer.capacity)
        cum = np.concatenate([[0.0], np.cumsum(table, dtype=np.float64)])
        return cum[seen]

    # ------------------------------------------------------------ durability
    def state_dict(self):
        """Full restorable state as (arrays, json_meta), numpy arrays under
        the reference's keys: pool, per-node prefix counts/versions, warm
        starts, and the fitted LocalFit bank."""
        arrays = {
            "est/pool": self.buffer.data.copy(),
            "est/counts": self.counts.copy(),
            "est/versions": self.versions.copy(),
            "est/fit_counts": self._fit_counts.copy(),
            "est/theta_fixed": self.theta_fixed.copy(),
        }
        meta = {
            "n": int(self.buffer.n),
            "window": self.window,
            "discount": self.discount,
            "warm": [w is not None for w in (self._warm or [])],
            "betas": None,
        }
        if self._warm is not None:
            for i, w in enumerate(self._warm):
                if w is not None:
                    arrays[f"est/warm_{i}"] = np.asarray(w)
        if self.fits is not None:
            meta["betas"] = [list(map(int, f.beta)) for f in self.fits]
            for f in self.fits:
                for part in ("theta", "H", "J", "V", "s"):
                    arrays[f"est/fit{f.i}_{part}"] = np.asarray(
                        getattr(f, part))
        return arrays, meta

    def load_state(self, arrays, meta) -> None:
        """Inverse of :meth:`state_dict`, in place; the pool goes to this
        estimator's device."""
        self.buffer.load(np.asarray(arrays["est/pool"]), meta["n"])
        self.counts = np.asarray(arrays["est/counts"]).copy()
        self.versions = np.asarray(arrays["est/versions"]).copy()
        self._fit_counts = np.asarray(arrays["est/fit_counts"]).copy()
        self.theta_fixed = np.asarray(arrays["est/theta_fixed"]).copy()
        self.window = meta["window"]
        self.discount = meta["discount"]
        warm_flags = meta.get("warm") or []
        if warm_flags:
            self._warm = [
                np.asarray(arrays[f"est/warm_{i}"]).copy() if present
                else None for i, present in enumerate(warm_flags)]
        else:
            self._warm = None
        betas = meta.get("betas")
        if betas is None:
            self.fits = None
        else:
            self.fits = [
                LocalFit(i=i, beta=list(b),
                         theta=np.asarray(arrays[f"est/fit{i}_theta"]),
                         H=np.asarray(arrays[f"est/fit{i}_H"]),
                         J=np.asarray(arrays[f"est/fit{i}_J"]),
                         V=np.asarray(arrays[f"est/fit{i}_V"]),
                         s=np.asarray(arrays[f"est/fit{i}_s"]))
                for i, b in enumerate(betas)]

    # --------------------------------------------------------------- fitting
    def refit(self, use_kernel: bool = True) -> List[LocalFit]:
        """Warm-started weighted re-fit of every node at its current prefix.

        Bumps a node's version when its data changed since its last fit. A
        no-op call (no counts moved) returns the cached fits without a
        solve. ``use_kernel=False`` asks for the plain Newton statistics.
        """
        if self.fits is not None and np.array_equal(self.counts,
                                                    self._fit_counts):
            return self.fits
        rec = self.recorder
        X = self.buffer.tensor
        masks = self.buffer.window_weights(self.counts, self.window,
                                           self.discount)
        with rec.span("refit"):
            fits = fit_all_local_batched(
                self.graph, X, include_singleton=self.include_singleton,
                theta_fixed=torch.as_tensor(self.theta_fixed,
                                            device=X.device).to(X.dtype),
                n_iter=self.n_iter, sample_weight=masks,
                warm_start=self._warm, family=self.family,
                want_influence=self.want_influence, use_kernel=use_kernel,
                recorder=rec)
        if rec.enabled:
            # buffer occupancy and window effective counts at this refit,
            # all read on the host
            rec.gauge("stream.buffer_rows", int(self.buffer.n))
            rec.gauge("stream.buffer_capacity", int(self.buffer.capacity))
            rec.gauge("stream.effective_count_mean",
                      float(self.effective_counts.mean()))
        return self._finish_refit(fits)

    def _finish_refit(self, fits: List[LocalFit]) -> List[LocalFit]:
        """Post-solve bookkeeping: version bumps for nodes whose data
        changed, prefix-count snapshot, and trust-radius warm-start hygiene.
        """
        changed = self.counts != self._fit_counts
        self.versions = self.versions + changed.astype(np.int64)
        self._fit_counts = self.counts.copy()
        # a diverged fit (quasi-separation at small n drives the optimum to
        # infinity; NaN is absorbing in Newton) must not poison every future
        # re-fit through its warm start: cold-restart nodes outside the
        # trust radius the combiners use to disqualify owners
        self._warm = [
            f.theta if np.all(np.isfinite(f.theta))
            and np.max(np.abs(f.theta)) <= TRUST_RADIUS else None
            for f in fits]
        self.fits = fits
        return fits

    # ----------------------------------------------------------- diagnostics
    def score_norm(self, theta: np.ndarray, use_kernel: bool = True) -> float:
        """||grad pseudo-loglik(theta)|| over the pooled samples."""
        g = pseudo_score(self.graph, theta, self.buffer.tensor, self.buffer.n,
                         family=self.family, use_kernel=use_kernel)
        return float(np.linalg.norm(g))


def pseudo_score(graph: Graph, theta: np.ndarray, x_pad, n_seen: int,
                 family=None, use_kernel: bool = True) -> np.ndarray:
    """Exact flat gradient of the average pseudo-likelihood at ``theta``
    over the first ``n_seen`` rows of ``x_pad`` (an (n, p) tensor).

    Families whose ``kernel_kind`` has a registered epilogue (Ising,
    Gaussian, Potts) run one fused pass (see
    :func:`repro_torch.kernels.cl.family.fused_pseudo_score`); families
    without one take the autodiff score ``family.pseudo_score`` over the
    live rows (float32, on ``x_pad``'s device), as the reference does.
    """
    if family is None:
        family = ISING
    theta = np.asarray(theta, dtype=np.float64)
    if n_seen <= 0:
        return np.zeros(family.n_params(graph))
    if get_epilogue(getattr(family, "kernel_kind", None)) is None:
        return family.pseudo_score(graph, theta, x_pad[: int(n_seen)])
    return fused_pseudo_score(family, graph, theta, x_pad, n_seen,
                              use_kernel=use_kernel)
