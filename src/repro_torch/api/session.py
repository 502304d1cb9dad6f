"""Estimation sessions: one :class:`Plan` on one device -> the ``fit`` verb.

An :class:`EstimationSession` derives the graph's degree buckets, owner
structure, per-node block layouts and fixed-coordinate vector once. Sessions
are cached per ``(plan, device)`` (``EstimationSession.for_plan`` /
``plan.session()``). The device is the CUDA card unless the caller names
another: with no card and no device given, a session refuses to start.

``fit(X)`` runs the per-node local CL fits through the batched engine, every
requested one-step combiner, and the pseudo-score norm. ``stream``,
``joint``, ``select`` and ``simulate`` belong to later slices of the port.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.asymptotics import param_owners
from ..core.batched import degree_buckets, fit_all_local_batched
from ..core.estimators import LocalFit
from ..core.graphs import Graph
from ..kernels.build import LIBRARIES
from .plan import Plan
from .result import EstimateResult

#: session cache, bounded FIFO so long-lived processes cannot leak sessions
_SESSIONS: Dict[Tuple[Plan, str], "EstimationSession"] = {}
_SESSION_CACHE_MAX = 64

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def _tensor(a) -> torch.Tensor:
    """``a`` as a tensor; read-only numpy arrays (as JAX hands them out)
    are copied, since a tensor may not alias read-only memory."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and
    raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)


class EstimationSession:
    """A :class:`Plan` prepared for one device; see the module docstring."""

    def __init__(self, plan: Plan, device=None) -> None:
        self.plan = plan
        self.device = resolve_device(device)
        self.graph: Graph = plan.graph
        self.family = plan.family_instance
        self.combiners = plan.combiner_instances
        self.dtype = _DTYPES[plan.precision]

        self.buckets = degree_buckets(plan.graph)
        self.owners = param_owners(plan.graph, plan.include_singleton,
                                   self.family)
        n_params = self.family.n_params(plan.graph)
        self.theta_fixed = (np.zeros(n_params, dtype=np.float64)
                            if plan.theta_fixed is None
                            else np.asarray(plan.theta_fixed,
                                            dtype=np.float64))
        #: union of the requested combiners' second-order demands
        self.needs = frozenset().union(*(c.needs for c in self.combiners))
        self.want_influence = "influence" in self.needs
        #: owner slots of shared (multi-owner) parameters — the unit the
        #: communication accounting bills per scheme
        self.shared_owner_slots = sum(
            len(own) for own in self.owners.values() if len(own) > 1)
        self.fit_calls = 0

    @classmethod
    def for_plan(cls, plan: Plan, device=None) -> "EstimationSession":
        """The cached session for ``(plan, device)``, created on first use."""
        key = (plan, str(resolve_device(device)))
        sess = _SESSIONS.get(key)
        if sess is None:
            if len(_SESSIONS) >= _SESSION_CACHE_MAX:
                _SESSIONS.pop(next(iter(_SESSIONS)))
            sess = cls(plan, device=device)
            _SESSIONS[key] = sess
        return sess

    @property
    def n_buckets(self) -> int:
        """Degree buckets of the plan's graph."""
        return len(self.buckets)

    # ------------------------------------------------------------ helpers
    def _as_samples(self, X) -> torch.Tensor:
        return _tensor(X).to(device=self.device, dtype=self.dtype)

    def _tf(self, dtype) -> torch.Tensor:
        return torch.as_tensor(self.theta_fixed, device=self.device).to(dtype)

    def _score_norm(self, theta: np.ndarray, X, n: int,
                    use_kernel: bool = True) -> float:
        from ..stream.online import pseudo_score
        g = pseudo_score(self.graph, theta, X, n, family=self.family,
                         use_kernel=use_kernel)
        return float(np.linalg.norm(g))

    def one_step_comm(self, n: int) -> Dict[str, int]:
        """Scalars a network transmits per requested scheme (see
        :mod:`repro_torch.stream.costs`)."""
        from ..stream.costs import one_step_comm_by_scheme
        return one_step_comm_by_scheme(self.shared_owner_slots,
                                       self.plan.combiners, n)

    def fit_local(self, X, sample_weight=None, warm_start=None,
                  want_influence: Optional[bool] = None,
                  use_kernel: bool = True,
                  iters: Optional[dict] = None) -> List[LocalFit]:
        """Per-node local CL fits under this plan.

        ``use_kernel=False`` asks for the plain PyTorch Newton statistics;
        ``iters`` receives each bucket's Newton iteration count.
        """
        Xt = self._as_samples(X)
        sw = (None if sample_weight is None
              else _tensor(sample_weight).to(self.device))
        return fit_all_local_batched(
            self.graph, Xt,
            include_singleton=self.plan.include_singleton,
            theta_fixed=self._tf(Xt.dtype), n_iter=self.plan.n_iter,
            sample_weight=sw, warm_start=warm_start,
            family=self.family,
            want_influence=(self.want_influence if want_influence is None
                            else want_influence),
            use_kernel=use_kernel, iters=iters)

    # -------------------------------------------------------------- verbs
    def fit(self, X, sample_weight=None, warm_start=None,
            use_kernel: bool = True) -> EstimateResult:
        """Batch verb: local fits + every requested combiner + score norm.

        ``compile_s`` and ``new_compiles`` count the kernel-library build
        this call paid, so a warm fit reports 0.
        """
        t0 = time.perf_counter()
        b0, s0 = LIBRARIES.builds, LIBRARIES.build_s
        Xt = self._as_samples(X)
        n = int(Xt.shape[0])
        fits = self.fit_local(Xt, sample_weight=sample_weight,
                              warm_start=warm_start, use_kernel=use_kernel)
        combined = {
            c.name: c.combine(self.graph, fits,
                              include_singleton=self.plan.include_singleton,
                              theta_fixed=self.theta_fixed,
                              family=self.family)
            for c in self.combiners}
        theta = combined[self.plan.combiners[0]]
        score = self._score_norm(theta, Xt, n, use_kernel=use_kernel)
        self.fit_calls += 1
        return EstimateResult(
            mode="fit", theta=theta, combined=combined, fits=fits,
            n_samples=n, score_norm=score,
            wall_s=time.perf_counter() - t0,
            compile_s=LIBRARIES.build_s - s0,
            new_compiles=LIBRARIES.builds - b0,
            comm_scalars=self.one_step_comm(n))

    def stream(self, capacity: Optional[int] = None):
        raise NotImplementedError(
            "session.stream() comes with the streaming slice of the port")

    def joint(self, X, sample_weight=None):
        raise NotImplementedError(
            "session.joint() comes with the joint-ADMM slice of the port")

    def select(self, X, spec=None):
        raise NotImplementedError(
            "session.select() comes with the structure-learning slice of "
            "the port")

    def simulate(self, pool, **overrides):
        raise NotImplementedError(
            "session.simulate() comes with the streaming slice of the port")

    def __repr__(self) -> str:
        return (f"EstimationSession(family={self.plan.family!r}, "
                f"p={self.graph.p}, m={self.graph.m}, "
                f"buckets={self.n_buckets}, "
                f"combiners={list(self.plan.combiners)}, "
                f"device={str(self.device)!r}, fit_calls={self.fit_calls})")
