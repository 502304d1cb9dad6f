"""Estimation sessions: one :class:`Plan` on one device -> five verbs.

An :class:`EstimationSession` derives the graph's degree buckets, owner
structure, per-node block layouts and fixed-coordinate vector once. Sessions
are cached per ``(plan, device)`` (``EstimationSession.for_plan`` /
``plan.session()``). The device is the CUDA card unless the caller names
another: with no card and no device given, a session refuses to start.

* ``fit(X)``       — per-node local CL fits through the batched engine,
                     every requested one-step combiner, the pseudo-score
                     norm;
* ``stream()``     — a :class:`~repro_torch.stream.StreamingEstimator`
                     bound to the plan, its pool on the session's device;
* ``simulate(pool)`` — a :class:`~repro_torch.stream.StreamSimulator`
                     configured from the plan;
* ``joint(X)``     — ADMM joint MPLE through the batched proximal engine;
* ``select(X)``    — structure learning: distributed pseudo-likelihood
                     lasso over candidate edges and support voting
                     (:mod:`repro_torch.structure`), returning a
                     :class:`~repro_torch.structure.StructureResult`.

Each session holds one telemetry recorder, made from ``plan.telemetry``
(the allocation-free ``NULL_RECORDER`` when None); ``fit``, ``joint`` and
``select`` scope their events into ``result.telemetry``, and ``stream``
and ``simulate`` share the recorder.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.admm import admm_mple_family
from ..core.asymptotics import param_owners
from ..core.batched import (degree_buckets, fit_all_local_batched,
                            local_layout)
from ..core.estimators import LocalFit
from ..core.graphs import Graph
from ..device import resolve_device
from ..kernels.build import LIBRARIES
from ..telemetry.recorder import make_recorder
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
        #: the plan's telemetry recorder: one per session, scoped per verb
        #: call through mark()/snapshot()
        self.recorder = make_recorder(plan.telemetry)

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
                  iters: Optional[dict] = None,
                  theta_fixed=None) -> List[LocalFit]:
        """Per-node local CL fits under this plan.

        ``use_kernel=False`` asks for the plain PyTorch Newton statistics;
        ``iters`` receives each bucket's Newton iteration count;
        ``theta_fixed`` overrides the plan's fixed coordinates for this
        call only (the ``fit_all_local`` shim passes its per-call vector
        here, so varying it mints no new plan and session).
        """
        Xt = self._as_samples(X)
        tf = (self._tf(Xt.dtype) if theta_fixed is None
              else _tensor(theta_fixed).to(device=self.device,
                                           dtype=Xt.dtype))
        sw = (None if sample_weight is None
              else _tensor(sample_weight).to(self.device))
        return fit_all_local_batched(
            self.graph, Xt,
            include_singleton=self.plan.include_singleton,
            theta_fixed=tf, n_iter=self.plan.n_iter,
            sample_weight=sw, warm_start=warm_start,
            family=self.family,
            want_influence=(self.want_influence if want_influence is None
                            else want_influence),
            use_kernel=use_kernel, iters=iters, recorder=self.recorder)

    # -------------------------------------------------------------- verbs
    def fit(self, X, sample_weight=None, warm_start=None,
            use_kernel: bool = True) -> EstimateResult:
        """Batch verb: local fits + every requested combiner + score norm.

        ``compile_s`` and ``new_compiles`` count the kernel-library build
        this call paid, so a warm fit reports 0.
        """
        rec = self.recorder
        mark = rec.mark()
        t0 = time.perf_counter()
        b0, s0 = LIBRARIES.builds, LIBRARIES.build_s
        with rec.span("fit"):
            Xt = self._as_samples(X)
            n = int(Xt.shape[0])
            fits = self.fit_local(Xt, sample_weight=sample_weight,
                                  warm_start=warm_start,
                                  use_kernel=use_kernel)
            combined = {}
            for c in self.combiners:
                with rec.span("combine", scheme=c.name):
                    combined[c.name] = c.combine(
                        self.graph, fits,
                        include_singleton=self.plan.include_singleton,
                        theta_fixed=self.theta_fixed, family=self.family)
            theta = combined[self.plan.combiners[0]]
            score = self._score_norm(theta, Xt, n, use_kernel=use_kernel)
        self.fit_calls += 1
        comm = self.one_step_comm(n)
        if rec.enabled:
            for scheme, cost in comm.items():
                rec.gauge("comm.scalars_per_round", cost, scheme=scheme)
        return EstimateResult(
            mode="fit", theta=theta, combined=combined, fits=fits,
            n_samples=n, score_norm=score,
            wall_s=time.perf_counter() - t0,
            compile_s=LIBRARIES.build_s - s0,
            new_compiles=LIBRARIES.builds - b0,
            comm_scalars=comm,
            telemetry=rec.snapshot(mark) if rec.enabled else None)

    def stream(self, capacity: Optional[int] = None):
        """Streaming verb: a :class:`~repro_torch.stream.online.
        StreamingEstimator` bound to this plan (family, fixed coordinates,
        Newton budget, window, discount) with its pool on this session's
        device."""
        from ..stream.online import StreamingEstimator
        return StreamingEstimator(
            self.graph, include_singleton=self.plan.include_singleton,
            theta_fixed=self.theta_fixed,
            capacity=capacity or self.plan.capacity,
            n_iter=self.plan.n_iter, family=self.family,
            want_influence=self.want_influence,
            window=self.plan.stream_window,
            discount=self.plan.stream_discount, device=self.device,
            recorder=self.recorder)

    def simulate(self, pool, **overrides):
        """An event-driven :class:`~repro_torch.stream.simulator.
        StreamSimulator` configured from this plan on this session's device
        (see ``StreamSimulator.from_plan``), sharing this session's
        telemetry recorder; ``overrides`` win."""
        from ..stream.simulator import StreamSimulator
        overrides.setdefault("device", self.device)
        overrides.setdefault("telemetry", self.recorder)
        return StreamSimulator.from_plan(self.plan, pool, **overrides)

    def joint(self, X, sample_weight=None,
              use_kernel: bool = True) -> EstimateResult:
        """Joint verb: ADMM MPLE (Sec. 3.2) through the batched proximal
        engine, initialized at the plan's ``admm_init`` one-step consensus
        of local fits (``"zero"`` skips them). Every prox Newton iteration
        takes one Newton-kernel launch on the card; the score norm is one
        score-kernel launch. ``use_kernel=False`` asks for the plain
        versions."""
        rec = self.recorder
        mark = rec.mark()
        t0 = time.perf_counter()
        b0, s0 = LIBRARIES.builds, LIBRARIES.build_s
        plan = self.plan
        with rec.span("joint"):
            Xt = self._as_samples(X)
            n = int(Xt.shape[0])
            sw = (None if sample_weight is None
                  else _tensor(sample_weight).to(self.device))
            fits = None
            if plan.admm_init != "zero":
                fits = self.fit_local(Xt, sample_weight=sw,
                                      want_influence=False,
                                      use_kernel=use_kernel)
            res = admm_mple_family(
                self.graph, Xt, n_iters=plan.admm_iters,
                init=plan.admm_init, fits=fits,
                include_singleton=plan.include_singleton,
                theta_fixed=self.theta_fixed,
                newton_iters=plan.admm_newton_iters, family=self.family,
                sample_weight=sw, rho0=plan.admm_rho, use_kernel=use_kernel,
                recorder=rec)
            theta = res.trajectory[-1]
            score = self._score_norm(theta, Xt, n, use_kernel=use_kernel)
        # each round every node sends its local vector and gets theta_bar
        _, param = local_layout(self.graph, self.family,
                                plan.include_singleton)
        comm = plan.admm_iters * 2 * len(param)
        if rec.enabled:
            rec.gauge("comm.scalars_per_round", comm, scheme="admm")
        return EstimateResult(
            mode="joint", theta=theta, combined={"admm": theta}, fits=fits,
            n_samples=n, score_norm=score,
            wall_s=time.perf_counter() - t0,
            compile_s=LIBRARIES.build_s - s0,
            new_compiles=LIBRARIES.builds - b0,
            comm_scalars={"admm": comm},
            trajectory=res.trajectory, primal_residual=res.primal_residual,
            telemetry=rec.snapshot(mark) if rec.enabled else None)

    def select(self, X, spec=None, use_kernel: bool = True):
        """Structure verb: estimate the graph by distributed
        pseudo-likelihood lasso and support voting
        (:mod:`repro_torch.structure`).

        Screens a candidate edge set (``spec.policy``), fits the dense
        unpenalized model on it, walks a warm-started descending lambda path
        of group-lasso neighborhood selection by ADMM (every round's smooth
        half on the batched proximal engine: on the card, every prox Newton
        iteration is one Newton-kernel launch), picks lambda by EBIC on the
        support-masked dense estimates, and reconciles the two endpoints'
        verdicts per candidate edge through the spec's vote rule. ``spec``
        (a :class:`~repro_torch.structure.StructureSpec` or its dict)
        overrides ``plan.structure`` for this call; with neither, the spec's
        defaults apply. The plan's graph only sizes the problem (p nodes).
        ``use_kernel=False`` asks for the plain Newton statistics.
        ``path_compiles`` and ``new_compiles`` count the kernel-library
        builds paid during the path and during the call (0 once built).
        """
        from ..stream.costs import structure_vote_scalars
        from ..structure import (StructureResult, StructureSpec,
                                 auto_lambda_grid, candidate_graph,
                                 debias_to_support, ebic_scores,
                                 edge_supports, get_vote_rule, lasso_path,
                                 reconcile)
        from ..structure.solver import vote_masses
        if spec is None:
            spec = self.plan.structure or StructureSpec()
        elif isinstance(spec, dict):
            spec = StructureSpec.from_dict(spec)
        rule = get_vote_rule(spec.vote)
        rec = self.recorder
        mark = rec.mark()
        t0 = time.perf_counter()
        b0, s0 = LIBRARIES.builds, LIBRARIES.build_s
        family = self.family
        C = family.block_dim
        inc = self.plan.include_singleton
        with rec.span("select"):
            Xt = self._as_samples(X)
            n, p = Xt.shape
            if p != self.graph.p:
                raise ValueError(f"X has {p} columns; plan graph has "
                                 f"p={self.graph.p} nodes")
            # screening, the lambda grid and EBIC read X in float64 on the
            # device, as the reference reads it in float64 on the host
            Xd = Xt.to(torch.float64)
            with rec.span("screen", policy=spec.policy):
                gc = candidate_graph(spec, p, X=Xd, family=family)
            # the plan's fixed coordinates remapped onto the candidate
            # graph: node blocks carry over, candidate-edge blocks are free
            tf_c = np.zeros(family.n_params(gc))
            tf_c[: p * C] = self.theta_fixed[: p * C]
            tf_ct = torch.as_tensor(tf_c, device=self.device).to(Xt.dtype)

            lambdas = spec.lambdas or auto_lambda_grid(gc, Xd, family, spec)

            # the dense (unpenalized) fit on the candidate graph pins the
            # path's lambda == 0 end to the fit verb, supplies the weighted
            # vote's sandwich-variance masses (V is computed with or
            # without the influence stacks) and debiases the EBIC
            # likelihoods
            with rec.span("dense_fit"):
                fits_c = fit_all_local_batched(
                    gc, Xt, include_singleton=inc, theta_fixed=tf_ct,
                    n_iter=self.plan.n_iter, family=family,
                    want_influence=self.want_influence,
                    use_kernel=use_kernel, recorder=rec)
            dense_thetas = [np.asarray(f.theta, dtype=np.float64)
                            for f in fits_c]

            with rec.span("path", n_lambdas=len(lambdas)):
                bp = LIBRARIES.builds
                path = lasso_path(gc, Xt, lambdas, spec, family,
                                  include_singleton=inc, theta_fixed=tf_ct,
                                  dense_thetas=dense_thetas,
                                  use_kernel=use_kernel, recorder=rec)
                path_compiles = LIBRARIES.builds - bp
                ebic = ebic_scores(gc, Xd, path, family, spec, inc, tf_c,
                                   debias_thetas=dense_thetas)

            with rec.span("vote", rule=rule.name):
                mass = (vote_masses(gc, fits_c, family, inc)
                        if rule.needs_mass else np.ones((p, gc.m)))
                I = np.array([e[0] for e in gc.edges], dtype=np.int64)
                J = np.array([e[1] for e in gc.edges], dtype=np.int64)
                ar = np.arange(gc.m)
                keeps, margins_l, sizes = [], [], []
                for zs in path:
                    sup = edge_supports(gc, zs, family, inc)
                    keep, margin = reconcile(
                        sup[I, ar], sup[J, ar], rule,
                        mass_a=mass[I, ar], mass_b=mass[J, ar])
                    keeps.append(keep)
                    margins_l.append(margin)
                    sizes.append(int(keep.sum()))
                lsel = int(np.argmin(ebic))
                support = tuple(e for e, k in zip(gc.edges, keeps[lsel])
                                if k)
            comm = structure_vote_scalars(gc.m, rule.name)
            if rec.enabled:
                rec.gauge("structure.candidate_edges", gc.m)
                rec.gauge("structure.support_size", len(support))
                rec.gauge("comm.scalars_per_round", comm,
                          scheme=f"vote_{rule.name}")
        return StructureResult(
            support=support, graph=Graph(p, support),
            candidate_edges=gc.edges, vote_rule=rule.name,
            margins=margins_l[lsel], lambdas=tuple(lambdas),
            lambda_selected=float(lambdas[lsel]), ebic=ebic,
            support_sizes=tuple(sizes),
            thetas=debias_to_support(gc, path[lsel], dense_thetas, family,
                                     inc),
            n_samples=int(n), comm_scalars=comm,
            wall_s=time.perf_counter() - t0,
            compile_s=LIBRARIES.build_s - s0, path_compiles=path_compiles,
            new_compiles=LIBRARIES.builds - b0,
            telemetry=rec.snapshot(mark) if rec.enabled else None)

    def __repr__(self) -> str:
        return (f"EstimationSession(family={self.plan.family!r}, "
                f"p={self.graph.p}, m={self.graph.m}, "
                f"buckets={self.n_buckets}, "
                f"combiners={list(self.plan.combiners)}, "
                f"device={str(self.device)!r}, fit_calls={self.fit_calls})")
