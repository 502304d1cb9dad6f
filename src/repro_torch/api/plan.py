"""The declarative estimation plan.

A :class:`Plan` is the complete, frozen, hashable description of one
distributed-estimation problem: the graph, the model family, the requested
combination schemes, solver options and precision. It keys the session
cache, and ``to_dict`` / ``from_dict`` use the reference package's schema
exactly, so one plan dict drives both packages.

Families and combiners are referenced by registry name. The streaming and
joint options (capacity, window, discount, ADMM budgets) and a
:class:`~repro_torch.stream.faults.FaultPlan` configure the ``stream``,
``simulate`` and ``joint`` verbs, a
:class:`~repro_torch.structure.StructureSpec` the ``select`` verb, and a
:class:`~repro_torch.telemetry.TelemetrySpec` turns on the instrumentation
of every verb. The mesh option is carried in the schema but belongs to a
later slice of the port: a plan that sets ``mesh`` raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..core.combiners import get_combiner
from ..core.families import get_family
from ..core.graphs import Graph
from ..stream.faults import FaultPlan
from ..structure.spec import StructureSpec
from ..telemetry.spec import TelemetrySpec

#: mesh policies of the schema; only None runs in this slice
MESH_POLICIES = (None, "host", "data")

_PRECISIONS = ("float32", "float64", "bfloat16")
_ADMM_INITS = ("zero", "uniform", "diagonal")

#: options carried in the schema whose verbs come in later slices
_LATER = {"mesh": "the multi-GPU slice"}


@dataclasses.dataclass(frozen=True)
class Plan:
    """Declarative description of one estimation problem.

    graph : the conditional-independence graph == the sensor network.
    family : registry name of the model family ("ising", "gaussian",
        "potts").
    combiners : registry names of the one-step combination schemes, in
        priority order; the first is the headline ``EstimateResult.theta``.
    include_singleton : estimate singleton blocks (False fixes them at
        ``theta_fixed``).
    theta_fixed : fixed coordinates as a tuple of floats; None means zeros.
    n_iter : damped-Newton budget per local solve.
    precision : type the sample matrix is cast to before solves
        ("float32", "float64", or "bfloat16": bf16 designs with float32
        solver state).
    capacity, admm_*, stream_window, stream_discount : configuration of the
        streaming and joint verbs; validated as in the reference.
    faults : optional :class:`~repro_torch.stream.faults.FaultPlan` (or its
        ``to_dict`` form) for ``simulate``.
    structure : optional :class:`~repro_torch.structure.StructureSpec` (or
        its ``to_dict`` form) configuring ``select``.
    telemetry : optional :class:`~repro_torch.telemetry.TelemetrySpec` (or
        its ``to_dict`` form): spans, metrics and a JSONL event log for
        every verb of this plan's session and for simulators built from
        it. None keeps the allocation-free ``NULL_RECORDER`` on every hot
        path.
    mesh : must be None in this slice.
    """

    graph: Graph
    family: str = "ising"
    combiners: Tuple[str, ...] = ("diagonal",)
    include_singleton: bool = True
    theta_fixed: Optional[Tuple[float, ...]] = None
    n_iter: int = 40
    mesh: Optional[str] = None
    precision: str = "float32"
    capacity: int = 64
    admm_iters: int = 30
    admm_init: str = "diagonal"
    admm_newton_iters: int = 15
    admm_rho: float = 1.0
    faults: Optional["FaultPlan"] = None
    stream_window: Optional[int] = None
    stream_discount: Optional[float] = None
    telemetry: Optional[TelemetrySpec] = None
    structure: Optional[StructureSpec] = None

    def __post_init__(self):
        if not isinstance(self.graph, Graph):
            raise TypeError(f"plan.graph must be a Graph, got "
                            f"{type(self.graph).__name__}")
        get_family(self.family)                      # raises listing names
        if isinstance(self.combiners, str):
            object.__setattr__(self, "combiners", (self.combiners,))
        else:
            object.__setattr__(self, "combiners", tuple(self.combiners))
        if not self.combiners:
            raise ValueError("plan needs at least one combiner")
        for name in self.combiners:
            get_combiner(name)                       # raises listing names
        if self.theta_fixed is not None:
            tf = tuple(float(v) for v in self.theta_fixed)
            expect = get_family(self.family).n_params(self.graph)
            if len(tf) != expect:
                raise ValueError(
                    f"theta_fixed has {len(tf)} entries; family "
                    f"{self.family!r} on this graph has {expect} params")
            object.__setattr__(self, "theta_fixed", tf)
        if self.mesh not in MESH_POLICIES:
            raise ValueError(f"unknown mesh policy {self.mesh!r}; "
                             f"choose from {MESH_POLICIES}")
        if self.precision not in _PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}; "
                             f"choose from {_PRECISIONS}")
        if self.admm_init not in _ADMM_INITS:
            raise ValueError(f"unknown admm_init {self.admm_init!r}; "
                             f"choose from {_ADMM_INITS}")
        if self.n_iter < 1 or self.admm_iters < 1 \
                or self.admm_newton_iters < 1:
            raise ValueError("iteration budgets must be >= 1")
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not (self.admm_rho > 0.0 and np.isfinite(self.admm_rho)):
            raise ValueError(
                f"admm_rho must be a finite positive penalty, got "
                f"{self.admm_rho!r}")
        if self.stream_window is not None and int(self.stream_window) < 1:
            raise ValueError(f"stream_window must be >= 1 sample (None "
                             f"disables it), got {self.stream_window!r}")
        if self.stream_discount is not None and not (
                0.0 < float(self.stream_discount) <= 1.0):
            raise ValueError(
                f"stream_discount must be in (0.0, 1.0] (None disables "
                f"forgetting), got {self.stream_discount!r}")
        if self.faults is not None:
            if isinstance(self.faults, dict):
                object.__setattr__(self, "faults",
                                   FaultPlan.from_dict(self.faults))
            elif not isinstance(self.faults, FaultPlan):
                raise TypeError(
                    f"plan.faults must be a FaultPlan (or its to_dict "
                    f"form), got {type(self.faults).__name__}")
        if self.telemetry is not None:
            if isinstance(self.telemetry, dict):
                object.__setattr__(self, "telemetry",
                                   TelemetrySpec.from_dict(self.telemetry))
            elif not isinstance(self.telemetry, TelemetrySpec):
                raise TypeError(
                    f"plan.telemetry must be a TelemetrySpec (or its "
                    f"to_dict form), got {type(self.telemetry).__name__}")
        if self.structure is not None:
            if isinstance(self.structure, dict):
                object.__setattr__(self, "structure",
                                   StructureSpec.from_dict(self.structure))
            elif not isinstance(self.structure, StructureSpec):
                raise TypeError(
                    f"plan.structure must be a StructureSpec (or its "
                    f"to_dict form), got {type(self.structure).__name__}")
            s = self.structure
            # the one check the spec cannot run alone: k against this
            # plan's node count
            if s.policy == "knn" and s.knn_k >= self.graph.p:
                raise ValueError(
                    f"structure.knn_k must be < p (a node has at most "
                    f"p-1 = {self.graph.p - 1} neighbors); got "
                    f"knn_k={s.knn_k} with p={self.graph.p} — use policy "
                    f"'full' to consider every pair")
            if s.policy == "given":
                for (a, b) in s.given_edges:
                    if not (0 <= a < b < self.graph.p):
                        raise ValueError(
                            f"structure.given_edges entry ({a},{b}) is not "
                            f"a valid i<j edge for p={self.graph.p}")
        for name, where in _LATER.items():
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"plan.{name} is not ported yet: it comes with {where}"
                    f" of the PyTorch port; it must be None here")

    @property
    def family_instance(self):
        """The registered :class:`ModelFamily` this plan names."""
        return get_family(self.family)

    @property
    def combiner_instances(self):
        """The registered :class:`Combiner` strategies, in plan order."""
        return tuple(get_combiner(n) for n in self.combiners)

    def replace(self, **changes) -> "Plan":
        """A new plan with ``changes`` applied (frozen-dataclass replace)."""
        return dataclasses.replace(self, **changes)

    def session(self, device=None):
        """The cached :class:`EstimationSession` of this plan on ``device``
        (the CUDA card when None)."""
        from .session import EstimationSession
        return EstimationSession.for_plan(self, device=device)

    def to_dict(self) -> dict:
        """Plain-JSON representation; exact inverse of :meth:`from_dict`,
        in the reference package's schema."""
        return {
            "graph": {"p": self.graph.p,
                      "edges": [list(e) for e in self.graph.edges]},
            "family": self.family,
            "combiners": list(self.combiners),
            "include_singleton": self.include_singleton,
            "theta_fixed": (None if self.theta_fixed is None
                            else list(self.theta_fixed)),
            "n_iter": self.n_iter,
            "mesh": self.mesh,
            "precision": self.precision,
            "capacity": self.capacity,
            "admm_iters": self.admm_iters,
            "admm_init": self.admm_init,
            "admm_newton_iters": self.admm_newton_iters,
            "admm_rho": self.admm_rho,
            "faults": (None if self.faults is None
                       else self.faults.to_dict()),
            "stream_window": self.stream_window,
            "stream_discount": self.stream_discount,
            "telemetry": (None if self.telemetry is None
                          else self.telemetry.to_dict()),
            "structure": (None if self.structure is None
                          else self.structure.to_dict()),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        g = d["graph"]
        graph = Graph(int(g["p"]),
                      tuple((int(a), int(b)) for a, b in g["edges"]))
        tf = d.get("theta_fixed")
        return cls(
            graph=graph,
            family=d.get("family", "ising"),
            combiners=tuple(d.get("combiners", ("diagonal",))),
            include_singleton=bool(d.get("include_singleton", True)),
            theta_fixed=None if tf is None else tuple(float(v) for v in tf),
            n_iter=int(d.get("n_iter", 40)),
            mesh=d.get("mesh"),
            precision=d.get("precision", "float32"),
            capacity=int(d.get("capacity", 64)),
            admm_iters=int(d.get("admm_iters", 30)),
            admm_init=d.get("admm_init", "diagonal"),
            admm_newton_iters=int(d.get("admm_newton_iters", 15)),
            admm_rho=float(d.get("admm_rho", 1.0)),
            faults=d.get("faults"),
            stream_window=(None if d.get("stream_window") is None
                           else int(d["stream_window"])),
            stream_discount=(None if d.get("stream_discount") is None
                             else float(d["stream_discount"])),
            telemetry=d.get("telemetry"),
            structure=d.get("structure"),
        )
