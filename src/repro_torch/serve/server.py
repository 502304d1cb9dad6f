"""Multi-tenant estimation session server with coalesced batching.

The serving tier over the plan-keyed session cache (:mod:`repro_torch.api`):
a :class:`SessionServer` accepts many concurrent *tenants* — each a frozen
:class:`~repro_torch.api.plan.Plan` plus an admission
:class:`~repro_torch.serve.admission.BudgetSpec` — and routes their ``fit``
/ ``stream`` requests through the cached
:class:`~repro_torch.api.session.EstimationSession` machinery on the
server's device (the CUDA card unless the caller names another). Equal
plans share ONE session.

**Coalesced batching.** Queued same-shape requests of equal plans are
merged into a single batched-engine dispatch: the group becomes a
block-diagonal union problem (:mod:`repro_torch.serve.coalesce`) — r
tenant graphs as one disjoint-union graph, r sample matrices
column-stacked on the device — solved by ONE batched Newton solve per
degree bucket: on the card, one Newton-kernel launch per bucket per Newton
iteration for the whole group (the weighted kernel for stream groups),
instead of one launch chain per request. Group sizes are padded to a
bounded set of power-of-two shapes, and results are split back per tenant.

**Admission control.** ``submit`` is where requests are accepted or
rejected, never dropped later: a bounded queue applies backpressure
(reject reason ``"queue_full"``) and per-tenant communication budgets —
billed with the exact combiner-registry scalar accounting of
:mod:`repro_torch.stream.costs` — reject with ``"budget_exhausted"`` until
the configured replenishment schedule refills the ledger. Every decision
lands in the server's telemetry registry (``serve.admitted`` /
``serve.rejected`` counters tagged by tenant and reason, queue-depth
gauges, latency histograms, coalesce-size observations).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..api.plan import Plan
from ..api.session import EstimationSession
from ..core.estimators import LocalFit
from ..device import resolve_device
from ..kernels.build import LIBRARIES
from ..stream.costs import plan_request_scalars
from ..telemetry.recorder import make_recorder
from ..telemetry.spec import TelemetrySpec
from .admission import (REJECT_BUDGET, REJECT_QUEUE_FULL, BudgetSpec,
                        BudgetState)
from .coalesce import (as_device_tensor, coalesced_plan, pad_group_size,
                       split_fits, stack_columns)

__all__ = ["SessionServer", "ServeResult", "Ticket", "Tenant"]

#: request kinds a tenant may submit
KINDS = ("fit", "stream")


@dataclasses.dataclass
class ServeResult:
    """One served request's payload.

    theta/combined/fits mirror :class:`~repro_torch.api.result.
    EstimateResult` (the headline estimate is the plan's first combiner);
    the serving extras record how the request was executed: the true
    coalesce group size it rode in (1 = serial), the kernel-library builds
    its dispatch paid (shared across the group; 0 once built and on the
    CPU), and the comm scalars its admission charge billed.
    """

    tenant_id: str
    kind: str
    theta: np.ndarray
    combined: Dict[str, np.ndarray]
    fits: List[LocalFit]
    n_samples: int
    coalesce_size: int
    new_compiles: int
    comm_scalars: int


@dataclasses.dataclass
class Ticket:
    """Handle returned by :meth:`SessionServer.submit`.

    status moves ``queued -> done`` for admitted requests; a rejected
    request is born ``rejected`` with ``reject_reason`` set (one of the
    :mod:`repro_torch.serve.admission` reason constants) and is never
    queued. An *accepted* ticket is never dropped: every queued request is
    served by a subsequent :meth:`SessionServer.pump` / :meth:`drain`.
    """

    tenant_id: str
    kind: str
    seq: int
    status: str = "queued"
    result: Optional[ServeResult] = None
    reject_reason: Optional[str] = None
    submitted_wall: float = 0.0
    latency_s: Optional[float] = None
    #: scalars the admission charge billed (the plan's exact one-step
    #: message cost for this request's rows)
    comm_cost: int = 0
    #: request payload, a tensor on the server's device; cleared once
    #: served (or ingested, for a stream request)
    _X: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    @property
    def admitted(self) -> bool:
        return self.status != "rejected"

    @property
    def done(self) -> bool:
        return self.status == "done"


class Tenant:
    """Server-side tenant state: plan, shared session, budget ledger,
    lazily-created plan-bound streaming estimator."""

    def __init__(self, tenant_id: str, plan: Plan,
                 budget: Optional[BudgetSpec], now: float,
                 device=None) -> None:
        self.tenant_id = tenant_id
        self.plan = plan
        self.session: EstimationSession = plan.session(device=device)
        self.budget = None if budget is None else BudgetState(budget, now)
        self._stream = None
        self.served = 0
        self.rejected = 0

    @property
    def stream(self):
        """The tenant's plan-bound StreamingEstimator, its pool on the
        session's device (created on first stream request; persists across
        rounds — that is the stream)."""
        if self._stream is None:
            self._stream = self.session.stream()
        return self._stream


class SessionServer:
    """See module docstring.

    Parameters
    ----------
    max_queue    — queue-depth bound; ``submit`` beyond it rejects with
                   ``"queue_full"`` (graceful backpressure — nothing
                   already accepted is affected).
    max_coalesce — largest coalesced group (power-of-two padded).
    coalesce     — False serves every request through its own session
                   serially (the bench's baseline mode).
    telemetry    — server-level :class:`TelemetrySpec` (default: live
                   in-memory recorder, so admission counters are always
                   inspectable); pass ``None`` for the null recorder.
    clock        — callable returning logical seconds for budget
                   replenishment; inject a
                   :class:`~repro_torch.serve.admission.VirtualClock` for
                   deterministic schedules (default ``time.monotonic``).
    device       — where every tenant session, stream pool and union
                   solve runs: the CUDA card when None (with no card and
                   no device given, the server refuses to start).
    """

    def __init__(self, *, max_queue: int = 256, max_coalesce: int = 8,
                 coalesce: bool = True,
                 telemetry: Optional[TelemetrySpec] = TelemetrySpec(),
                 clock=None, device=None) -> None:
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue!r}")
        if max_coalesce < 1:
            raise ValueError(
                f"max_coalesce must be >= 1, got {max_coalesce!r}")
        self.device = resolve_device(device)
        self.max_queue = int(max_queue)
        self.max_coalesce = int(max_coalesce) if coalesce else 1
        self.coalesce = bool(coalesce)
        self.recorder = make_recorder(telemetry)
        self.clock = clock if clock is not None else time.monotonic
        self._tenants: Dict[str, Tenant] = {}
        self._queue: Deque[Ticket] = collections.deque()
        self._seq = 0

    # ------------------------------------------------------------- tenants
    def register(self, tenant_id: str, plan: Plan,
                 budget: Optional[BudgetSpec] = None) -> Tenant:
        """Admit a tenant: bind its (frozen) plan to the shared session
        cache on the server's device and open its budget ledger at the
        current clock."""
        if tenant_id in self._tenants:
            raise ValueError(f"tenant {tenant_id!r} is already registered")
        if not isinstance(plan, Plan):
            raise TypeError(f"tenant plan must be a repro_torch.api.Plan, "
                            f"got {type(plan).__name__}")
        if budget is not None and not isinstance(budget, BudgetSpec):
            raise TypeError(f"budget must be a BudgetSpec or None, got "
                            f"{type(budget).__name__}")
        if plan.faults is not None:
            raise ValueError(
                f"tenant {tenant_id!r}'s plan carries a FaultPlan; the "
                f"server never injects plan-level faults (coalesced "
                f"dispatches strip them, so injection would depend on "
                f"which requests happened to group) — register "
                f"plan.replace(faults=None) and drive fault scenarios "
                f"through repro_torch.stream.simulator instead")
        t = Tenant(tenant_id, plan, budget, float(self.clock()),
                   device=self.device)
        self._tenants[tenant_id] = t
        if self.recorder.enabled:
            self.recorder.inc("serve.tenants_registered", tenant=tenant_id)
        return t

    def tenant(self, tenant_id: str) -> Tenant:
        try:
            return self._tenants[tenant_id]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant_id!r}; register(tenant_id, plan) "
                f"first (registered: {sorted(self._tenants)})") from None

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def request_cost(self, tenant_id: str, n: int) -> int:
        """Scalars a request with ``n`` sample rows is billed — the exact
        one-step accounting of the tenant's plan (summed over its
        distributable combiners)."""
        t = self.tenant(tenant_id)
        return plan_request_scalars(
            t.plan.graph, t.plan.combiners, n,
            include_singleton=t.plan.include_singleton,
            family=t.session.family)

    def metrics(self):
        """Snapshot of the server's telemetry registry (None when the
        server was built with ``telemetry=None``)."""
        return self.recorder.snapshot()

    # ------------------------------------------------------------ admission
    def submit(self, tenant_id: str, X, kind: str = "fit") -> Ticket:
        """Admission-controlled enqueue of one request (an (n, p) tensor or
        array); see class docs. An admitted request's rows move to the
        server's device, in their own type."""
        t = self.tenant(tenant_id)
        if kind not in KINDS:
            raise ValueError(f"unknown request kind {kind!r}; choose from "
                             f"{KINDS}")
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X)
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[1] != t.plan.graph.p:
            raise ValueError(
                f"request samples must be (n, p={t.plan.graph.p}) for "
                f"tenant {tenant_id!r}'s graph, got shape "
                f"{tuple(X.shape)}")
        if X.shape[0] < 1:
            raise ValueError("request carries no sample rows")
        self._seq += 1
        ticket = Ticket(tenant_id=tenant_id, kind=kind, seq=self._seq,
                        submitted_wall=time.perf_counter())
        ticket.comm_cost = self.request_cost(tenant_id, int(X.shape[0]))
        if len(self._queue) >= self.max_queue:
            return self._reject(t, ticket, REJECT_QUEUE_FULL)
        if t.budget is not None and not t.budget.try_charge(
                ticket.comm_cost, float(self.clock())):
            return self._reject(t, ticket, REJECT_BUDGET)
        ticket._X = as_device_tensor(X, self.device)
        self._queue.append(ticket)
        if self.recorder.enabled:
            self.recorder.inc("serve.admitted", tenant=tenant_id, kind=kind)
            self.recorder.gauge("serve.queue_depth", len(self._queue))
        return ticket

    def _reject(self, t: Tenant, ticket: Ticket, reason: str) -> Ticket:
        ticket.status = "rejected"
        ticket.reject_reason = reason
        ticket._X = None
        t.rejected += 1
        if self.recorder.enabled:
            self.recorder.inc("serve.rejected", tenant=t.tenant_id,
                              reason=reason, kind=ticket.kind)
        return ticket

    # ------------------------------------------------------------- serving
    def pump(self) -> List[Ticket]:
        """Serve ONE coalesced group from the queue head (FIFO; one
        request per tenant per group so streaming rounds stay ordered).
        Returns the tickets served; [] when the queue is empty."""
        group = self._next_group()
        if not group:
            return []
        rec = self.recorder
        if rec.enabled:
            with rec.span("serve_dispatch", kind=group[0].kind,
                          group=len(group)):
                self._dispatch(group)
        else:
            self._dispatch(group)
        if rec.enabled:
            rec.gauge("serve.queue_depth", len(self._queue))
        return group

    def drain(self) -> List[Ticket]:
        """Pump until the queue is empty; every accepted request is served
        (backpressure rejects at admission, never drops afterwards)."""
        served: List[Ticket] = []
        while True:
            batch = self.pump()
            if not batch:
                return served
            served.extend(batch)

    # -------------------------------------------------------- group forming
    def _group_key(self, ticket: Ticket):
        t = self._tenants[ticket.tenant_id]
        if ticket.kind == "fit":
            return (t.plan, "fit", tuple(ticket._X.shape))
        # stream rounds coalesce on the post-ingest padded pool shape
        # (ingestion happens exactly once, when the request is first
        # considered), read from the pool tensor on the device without a
        # host copy, plus the warm-start flag: a tenant's very first round
        # solves cold while warmed tenants solve guarded, so the two never
        # share a dispatch
        est = t.stream
        return (t.plan, "stream", tuple(est.buffer.tensor.shape),
                est._warm is not None)

    def _next_group(self) -> List[Ticket]:
        if not self._queue:
            return []
        head = self._queue[0]
        self._ingest_if_needed(head)
        key = self._group_key(head)
        group = [head]
        # Every tenant encountered in the scan is marked seen — grouped or
        # not — so at most the FIRST queued request per tenant is ever
        # considered (or stream-ingested) per pump. A candidate that fails
        # the kind/plan/key checks still blocks that tenant's later
        # requests; otherwise a later round could be ingested (or even
        # dispatched) ahead of an earlier one, breaking per-tenant FIFO
        # order and the coalesced == serial guarantee.
        seen = {head.tenant_id}
        if self.max_coalesce > 1:
            for ticket in list(self._queue)[1:]:
                if len(group) >= self.max_coalesce:
                    break
                if ticket.tenant_id in seen:
                    continue
                seen.add(ticket.tenant_id)
                if ticket.kind != head.kind:
                    continue
                if (self._tenants[ticket.tenant_id].plan
                        != self._tenants[head.tenant_id].plan):
                    continue
                self._ingest_if_needed(ticket)
                if self._group_key(ticket) != key:
                    continue
                group.append(ticket)
        for ticket in group:
            self._queue.remove(ticket)
        return group

    def _ingest_if_needed(self, ticket: Ticket) -> None:
        """A stream request's rows enter the tenant's pool exactly once,
        at first consideration — the pool's (possibly doubled) padded
        shape is then this round's coalesce key."""
        if ticket.kind != "stream" or ticket._X is None:
            return
        est = self._tenants[ticket.tenant_id].stream
        est.ingest(ticket._X)
        ticket._X = None

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, group: List[Ticket]) -> None:
        head = self._tenants[group[0].tenant_id]
        plan, session = head.plan, head.session
        r = len(group)
        r_pad = pad_group_size(r, self.max_coalesce)
        usession = coalesced_plan(plan, r_pad).session(device=self.device)
        b0 = LIBRARIES.builds
        if group[0].kind == "fit":
            # fit groups key on the request X shape, so one n fits all
            n_fit = int(group[0]._X.shape[0])
            X_union = stack_columns([t._X for t in group], r_pad,
                                    device=self.device)
            union_fits = usession.fit_local(
                X_union, want_influence=session.want_influence)
        else:
            ests = [self._tenants[t.tenant_id].stream for t in group]
            pads = ests + [ests[-1]] * (r_pad - r)
            X_union = stack_columns([e.buffer.tensor for e in pads], r_pad,
                                    device=self.device)
            sw = torch.cat(
                [e.buffer.window_weights(e.counts, e.window, e.discount)
                 for e in pads], 0)
            warm = None
            if any(e._warm is not None for e in ests):
                warm = []
                for e in pads:
                    warm.extend(e._warm if e._warm is not None
                                else [None] * e.graph.p)
            union_fits = usession.fit_local(
                X_union, sample_weight=sw, warm_start=warm,
                want_influence=session.want_influence)
        new_compiles = LIBRARIES.builds - b0
        per_tenant = split_fits(union_fits, plan.graph, session.family,
                                plan.include_singleton, r)
        now_wall = time.perf_counter()
        for ticket, fits in zip(group, per_tenant):
            tenant = self._tenants[ticket.tenant_id]
            if ticket.kind == "stream":
                tenant.stream._finish_refit(fits)
                # stream groups key on the padded pool shape, so group
                # members may carry different ingested totals — report
                # each tenant's own pool count
                n_served = int(tenant.stream.buffer.n)
            else:
                n_served = n_fit
            combined = {
                c.name: c.combine(plan.graph, fits,
                                  include_singleton=plan.include_singleton,
                                  theta_fixed=session.theta_fixed,
                                  family=session.family)
                for c in session.combiners}
            ticket.result = ServeResult(
                tenant_id=ticket.tenant_id, kind=ticket.kind,
                theta=combined[plan.combiners[0]], combined=combined,
                fits=fits, n_samples=n_served, coalesce_size=r,
                new_compiles=new_compiles, comm_scalars=ticket.comm_cost)
            ticket.status = "done"
            ticket.latency_s = now_wall - ticket.submitted_wall
            ticket._X = None
            tenant.served += 1
            if self.recorder.enabled:
                self.recorder.inc("serve.served", tenant=ticket.tenant_id,
                                  kind=ticket.kind)
                self.recorder.observe("serve.latency_s", ticket.latency_s,
                                      tenant=ticket.tenant_id)
        if self.recorder.enabled:
            self.recorder.observe("serve.coalesce_size", r)
            self.recorder.inc("serve.dispatches")
            if new_compiles > 0:
                self.recorder.inc("serve.new_compiles", new_compiles)
