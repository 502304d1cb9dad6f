"""Estimation-as-a-service: the multi-tenant session server, on a device.

Serve many concurrent tenants — each a frozen
:class:`~repro_torch.api.plan.Plan` plus an optional communication
:class:`BudgetSpec` — through the plan-keyed session cache, with
cross-tenant coalesced batching (one batched Newton solve per degree
bucket for a whole same-shape group: on the card, one Newton-kernel launch
per bucket per iteration; see :mod:`repro_torch.serve.coalesce`),
admission control billed in exact one-step message scalars
(:mod:`repro_torch.serve.admission`), and a deterministic load harness
(:mod:`repro_torch.serve.loadgen`).

    from repro_torch.serve import SessionServer, BudgetSpec

    srv = SessionServer(max_coalesce=8)     # device="cpu" for the CPU
    srv.register("acme", plan, budget=BudgetSpec(scalars=10_000,
                                                 replenish_every=60.0))
    ticket = srv.submit("acme", X)          # admission-controlled
    srv.drain()                             # coalesced dispatch
    ticket.result.theta                     # ~ serial session.fit(X)
"""
from .admission import (REJECT_BUDGET, REJECT_QUEUE_FULL, BudgetSpec,
                        BudgetState, VirtualClock)
from .coalesce import (coalesced_plan, pad_group_size, split_fits,
                       tenant_param_slots, union_graph)
from .loadgen import LoadReport, run_load, synthetic_workload
from .server import ServeResult, SessionServer, Tenant, Ticket

__all__ = [
    "SessionServer", "Tenant", "Ticket", "ServeResult",
    "BudgetSpec", "BudgetState", "VirtualClock",
    "REJECT_QUEUE_FULL", "REJECT_BUDGET",
    "union_graph", "coalesced_plan", "split_fits", "tenant_param_slots",
    "pad_group_size",
    "synthetic_workload", "run_load", "LoadReport",
]
