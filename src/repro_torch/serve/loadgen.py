"""Deterministic load-test harness for the session server.

The workload is built up-front and replayed: :func:`synthetic_workload`
pre-draws every request's sample rows from each tenant family's sampler
with ``torch.Generator`` seeds derived from ``(seed, round, tenant)`` (see
:func:`fold_seed`), so two runs (or two server configurations — coalescing
ON vs OFF) see identical request streams in the same order. :func:`run_load`
submits round by round, drains between rounds, optionally advances a
:class:`~repro_torch.serve.admission.VirtualClock`, and folds the tickets
into a :class:`LoadReport` — p50/p99 latency, throughput, admission
outcomes, coalesce sizes, and the kernel-library builds the run paid.

Determinism covers everything *decision-shaped*: which requests are
admitted or rejected (and why), how groups coalesce, and the request rows
on one device. Wall-clock latencies obviously vary by machine — they are
the measurement, not the schedule.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.plan import Plan
from ..device import resolve_device
from ..kernels.build import LIBRARIES
from .admission import VirtualClock
from .server import SessionServer, Ticket

__all__ = ["LoadReport", "synthetic_workload", "run_load"]

#: one request: (tenant_id, sample rows on the workload's device, kind)
Request = Tuple[str, torch.Tensor, str]


@dataclasses.dataclass
class LoadReport:
    """Aggregate of one load run; latencies in seconds."""

    n_submitted: int
    n_served: int
    n_rejected: int
    rejected_by_reason: Dict[str, int]
    latencies_s: np.ndarray
    wall_s: float
    coalesce_sizes: List[int]
    new_compiles: int
    tickets: List[Ticket]

    @property
    def throughput_rps(self) -> float:
        return self.n_served / self.wall_s if self.wall_s > 0 else 0.0

    def latency_ms(self, q: float) -> float:
        """The q-th latency percentile in milliseconds (e.g. 50, 99)."""
        if self.latencies_s.size == 0:
            return float("nan")
        return float(np.percentile(self.latencies_s, q) * 1e3)

    def summary(self) -> dict:
        return {
            "n_submitted": self.n_submitted,
            "n_served": self.n_served,
            "n_rejected": self.n_rejected,
            "rejected_by_reason": dict(self.rejected_by_reason),
            "p50_ms": self.latency_ms(50),
            "p99_ms": self.latency_ms(99),
            "throughput_rps": self.throughput_rps,
            "wall_s": self.wall_s,
            "mean_coalesce_size": (float(np.mean(self.coalesce_sizes))
                                   if self.coalesce_sizes else 0.0),
            "new_compiles": self.new_compiles,
        }


#: largest graph the exact (full state enumeration) sampler is used for;
#: beyond it the workload draws via chromatic Gibbs instead
_EXACT_SAMPLE_MAX_P = 12


def fold_seed(seed: int, *path: int) -> int:
    """A ``torch.Generator`` seed from ``seed`` and a path of integers: the
    first 8 bytes of the SHA-256 of their decimal strings joined by ``/``,
    as a non-negative 63-bit integer. A pure function: the workload's
    parameters take the path ``(1000 + j,)`` and the rows of round ``rnd``
    the path ``(rnd, j)``, where ``j`` is the tenant's index in sorted
    tenant-id order."""
    text = "/".join(str(int(v)) for v in (seed,) + path)
    digest = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _draw_rows(plan: Plan, theta: torch.Tensor, n: int,
               gen: torch.Generator) -> torch.Tensor:
    """n rows at ``theta``: exact draws up to ``_EXACT_SAMPLE_MAX_P``
    nodes, else one row from each of n chromatic-Gibbs chains run side by
    side past the sampler's burn-in (the chains are a batch dimension, so
    n chains cost the sweeps of one: burn-in + 1, where 8 chains thinned
    by 5 would take burn-in + 5 n / 8)."""
    fam = plan.family_instance
    if plan.graph.p <= _EXACT_SAMPLE_MAX_P:
        return fam.exact_sample(plan.graph, theta, n, gen)
    from ..core.sampling import gibbs_sample_family
    return gibbs_sample_family(fam, plan.graph, theta, n, gen, n_chains=n)


def synthetic_workload(tenant_plans: Dict[str, Plan], rounds: int,
                       n_rows: int, seed: int = 0,
                       kind: str = "fit",
                       theta: Optional[dict] = None,
                       device=None) -> List[List[Request]]:
    """Pre-drawn multi-tenant request schedule: every round, every tenant
    submits one ``kind`` request of ``n_rows`` fresh rows sampled from its
    plan's family at parameters ``theta[tenant]`` (default: the family's
    seeded ``random_params``), drawn on ``device`` (the CUDA card when
    None) by generators seeded through :func:`fold_seed` — the schedule is
    a pure function of its arguments. Small graphs draw from the exact
    distribution; past ``p = 12`` (where state enumeration explodes) the
    draw switches to seeded chromatic Gibbs."""
    dev = resolve_device(device)
    order = sorted(tenant_plans.items())
    thetas = {}
    for j, (tid, plan) in enumerate(order):
        if theta is not None and tid in theta:
            thetas[tid] = torch.as_tensor(
                np.asarray(theta[tid], dtype=np.float64), device=dev)
        else:
            thetas[tid] = plan.family_instance.random_params(
                plan.graph, _generator(fold_seed(seed, 1000 + j), dev),
                device=dev)
    schedule: List[List[Request]] = []
    for rnd in range(rounds):
        requests: List[Request] = []
        for j, (tid, plan) in enumerate(order):
            gen = _generator(fold_seed(seed, rnd, j), dev)
            requests.append((tid, _draw_rows(plan, thetas[tid], n_rows, gen),
                             kind))
        schedule.append(requests)
    return schedule


def run_load(server: SessionServer, schedule: Sequence[Sequence[Request]],
             *, round_dt: Optional[float] = None) -> LoadReport:
    """Replay a workload: submit each round's requests, drain the server,
    advance a :class:`VirtualClock` by ``round_dt`` between rounds (only
    when the server runs on one), and fold the tickets into a
    :class:`LoadReport`. ``new_compiles`` counts the kernel-library builds
    over the whole run — a warm run (and any run on the CPU) reports 0."""
    tickets: List[Ticket] = []
    b0 = LIBRARIES.builds
    t0 = time.perf_counter()
    for requests in schedule:
        for (tid, X, kind) in requests:
            tickets.append(server.submit(tid, X, kind=kind))
        server.drain()
        if round_dt is not None and isinstance(server.clock, VirtualClock):
            server.clock.advance(round_dt)
    wall = time.perf_counter() - t0
    done = [t for t in tickets if t.done]
    rejected = [t for t in tickets if not t.admitted]
    by_reason: Dict[str, int] = {}
    for t in rejected:
        by_reason[t.reject_reason] = by_reason.get(t.reject_reason, 0) + 1
    return LoadReport(
        n_submitted=len(tickets),
        n_served=len(done),
        n_rejected=len(rejected),
        rejected_by_reason=by_reason,
        latencies_s=np.asarray([t.latency_s for t in done],
                               dtype=np.float64),
        wall_s=wall,
        coalesce_sizes=[t.result.coalesce_size for t in done],
        new_compiles=LIBRARIES.builds - b0,
        tickets=tickets)
