"""Cross-tenant request coalescing: block-diagonal union problems.

Coalescing exploits that every per-node local CL fit is *independent*
given its own samples (paper Eq. 3): r same-plan requests are exactly the
local fits of ONE estimation problem on the disjoint union of r copies of
the tenant graph, with the r sample matrices stacked along the column
(node) axis. The union graph has the same distinct (padded) degrees as a
single copy, so each degree bucket of the union is one batched Newton
solve over the nodes of every coalesced request: on the card, one
Newton-kernel launch per bucket per Newton iteration for the whole group,
instead of one launch chain per request.

Copy-t edges occupy positions ``[t*m, (t+1)*m)`` of the union edge list in
tenant order, so ``incident_edges`` of a copied node returns its tenant's
edges in the tenant's order and per-node designs gather the same columns.
:func:`split_fits` then only relabels node ids and beta indices back to
tenant-local coordinates — the numerical payloads
(``theta``/``H``/``J``/``V``/``s``) pass through untouched. The solve stops
on the bucket-wide step, so a coalesced node may take a few more Newton
iterations than in its tenant's own solve, and on the card the Newton
kernel's sample split depends on the bucket's node count: coalesced equals
serial to the solver's tolerance, not bit for bit.

Group sizes are padded to powers of two (phantom slots repeat a real
member, results discarded) so a server under fluctuating load re-uses a
small, bounded set of union shapes (and cached union sessions) instead of
minting one per queue depth.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from ..api.plan import Plan
from ..core.estimators import LocalFit
from ..core.families import get_family
from ..core.graphs import Graph
from ..device import resolve_device

__all__ = ["union_graph", "tenant_param_slots", "coalesced_plan",
           "split_fits", "pad_group_size", "stack_columns"]


@functools.lru_cache(maxsize=256)
def union_graph(graph: Graph, r: int) -> Graph:
    """Disjoint union of ``r`` copies of ``graph`` (``r = 1`` is identity).

    Copy ``t`` owns nodes ``[t*p, (t+1)*p)`` and its edges sit at positions
    ``[t*m, (t+1)*m)`` of the union edge list, preserving the tenant's
    edge order — the property :func:`split_fits` relies on.
    """
    if r < 1:
        raise ValueError(f"need at least one copy, got r={r}")
    if r == 1:
        return graph
    p = graph.p
    edges = tuple((t * p + a, t * p + b)
                  for t in range(r) for (a, b) in graph.edges)
    return Graph(r * p, edges)


@functools.lru_cache(maxsize=256)
def tenant_param_slots(family_name: str, graph: Graph, r: int) -> np.ndarray:
    """(r, n_params) union flat-parameter indices of each tenant slot.

    Row ``t`` maps tenant-local flat parameters (family block layout:
    ``p`` node blocks then ``m`` edge blocks of size C) to their indices
    in the union problem's flat vector.
    """
    fam = get_family(family_name)
    C = fam.block_dim
    p, m = graph.p, graph.m
    c = np.arange(C, dtype=np.int64)
    slots = np.empty((r, (p + m) * C), dtype=np.int64)
    for t in range(r):
        node_part = ((t * p + np.arange(p, dtype=np.int64))[:, None] * C
                     + c[None, :]).reshape(-1)
        edge_part = ((r * p + t * m + np.arange(m, dtype=np.int64))[:, None]
                     * C + c[None, :]).reshape(-1)
        slots[t] = np.concatenate([node_part, edge_part])
    slots.setflags(write=False)
    return slots


@functools.lru_cache(maxsize=256)
def coalesced_plan(plan: Plan, r: int) -> Plan:
    """The union plan a coalesced group of ``r`` equal-plan requests
    dispatches through: same family/combiners/solver budget on the
    ``r``-copy union graph, with per-tenant side channels (faults,
    telemetry) stripped — the server owns observability for coalesced
    dispatches. For a fault-free plan, ``r = 1`` returns the tenant plan
    itself, so singleton groups share the tenant's own cached session;
    faults are stripped on the ``r = 1`` path too, so plan-level fault
    injection never depends on whether a request happened to coalesce
    (the server additionally rejects fault-carrying plans at
    registration)."""
    if r == 1:
        return plan if plan.faults is None else plan.replace(faults=None)
    g = union_graph(plan.graph, r)
    tf = None
    if plan.theta_fixed is not None:
        fam = plan.family_instance
        slots = tenant_param_slots(plan.family, plan.graph, r)
        out = np.zeros(fam.n_params(g), dtype=np.float64)
        for t in range(r):
            out[slots[t]] = np.asarray(plan.theta_fixed, dtype=np.float64)
        tf = tuple(float(v) for v in out)
    return plan.replace(graph=g, theta_fixed=tf, faults=None, telemetry=None)


def pad_group_size(r: int, max_coalesce: int) -> int:
    """Power-of-two group padding, capped at ``max_coalesce`` — bounds the
    set of union shapes (and therefore cached union sessions) a server can
    ever dispatch to O(log max_coalesce)."""
    if r < 1:
        raise ValueError(f"empty coalesce group (r={r})")
    size = 1
    while size < r:
        size *= 2
    return min(size, max(max_coalesce, r))


def as_device_tensor(a, device: torch.device) -> torch.Tensor:
    """``a`` (a tensor, numpy array or nested lists) as a tensor of its own
    type on ``device``; read-only numpy arrays are copied first."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        if not a.flags.writeable:
            a = a.copy()
        a = torch.as_tensor(a)
    return a.to(device)


def stack_columns(mats: Sequence, r_pad: int, device=None) -> torch.Tensor:
    """Column-stack r same-shape (n, p) sample matrices (tensors or arrays)
    into the union's (n, r_pad*p) tensor on ``device`` (the CUDA card when
    None), repeating the last member into phantom padding slots. A single
    member already on the device is returned as it is."""
    dev = resolve_device(device)
    mats = [as_device_tensor(m, dev) for m in mats]
    if not mats:
        raise ValueError("nothing to stack")
    if r_pad > len(mats):
        mats = mats + [mats[-1]] * (r_pad - len(mats))
    if len(mats) == 1:
        return mats[0]
    return torch.cat(mats, dim=1)


def split_fits(union_fits: Sequence[LocalFit], graph: Graph, family,
               include_singleton: bool, r: int) -> List[List[LocalFit]]:
    """Per-tenant ``List[LocalFit]`` banks from a union dispatch.

    Only node ids and beta index lists are relabeled to tenant-local
    coordinates; the numerical arrays are the union solve's outputs
    unchanged. Phantom padding slots (``t >= r``) are dropped by passing
    the real ``r``.
    """
    p = graph.p
    betas = [family.beta(graph, i, include_singleton) for i in range(p)]
    out: List[List[LocalFit]] = []
    for t in range(r):
        out.append([
            LocalFit(i=i, beta=betas[i], theta=f.theta, H=f.H, J=f.J,
                     V=f.V, s=f.s)
            for i, f in enumerate(union_fits[t * p: (t + 1) * p])])
    return out
