"""Exact communication-cost accounting of the one-step combiners.

A one-step message carries, per shared parameter, the local estimate
(1 scalar) plus, for weighted schemes, its variance weight (1 more);
Linear-Opt's secondary round ships n influence samples per shared
parameter. The per-parameter sizes are read from the combiner registry.
"""
from __future__ import annotations


def _registry_scalars() -> dict:
    """Name-keyed ``Combiner.scalars_per_shared_param`` over the
    distributable registered combiners."""
    from ..core.combiners import registered_combiners
    return {c.name: c.scalars_per_shared_param
            for c in registered_combiners()
            if c.scalars_per_shared_param is not None}


def one_step_message_scalars(n_shared: int, scheme: str) -> int:
    """Scalars in one one-step consensus message covering n_shared params,
    resolved through the live combiner registry."""
    from ..core.combiners import get_combiner
    spp = get_combiner(scheme).scalars_per_shared_param
    if spp is None:
        raise ValueError(
            f"combiner {scheme!r} is not distributable as a one-step "
            f"message round (no scalars_per_shared_param)")
    return int(n_shared) * spp


def one_step_comm_by_scheme(shared_owner_slots: int, combiners, n: int) -> dict:
    """Per-scheme scalars ONE full one-step round transmits for a plan.

    ``shared_owner_slots`` is the number of (shared parameter, owner)
    pairs; influence-needing schemes (Linear-Opt) additionally ship their
    ``n`` influence samples per slot. Non-distributable combiners are
    omitted.
    """
    from ..core.combiners import get_combiner
    out = {}
    for name in combiners:
        c = get_combiner(name)
        if c.scalars_per_shared_param is None:
            continue               # not distributable as one message round
        cost = c.scalars_per_shared_param * int(shared_owner_slots)
        if "influence" in c.needs:
            cost += int(n) * int(shared_owner_slots)
        out[c.name] = cost
    return out
