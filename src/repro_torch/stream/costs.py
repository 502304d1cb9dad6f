"""Exact communication-cost accounting of the one-step combiners and ADMM.

A one-step message carries, per shared parameter, the local estimate
(1 scalar) plus, for weighted schemes, its variance weight (1 more);
Linear-Opt's secondary round ships n influence samples per shared
parameter; an ADMM round message carries the local estimate per shared
parameter; a support-voting round ships each candidate edge's two endpoint
votes. The per-parameter sizes are read from the combiner registry.
"""
from __future__ import annotations

from ..core.asymptotics import param_owners
from ..core.graphs import Graph


def _registry_scalars() -> dict:
    """Name-keyed ``Combiner.scalars_per_shared_param`` over the
    distributable registered combiners."""
    from ..core.combiners import registered_combiners
    return {c.name: c.scalars_per_shared_param
            for c in registered_combiners()
            if c.scalars_per_shared_param is not None}


#: import-time snapshot for the built-in schemes; ``one_step_message_
#: scalars`` resolves through the live registry
SCHEME_SCALARS_PER_PARAM = _registry_scalars()


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


def shared_owner_slot_count(g: Graph, include_singleton: bool = True,
                            family=None) -> int:
    """(shared parameter, owner) pairs of a graph — the unit the one-step
    accounting bills per scheme."""
    owners = param_owners(g, include_singleton, family)
    return sum(len(own) for own in owners.values() if len(own) > 1)


def plan_request_scalars(g: Graph, combiners, n: int,
                         include_singleton: bool = True,
                         family=None) -> int:
    """Total scalars one fit/stream round of a plan transmits, summed over
    its requested distributable combiners — what the serving tier's
    admission control charges a tenant per request."""
    slots = shared_owner_slot_count(g, include_singleton, family)
    return sum(one_step_comm_by_scheme(slots, combiners, n).values())


def structure_vote_scalars(n_candidate_edges: int, rule: str) -> int:
    """Scalars one support-voting round transmits for a candidate edge set.

    Every candidate edge has exactly two voters (its endpoints), and each
    ships ``scalars_per_edge_vote`` scalars (the in/out decision, plus the
    vote mass for mass-weighted rules), read from the vote-rule registry
    (:mod:`repro_torch.structure.voting`), so a newly registered rule is
    billed correctly. Unknown names raise the registry's ``ValueError``.
    This is what :class:`repro_torch.structure.StructureResult` reports as
    ``comm_scalars``.
    """
    from ..structure.voting import get_vote_rule
    return 2 * int(n_candidate_edges) * get_vote_rule(rule).scalars_per_edge_vote


def admm_message_scalars(n_shared: int) -> int:
    """Scalars in one ADMM-round message covering n_shared params."""
    return int(n_shared)


def comm_costs(g: Graph, n: int, admm_iters: int) -> dict:
    """Exact combinatorial scalar counts per sensor-network method.

    one-step consensus    : each node sends estimate (+ weight) per shared
                            param
    Linear-Opt (Prop 4.6) : adds the secondary round shipping s^i_alpha
                            samples
    ADMM (K iters)        : K rounds of local-estimate exchange
    centralized           : ship the raw dataset to a fusion center
    """
    owners = param_owners(g)
    shared = [a for a, own in owners.items() if len(own) > 1]
    beta_sizes = [len(g.beta(i)) for i in range(g.p)]
    # estimates travel once per shared param per owner; weights double it
    one_step = sum(
        one_step_message_scalars(len(owners[a]), "uniform") for a in shared)
    diag = sum(
        one_step_message_scalars(len(owners[a]), "diagonal") for a in shared)
    # Prop 4.6 secondary round: each node ships n influence samples per
    # shared parameter it owns
    linear_opt = diag + n * one_step
    admm = admm_iters * 2 * sum(beta_sizes)      # send theta^i, get theta_bar
    central = n * g.p                            # raw data to fusion center
    return dict(one_step_linear=one_step, diagonal_or_max=diag,
                linear_opt=linear_opt, admm=admm, centralized=central)
