"""Distributed support voting: reconcile the two endpoints' neighborhoods.

Neighborhood selection runs one group-lasso per node, so every candidate
edge (i, j) gets TWO independent in/out verdicts — node i's and node j's —
and at finite n they disagree (Mizrahi et al. 2014 reconcile exactly such
marginal-subgraph estimates; Liu & Ihler 2014's message-sufficiency view
says what a vote message must carry: the decision, plus a confidence mass
for weighted rules). A :class:`VoteRule` turns the two verdicts into one
support decision per edge, with a signed **vote margin** in [-1, 1]
(positive = in-support; magnitude = confidence) recorded per candidate
edge.

Mirroring the family/combiner registries, rules are small strategy objects
registered by name (:func:`register_vote_rule` / :func:`get_vote_rule` /
:func:`registered_vote_rules`); unknown names fail loudly listing what is
registered, and the vote-message accounting
(:func:`repro_torch.stream.costs.structure_vote_scalars`) reads each rule's
``scalars_per_edge_vote`` so a new rule is billed correctly without
touching the cost tables.

Registered rules:

  and       — intersection (Meinshausen-Buhlmann "min" symmetrization):
              an edge survives only if BOTH endpoints selected it. Fewest
              false positives; margin = min of the two signed votes.
  or        — union ("max" symmetrization): either endpoint suffices.
              Fewest false negatives; margin = max of the signed votes.
  weighted  — variance-weighted vote (the structure-learning twin of the
              ``weighted_vote`` combiner): each endpoint votes with mass
              1 / Vhat of its edge-block estimate (from the dense
              candidate-graph fit's sandwich diagonal — the combiner
              second-order info, reused), the signed masses are summed and
              normalized, and the sign decides. An exact mass tie falls
              back to the union rule, so the decision never depends on
              node ids — relabeling nodes permutes the support, bit-for-
              bit (tested).

Every rule is symmetric in its endpoints by construction: ``decide`` may
only combine the two votes through symmetric reductions (min/max/sum), so
support recovery is equivariant under node permutations.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["VoteRule", "register_vote_rule", "get_vote_rule",
           "registered_vote_rules", "reconcile",
           "AND_VOTE", "OR_VOTE", "WEIGHTED_VOTE"]


class VoteRule:
    """One support-reconciliation strategy for candidate-edge votes.

    ``decide`` is vectorized over the candidate-edge axis and must be
    symmetric under swapping the a/b endpoint arguments (the registry's
    permutation-equivariance contract, pinned by the voting tests).
    """

    name: str = ""
    #: scalars ONE endpoint ships per candidate edge in a vote round: the
    #: in/out decision (1), plus the vote mass for mass-weighted rules —
    #: what :func:`repro_torch.stream.costs.structure_vote_scalars` bills
    scalars_per_edge_vote: int = 1
    #: True when the rule reads the per-endpoint vote masses (inverse
    #: sandwich variances); the select verb only computes the dense
    #: candidate-graph fit's second-order info when some rule needs it
    needs_mass: bool = False

    def decide(self, in_a: np.ndarray, in_b: np.ndarray,
               mass_a: np.ndarray, mass_b: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(keep, margin) over candidate edges.

        in_a/in_b — (E,) bool endpoint verdicts; mass_a/mass_b — (E,)
        positive vote masses (all-ones for unweighted rules). Returns the
        (E,) bool keep mask and the (E,) signed margin in [-1, 1].
        """
        raise NotImplementedError


class AndVote(VoteRule):
    """Intersection: both endpoints must select the edge."""
    name = "and"
    scalars_per_edge_vote = 1

    def decide(self, in_a, in_b, mass_a, mass_b):
        s_a = np.where(in_a, 1.0, -1.0)
        s_b = np.where(in_b, 1.0, -1.0)
        margin = np.minimum(s_a, s_b)
        return margin > 0.0, margin


class OrVote(VoteRule):
    """Union: either endpoint suffices."""
    name = "or"
    scalars_per_edge_vote = 1

    def decide(self, in_a, in_b, mass_a, mass_b):
        s_a = np.where(in_a, 1.0, -1.0)
        s_b = np.where(in_b, 1.0, -1.0)
        margin = np.maximum(s_a, s_b)
        return margin > 0.0, margin


class WeightedVote(VoteRule):
    """Variance-weighted vote: signed masses summed, sign decides.

    margin = (s_a * m_a + s_b * m_b) / (m_a + m_b) with s = +-1 the
    endpoint verdicts — a confident (low-variance) endpoint outvotes a
    shaky one. Exact zero margin (equal masses, opposite verdicts) falls
    back to the union rule so ties resolve identically under any node
    relabeling.
    """
    name = "weighted"
    scalars_per_edge_vote = 2    # decision + vote mass
    needs_mass = True

    def decide(self, in_a, in_b, mass_a, mass_b):
        m_a = np.where(np.isfinite(mass_a) & (mass_a > 0.0), mass_a, 0.0)
        m_b = np.where(np.isfinite(mass_b) & (mass_b > 0.0), mass_b, 0.0)
        s_a = np.where(in_a, 1.0, -1.0)
        s_b = np.where(in_b, 1.0, -1.0)
        tot = m_a + m_b
        margin = np.where(tot > 0.0, (s_a * m_a + s_b * m_b)
                          / np.where(tot > 0.0, tot, 1.0), 0.0)
        keep = (margin > 0.0) | ((margin == 0.0) & (in_a | in_b))
        return keep, margin


def reconcile(in_a: np.ndarray, in_b: np.ndarray, rule,
              mass_a: Optional[np.ndarray] = None,
              mass_b: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Reconcile both endpoints' verdicts over the candidate-edge axis.

    ``rule`` is a :class:`VoteRule` or a registered name. ``mass_a/b``
    default to all-ones (what unweighted rules see anyway; a mass-needing
    rule then degrades to majority-of-two, which its tie fallback handles).
    Returns ``(keep, margin)`` arrays aligned with the inputs.
    """
    r = get_vote_rule(rule) if isinstance(rule, str) else rule
    in_a = np.asarray(in_a, dtype=bool)
    in_b = np.asarray(in_b, dtype=bool)
    if in_a.shape != in_b.shape:
        raise ValueError(f"endpoint verdicts disagree in shape: "
                         f"{in_a.shape} vs {in_b.shape}")
    ones = np.ones(in_a.shape, dtype=np.float64)
    m_a = ones if mass_a is None else np.asarray(mass_a, dtype=np.float64)
    m_b = ones if mass_b is None else np.asarray(mass_b, dtype=np.float64)
    return r.decide(in_a, in_b, m_a, m_b)


# --------------------------------------------------------------- registry
_VOTE_RULES: Dict[str, VoteRule] = {}


def register_vote_rule(rule: VoteRule) -> VoteRule:
    """Register (or replace) a vote rule under ``rule.name``."""
    if not rule.name:
        raise ValueError("vote rule needs a non-empty name")
    _VOTE_RULES[rule.name] = rule
    return rule


def get_vote_rule(name: str) -> VoteRule:
    """Resolve a vote rule by name; unknown names fail loudly listing the
    registered rules (the registry convention shared with families and
    combiners)."""
    try:
        return _VOTE_RULES[name]
    except KeyError:
        raise ValueError(
            f"unknown vote rule {name!r}; registered vote rules: "
            f"{sorted(_VOTE_RULES)}") from None


def registered_vote_rules() -> Tuple[VoteRule, ...]:
    """All registered vote rules, name-sorted."""
    return tuple(_VOTE_RULES[k] for k in sorted(_VOTE_RULES))


AND_VOTE = register_vote_rule(AndVote())
OR_VOTE = register_vote_rule(OrVote())
WEIGHTED_VOTE = register_vote_rule(WeightedVote())
