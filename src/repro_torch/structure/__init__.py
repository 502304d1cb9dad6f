"""Structure learning: estimate the graph, not just the parameters.

Distributed pseudo-likelihood lasso (group-lasso-penalized neighborhood
selection per node over a screened candidate-edge set, along a warm-started
regularization path), then reconciliation of the p disagreeing
neighborhoods into one support by registered vote rules, with exact
per-scalar message accounting. Ising, Gaussian and Potts all work: the
penalty operates on the family's C-wide edge blocks. Every ADMM round's
smooth half runs on the batched proximal engine, so on the card every prox
Newton iteration is one Newton-kernel launch.

Reachable as the session verb ``select``:

    from repro_torch.api import Plan, StructureSpec
    res = Plan(graph=g, family="ising",
               structure=StructureSpec(policy="full")).session().select(X)
    res.graph          # the recovered Graph
    res.edge_metrics(true_edges)["f1"]

Modules: :mod:`.spec` (declarative config + loud validation),
:mod:`.candidates` (full / knn / given screening), :mod:`.solver`
(ADMM group-lasso path on the batched engine, auto lambda grids, EBIC),
:mod:`.voting` (vote-rule registry + reconciliation), :mod:`.result`
(:class:`StructureResult`).
"""
from .candidates import candidate_graph
from .result import StructureResult
from .solver import (auto_lambda_grid, debias_to_support, ebic_scores,
                     edge_supports, lasso_path, node_logliks)
from .spec import CANDIDATE_POLICIES, StructureSpec
from .voting import (VoteRule, get_vote_rule, reconcile, register_vote_rule,
                     registered_vote_rules)

__all__ = [
    "StructureSpec", "StructureResult", "CANDIDATE_POLICIES",
    "candidate_graph", "auto_lambda_grid", "lasso_path", "node_logliks",
    "ebic_scores", "edge_supports", "debias_to_support",
    "VoteRule", "register_vote_rule", "get_vote_rule",
    "registered_vote_rules", "reconcile",
]
