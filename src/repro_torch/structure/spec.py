"""Declarative configuration for the structure-learning verb.

A :class:`StructureSpec` says *how* ``session.select`` should estimate the
edge set: which candidate edges to consider (``policy``), which lambda
grid to walk (explicit ``lambdas`` or an auto-scaled geometric path), how
the two endpoints' neighborhoods are reconciled (``vote``), and the ADMM /
EBIC knobs. Like :class:`repro_torch.api.Plan` it is frozen, hashable, and
round-trips through ``to_dict``/``from_dict``; every invalid combination
fails loudly at construction with a pointed ``ValueError`` (negative or
unsorted lambda grids, unknown vote rules listing what IS registered,
``given`` policy without edges, ...). The one check the spec cannot do
alone — ``knn`` k against the plan's node count — lives in
``Plan.__post_init__`` and
:func:`repro_torch.structure.candidates.candidate_graph`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .voting import get_vote_rule

__all__ = ["StructureSpec", "CANDIDATE_POLICIES"]

#: candidate-edge policies ``session.select`` understands
CANDIDATE_POLICIES = ("full", "knn", "given")


@dataclasses.dataclass(frozen=True)
class StructureSpec:
    """How to run neighborhood selection. All fields have working defaults;
    ``StructureSpec()`` walks an auto-scaled 12-point lambda path over all
    candidate edges and reconciles supports by variance-weighted vote.

    policy           — candidate-edge policy: ``full`` (every pair),
                       ``knn`` (per-node top-``knn_k`` correlation
                       screening, union-symmetrized), or ``given``
                       (caller-supplied ``given_edges``).
    knn_k            — neighbors kept per node under ``knn``; must be
                       >= 1 and < p (checked against the plan's graph).
    given_edges      — the candidate edges for ``given``; (i, j) pairs
                       with i < j, as for :class:`repro_torch.core.Graph`.
    lambdas          — explicit regularization grid, strictly decreasing
                       and non-negative (the path is walked coldest-first:
                       largest lambda = sparsest model seeds the next).
                       ``None`` auto-scales a geometric grid from the
                       data's lambda_max.
    n_lambdas        — auto-grid length (ignored when ``lambdas`` given).
    lambda_min_ratio — auto-grid floor as a fraction of lambda_max,
                       in (0, 1).
    vote             — registered vote-rule name (``and`` / ``or`` /
                       ``weighted``; see :mod:`repro_torch.structure.voting`).
    ebic_gamma       — extended-BIC graph-complexity weight in [0, 1]
                       (0 = plain BIC; 0.5 is the usual high-dim default).
    admm_rounds      — max ADMM iterations per lambda (warm starts mean
                       later lambdas converge in a few).
    admm_rho         — ADMM augmented-Lagrangian penalty (> 0).
    admm_tol         — primal/dual residual norm for early stop (> 0).
    newton_iters     — Newton steps inside each batched prox solve.
    """

    policy: str = "full"
    knn_k: int = 8
    given_edges: Optional[Tuple[Tuple[int, int], ...]] = None
    lambdas: Optional[Tuple[float, ...]] = None
    n_lambdas: int = 12
    lambda_min_ratio: float = 0.05
    vote: str = "weighted"
    ebic_gamma: float = 0.5
    admm_rounds: int = 40
    admm_rho: float = 1.0
    admm_tol: float = 1e-5
    newton_iters: int = 15

    def __post_init__(self):
        if self.policy not in CANDIDATE_POLICIES:
            raise ValueError(
                f"unknown candidate policy {self.policy!r}; choose one of "
                f"{list(CANDIDATE_POLICIES)}")
        if self.given_edges is not None:
            object.__setattr__(
                self, "given_edges",
                tuple((int(i), int(j)) for i, j in self.given_edges))
        if self.policy == "given" and not self.given_edges:
            raise ValueError(
                "policy 'given' needs given_edges=((i, j), ...) — an "
                "explicit candidate edge set; got none")
        if self.given_edges is not None and self.policy != "given":
            raise ValueError(
                f"given_edges only makes sense with policy 'given' "
                f"(got policy {self.policy!r}); drop one or the other")
        if self.policy == "knn" and self.knn_k < 1:
            raise ValueError(
                f"knn_k must be >= 1 for policy 'knn'; got {self.knn_k}")
        if self.lambdas is not None:
            lams = tuple(float(l) for l in self.lambdas)
            object.__setattr__(self, "lambdas", lams)
            if not lams:
                raise ValueError("lambdas must be a non-empty grid or None "
                                 "for the auto-scaled path")
            neg = [l for l in lams if l < 0.0]
            if neg:
                raise ValueError(
                    f"lambda grid must be non-negative; got negative "
                    f"entries {neg} in {list(lams)}")
            if any(a <= b for a, b in zip(lams, lams[1:])):
                raise ValueError(
                    f"lambda grid must be strictly decreasing (the path is "
                    f"walked coldest-first, each solution warm-starting "
                    f"the next); got {list(lams)} — sort it descending and "
                    f"drop duplicates")
        if self.n_lambdas < 1:
            raise ValueError(f"n_lambdas must be >= 1; got {self.n_lambdas}")
        if not (0.0 < self.lambda_min_ratio < 1.0):
            raise ValueError(
                f"lambda_min_ratio must lie in (0, 1); got "
                f"{self.lambda_min_ratio}")
        # resolves through the registry → unknown names raise the registry's
        # pointed error listing every registered rule
        get_vote_rule(self.vote)
        if not (0.0 <= self.ebic_gamma <= 1.0):
            raise ValueError(
                f"ebic_gamma must lie in [0, 1]; got {self.ebic_gamma}")
        if self.admm_rounds < 1:
            raise ValueError(
                f"admm_rounds must be >= 1; got {self.admm_rounds}")
        if self.admm_rho <= 0.0:
            raise ValueError(f"admm_rho must be > 0; got {self.admm_rho}")
        if self.admm_tol <= 0.0:
            raise ValueError(f"admm_tol must be > 0; got {self.admm_tol}")
        if self.newton_iters < 1:
            raise ValueError(
                f"newton_iters must be >= 1; got {self.newton_iters}")

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["given_edges"] is not None:
            d["given_edges"] = [list(e) for e in d["given_edges"]]
        if d["lambdas"] is not None:
            d["lambdas"] = list(d["lambdas"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StructureSpec":
        kw = dict(d)
        if kw.get("given_edges") is not None:
            kw["given_edges"] = tuple(tuple(e) for e in kw["given_edges"])
        if kw.get("lambdas") is not None:
            kw["lambdas"] = tuple(kw["lambdas"])
        unknown = set(kw) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(
                f"unknown StructureSpec fields {sorted(unknown)}")
        return cls(**kw)

    def replace(self, **kw) -> "StructureSpec":
        return dataclasses.replace(self, **kw)
