"""The structure verb's return type: an estimated edge set with receipts.

A :class:`StructureResult` carries everything a caller needs to audit HOW
the support was chosen, mirroring :class:`repro_torch.api.EstimateResult`:
the selected graph plus the full decision trail: the lambda path walked,
the EBIC curve and its argmin, every candidate edge's vote margin, the
exact vote-message scalar bill, and the kernel-build/wall split.
``edge_metrics(true_edges)`` scores the recovery against a known
generator (precision / recall / F1 — what the planted-graph bench
asserts).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.graphs import Edge, Graph

__all__ = ["StructureResult"]


@dataclasses.dataclass
class StructureResult:
    """What ``session.select`` returns.

    support        — the voted edge set, (i, j) pairs with i < j.
    graph          — the same support as a :class:`~repro_torch.core.Graph`
                     (ready to drop into a new ``Plan`` and fit).
    candidate_edges — the screened candidate set the path searched over.
    vote_rule      — name of the rule that reconciled the endpoints.
    margins        — per *candidate* edge signed vote margin in [-1, 1]
                     (aligned with ``candidate_edges``; > 0 means kept).
    lambdas        — the descending grid actually walked.
    lambda_selected — EBIC's pick.
    ebic           — per-lambda EBIC scores (aligned with ``lambdas``).
    support_sizes  — per-lambda VOTED support size (the path's sparsity
                     trace, after reconciliation).
    thetas         — per-node beta-ordered estimates at the selected
                     lambda: the dense fit's values masked to the
                     selected support (refit-free debiasing; exact zeros
                     off-support).
    n_samples      — rows of X consumed.
    comm_scalars   — exact vote-message bill from
                     :func:`repro_torch.stream.costs.structure_vote_scalars`.
    wall_s / compile_s — select wall clock and the seconds of kernel-library
                     builds it paid.
    path_compiles  — kernel libraries built during the lambda path (0 once
                     the libraries are built).
    new_compiles   — kernel libraries built during the whole call.
    telemetry      — :class:`~repro_torch.telemetry.TelemetrySnapshot` of
                     the call's spans and metrics when the plan declares a
                     ``TelemetrySpec``; None when telemetry is off.
    """

    support: Tuple[Edge, ...]
    graph: Graph
    candidate_edges: Tuple[Edge, ...]
    vote_rule: str
    margins: np.ndarray
    lambdas: Tuple[float, ...]
    lambda_selected: float
    ebic: np.ndarray
    support_sizes: Tuple[int, ...]
    thetas: List[np.ndarray]
    n_samples: int
    comm_scalars: int
    wall_s: float
    compile_s: float
    path_compiles: int
    new_compiles: int
    telemetry: Optional[object] = None

    def edge_metrics(self, true_edges) -> Dict[str, float]:
        """Precision / recall / F1 of ``support`` against a known edge set."""
        truth = {(min(i, j), max(i, j)) for i, j in true_edges}
        got = set(self.support)
        tp = len(got & truth)
        prec = tp / len(got) if got else (1.0 if not truth else 0.0)
        rec = tp / len(truth) if truth else 1.0
        f1 = (2 * prec * rec / (prec + rec)) if (prec + rec) > 0 else 0.0
        return {"precision": prec, "recall": rec, "f1": f1,
                "tp": float(tp), "fp": float(len(got - truth)),
                "fn": float(len(truth - got))}

    def __repr__(self):
        return (f"StructureResult(|support|={len(self.support)}, "
                f"|candidates|={len(self.candidate_edges)}, "
                f"vote={self.vote_rule!r}, "
                f"lambda={self.lambda_selected:.4g}, "
                f"comm_scalars={self.comm_scalars}, "
                f"wall_s={self.wall_s:.3f})")
