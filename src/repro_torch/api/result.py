"""Structured result of the estimation-plan API's ``fit`` verb."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.consensus import mse as _mse
from ..core.estimators import LocalFit


@dataclasses.dataclass
class EstimateResult:
    """One estimation outcome, fully accounted.

    mode            — "fit" (local fits + one-step consensus).
    theta           — the headline flat estimate: the plan's first combiner.
    combined        — per-scheme combined estimates, name -> flat theta.
    fits            — per-node :class:`LocalFit` results.
    n_samples       — rows of the sample matrix the verb consumed.
    score_norm      — ||grad pseudo-loglik(theta)|| over those samples.
    wall_s          — wall-clock of the verb, kernel build included.
    new_compiles    — kernel libraries this call built (0 once built).
    comm_scalars    — scalars a sensor network would transmit to realize
                      each requested scheme, name -> count.
    compile_s       — wall seconds of the kernel build this call paid.

    The reference's joint-verb and telemetry fields come with those slices.
    """

    mode: str
    theta: np.ndarray
    combined: Dict[str, np.ndarray]
    fits: Optional[List[LocalFit]]
    n_samples: int
    score_norm: float
    wall_s: float
    new_compiles: int
    comm_scalars: Dict[str, int]
    compile_s: float = 0.0

    def mse(self, theta_star: np.ndarray, free=None) -> float:
        """||theta - theta*||^2 over ``free`` (default: all) coordinates."""
        return _mse(self.theta, np.asarray(theta_star), free)

    def __repr__(self) -> str:
        return (f"EstimateResult(mode={self.mode!r}, "
                f"schemes={sorted(self.combined)}, n={self.n_samples}, "
                f"score_norm={self.score_norm:.3e}, "
                f"wall_s={self.wall_s:.3f}, "
                f"new_compiles={self.new_compiles})")
