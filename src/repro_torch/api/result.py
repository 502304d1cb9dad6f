"""Structured result of the estimation-plan API's ``fit`` and ``joint``
verbs."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.consensus import mse as _mse
from ..core.estimators import LocalFit


@dataclasses.dataclass
class EstimateResult:
    """One estimation outcome, fully accounted.

    mode            — "fit" (local fits + one-step consensus) or "joint"
                      (ADMM joint MPLE).
    theta           — the headline flat estimate: the plan's first
                      combiner for ``fit``, the final ADMM iterate for
                      ``joint``.
    combined        — per-scheme combined estimates, name -> flat theta.
    fits            — per-node :class:`LocalFit` results (None when the
                      verb never produced them, e.g. zero-init ADMM).
    n_samples       — rows of the sample matrix the verb consumed.
    score_norm      — ||grad pseudo-loglik(theta)|| over those samples.
    wall_s          — wall-clock of the verb, kernel build included.
    new_compiles    — kernel libraries this call built (0 once built).
    comm_scalars    — scalars a sensor network would transmit to realize
                      each requested scheme, name -> count; ``joint``
                      reports the K-round ADMM exchange as "admm".
    trajectory      — (admm_iters + 1, n_params) consensus iterates
                      (``joint`` only).
    primal_residual — (admm_iters,) rms primal residuals (``joint`` only).
    compile_s       — wall seconds of the kernel build this call paid.
    telemetry       — :class:`~repro_torch.telemetry.TelemetrySnapshot` of
                      the verb's spans and metrics when the plan declares a
                      :class:`~repro_torch.telemetry.TelemetrySpec`; None
                      when telemetry is off.
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
    trajectory: Optional[np.ndarray] = None
    primal_residual: Optional[np.ndarray] = None
    compile_s: float = 0.0
    telemetry: Optional[object] = None

    def mse(self, theta_star: np.ndarray, free=None) -> float:
        """||theta - theta*||^2 over ``free`` (default: all) coordinates."""
        return _mse(self.theta, np.asarray(theta_star), free)

    def __repr__(self) -> str:
        extras = ("" if self.trajectory is None
                  else f", admm_iters={len(self.trajectory) - 1}")
        return (f"EstimateResult(mode={self.mode!r}, "
                f"schemes={sorted(self.combined)}, n={self.n_samples}, "
                f"score_norm={self.score_norm:.3e}, "
                f"wall_s={self.wall_s:.3f}, "
                f"new_compiles={self.new_compiles}{extras})")
