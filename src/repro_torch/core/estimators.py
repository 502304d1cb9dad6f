"""The per-node local-estimator record (paper Eq. 3).

The fields are numpy arrays, as the reference engine returns them, so the
host-side combiners run unchanged on either package's fits.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class LocalFit:
    """Result of one sensor's local estimator (paper Eq. 3) + diagnostics."""
    i: int
    beta: List[int]            # flat parameter indices this node estimates
    theta: np.ndarray          # (d,) local estimate theta^i_{beta_i}
    H: np.ndarray              # (d, d) empirical Hessian  -mean grad^2
    J: np.ndarray              # (d, d) empirical Fisher    mean g g^T
    V: np.ndarray              # (d, d) sandwich H^-1 J H^-1
    s: np.ndarray              # (n, d) influence H^-1 grad l(theta_hat; x_k)
