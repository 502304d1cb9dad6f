"""Carry plans and parameters across from the reference package.

The port keeps the reference's layouts by design, so these are checked
identities: they validate what they are given and hand back the port's own
objects, so tests can give both packages the same state.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .api.plan import Plan
from .core.estimators import LocalFit


def plan_from_reference(d: dict) -> Plan:
    """The port's :class:`Plan` from the reference's ``plan.to_dict()``."""
    return Plan.from_dict(d)


def theta_from_numpy(theta, plan: Plan, device=None) -> torch.Tensor:
    """A flat theta (``family.n_params(graph)`` entries, coordinate-major
    block order: node blocks then edge blocks) as a float64 tensor."""
    arr = np.asarray(theta, dtype=np.float64)
    expect = plan.family_instance.n_params(plan.graph)
    if arr.shape != (expect,):
        raise ValueError(f"theta has shape {arr.shape}; family "
                         f"{plan.family!r} on this graph has {expect} params")
    return torch.as_tensor(arr, device=device)


def local_fits_from_numpy(fits: Sequence[Optional[object]]) -> List[LocalFit]:
    """The port's :class:`LocalFit` list from the reference's (whose arrays
    are numpy), checking each record's shapes against its ``beta``."""
    out = []
    for i, f in enumerate(fits):
        d = len(f.beta)
        theta = np.asarray(f.theta)
        H, J, V = (np.asarray(a) for a in (f.H, f.J, f.V))
        s = np.asarray(f.s)
        if int(f.i) != i:
            raise ValueError(f"fit {i} is for node {f.i}; pass fits in node "
                             f"order")
        if theta.shape != (d,) or any(a.shape != (d, d) for a in (H, J, V)) \
                or s.ndim != 2 or s.shape[1] != d:
            raise ValueError(f"fit of node {i}: shapes do not match its "
                             f"{d}-entry beta")
        out.append(LocalFit(i=int(f.i), beta=list(f.beta), theta=theta.copy(),
                            H=H.copy(), J=J.copy(), V=V.copy(), s=s.copy()))
    return out
