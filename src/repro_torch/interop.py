"""Carry plans, estimates and model parameters across from the reference
package.

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
from .device import resolve_device
from .models.common import ArchConfig, ParamSpec
from .models.transformer import abstract_params


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


def params_from_numpy(tree, cfg: ArchConfig, device=None):
    """The port's model parameters from the reference's parameter pytree
    (nested dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray,
    model_init(cfg, key))``), each checked against the port's spec of
    ``cfg`` and cast to its dtype on ``device`` (default the CUDA card;
    raises without one)."""
    device = resolve_device(device)

    def convert(spec_node, node, path):
        if isinstance(spec_node, ParamSpec):
            arr = np.asarray(node)
            if arr.shape != spec_node.shape:
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, the "
                                 f"port's spec has {spec_node.shape}")
            if arr.dtype.name == "bfloat16":     # numpy has no bf16 of its own
                arr = arr.astype(np.float32)
            dt = spec_node.dtype or cfg.torch_dtype
            return torch.tensor(arr).to(device=device, dtype=dt)
        if not isinstance(node, dict) or set(node) != set(spec_node):
            got = sorted(node) if isinstance(node, dict) else type(node)
            raise ValueError(f"{'/'.join(path) or 'params'}: keys {got}, the "
                             f"port's spec has {sorted(spec_node)}")
        return {k: convert(spec_node[k], node[k], path + (k,))
                for k in spec_node}
    return convert(abstract_params(cfg), tree, ())
