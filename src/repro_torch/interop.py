"""Carry plans (with their fault, structure and telemetry specs),
estimates, fault plans, stream states, Ising models, model parameters and
training states across from the reference package.

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
from .core.graphs import Graph
from .core.ising import IsingModel
from .device import resolve_device
from .models.common import ArchConfig, ParamSpec
from .models.transformer import abstract_params
from .optim.adamw import AdamWState
from .stream.faults import FaultPlan
from .train.consensus import ConsensusState
from .train.step import TrainState


def plan_from_reference(d: dict) -> Plan:
    """The port's :class:`Plan` from the reference's ``plan.to_dict()``,
    its ``structure`` entry (a ``StructureSpec.to_dict()``) and its
    ``telemetry`` entry (a ``TelemetrySpec.to_dict()``) included."""
    return Plan.from_dict(d)


def fault_plan_from_reference(d: dict) -> FaultPlan:
    """The port's :class:`FaultPlan` from the reference's
    ``fault_plan.to_dict()`` (validated as the reference validates)."""
    return FaultPlan.from_dict(d)


def stream_state_from_reference(arrays: dict, meta: dict, target) -> None:
    """Load the reference's ``StreamingEstimator.state_dict()`` or
    ``StreamSimulator.state_dict()`` (numpy arrays and JSON meta) into the
    port's ``target`` of the same kind, after checking it against the
    target's configuration: the pool's p columns, the family's parameter
    count, a capacity the target's configured capacity doubles to, and the
    fitted nodes' ``beta`` layouts."""
    est = getattr(target, "est", target)
    pool = np.asarray(arrays["est/pool"])
    if pool.ndim != 2 or pool.shape[1] != est.graph.p:
        raise ValueError(f"pool has shape {pool.shape}; the target streams "
                         f"p = {est.graph.p} columns")
    cap, n = pool.shape[0], int(meta["n"])
    if n > cap or cap < est.buffer.capacity \
            or cap % est.buffer.capacity \
            or (cap // est.buffer.capacity) & (cap // est.buffer.capacity - 1):
        raise ValueError(f"pool capacity {cap} holding {n} rows is not the "
                         f"target's capacity {est.buffer.capacity} doubled")
    tf = np.asarray(arrays["est/theta_fixed"])
    if tf.shape != (est.family.n_params(est.graph),):
        raise ValueError(f"theta_fixed has shape {tf.shape}; family "
                         f"{est.family.name!r} on this graph has "
                         f"{est.family.n_params(est.graph)} params")
    betas = meta.get("betas")
    if betas is not None:
        want = [est.family.beta(est.graph, i, est.include_singleton)
                for i in range(est.graph.p)]
        if [list(b) for b in betas] != want:
            raise ValueError("the state's per-node beta layouts differ from "
                             "the target's family and singleton policy")
    target.load_state(arrays, meta)


def theta_from_numpy(theta, plan: Plan, device=None) -> torch.Tensor:
    """A flat theta (``family.n_params(graph)`` entries, coordinate-major
    block order: node blocks then edge blocks) as a float64 tensor."""
    arr = np.asarray(theta, dtype=np.float64)
    expect = plan.family_instance.n_params(plan.graph)
    if arr.shape != (expect,):
        raise ValueError(f"theta has shape {arr.shape}; family "
                         f"{plan.family!r} on this graph has {expect} params")
    return torch.as_tensor(arr, device=device)


def ising_model_from_numpy(p: int, edges, theta, device=None) -> IsingModel:
    """The port's :class:`IsingModel` from a reference model's graph (its
    node count and edge tuples) and flat theta (``p + m`` entries,
    singletons then edges), as a float64 tensor on
    ``resolve_device(device)``."""
    graph = Graph(int(p), tuple((int(i), int(j)) for i, j in edges))
    arr = np.asarray(theta, dtype=np.float64)
    if arr.shape != (graph.n_params,):
        raise ValueError(f"theta has shape {arr.shape}; an Ising model on "
                         f"this graph has {graph.n_params} params")
    return IsingModel(graph, torch.tensor(arr, device=resolve_device(device)))


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


def _tree_from_numpy(spec_tree, tree, cfg: ArchConfig, device, *,
                     lead=(), dtype=None, name="params"):
    """``tree`` (nested dicts of numpy arrays) checked key for key against
    the port's spec of ``cfg``, each leaf of shape ``lead + spec shape``,
    cast to ``dtype`` (default each spec's type) on ``device``."""
    def convert(spec_node, node, path):
        where = "/".join((name,) + path)
        if isinstance(spec_node, ParamSpec):
            arr = np.asarray(node)
            want = tuple(lead) + spec_node.shape
            if arr.shape != want:
                raise ValueError(f"{where}: shape {arr.shape}, the port's "
                                 f"spec has {want}")
            if arr.dtype.name == "bfloat16":     # numpy has no bf16 of its own
                arr = arr.astype(np.float32)
            dt = dtype or spec_node.dtype or cfg.torch_dtype
            return torch.tensor(arr).to(device=device, dtype=dt)
        if not isinstance(node, dict) or set(node) != set(spec_node):
            got = sorted(node) if isinstance(node, dict) else type(node)
            raise ValueError(f"{where}: keys {got}, the port's spec has "
                             f"{sorted(spec_node)}")
        return {k: convert(spec_node[k], node[k], path + (k,))
                for k in spec_node}
    return convert(spec_tree, tree, ())


def params_from_numpy(tree, cfg: ArchConfig, device=None):
    """The port's model parameters from the reference's parameter pytree
    (nested dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray,
    model_init(cfg, key))``), each checked against the port's spec of
    ``cfg`` and cast to its dtype on ``device`` (default the CUDA card;
    raises without one)."""
    return _tree_from_numpy(abstract_params(cfg), tree, cfg,
                            resolve_device(device))


def _step_from_numpy(step, shape, device) -> torch.Tensor:
    arr = np.asarray(step)
    if arr.shape != shape or arr.dtype.kind not in "iu":
        raise ValueError(f"opt/step: {arr.dtype} of shape {arr.shape}; "
                         f"expected integers of shape {shape}")
    return torch.tensor(arr.astype(np.int32), device=device)


def _adamw_from_numpy(opt, cfg: ArchConfig, device, lead=()):
    spec = abstract_params(cfg)
    return AdamWState(
        step=_step_from_numpy(opt.step, tuple(lead), device),
        m=_tree_from_numpy(spec, opt.m, cfg, device, lead=lead,
                           dtype=torch.float32, name="opt/m"),
        v=_tree_from_numpy(spec, opt.v, cfg, device, lead=lead,
                           dtype=torch.float32, name="opt/v"))


def train_state_from_numpy(state, cfg: ArchConfig, device=None):
    """The port's :class:`~repro_torch.train.step.TrainState` from the
    reference's (``jax.tree.map(np.asarray, state)``: ``params`` and
    ``opt`` with ``step``, ``m`` and ``v``), every tree checked against the
    port's spec of ``cfg``: parameters in their spec's types, moments in
    float32, the step an int32 scalar, on ``device`` (default the CUDA
    card)."""
    device = resolve_device(device)
    return TrainState(params=params_from_numpy(state.params, cfg, device),
                      opt=_adamw_from_numpy(state.opt, cfg, device))


def consensus_state_from_numpy(state, cfg: ArchConfig, n_pods: int,
                               device=None):
    """The port's :class:`~repro_torch.train.consensus.ConsensusState` from
    the reference's: per-pod ``params``, moments and ``lam`` stacked on a
    leading axis of ``n_pods``, per-pod step counters of shape
    (``n_pods``,), and ``theta_bar`` of the parameters' shapes, each
    checked against the port's spec of ``cfg`` (``lam`` in float32) on
    ``device`` (default the CUDA card)."""
    device = resolve_device(device)
    spec, lead = abstract_params(cfg), (int(n_pods),)
    return ConsensusState(
        params=_tree_from_numpy(spec, state.params, cfg, device, lead=lead),
        opt=_adamw_from_numpy(state.opt, cfg, device, lead=lead),
        lam=_tree_from_numpy(spec, state.lam, cfg, device, lead=lead,
                             dtype=torch.float32, name="lam"),
        theta_bar=_tree_from_numpy(spec, state.theta_bar, cfg, device,
                                   name="theta_bar"))
