"""AdamW on dicts of tensors, the port of ``repro.optim.adamw``.

The second-moment EMA ``v`` doubles as the per-parameter empirical Fisher
diagonal, the 1/Vhat weight of the paper's Prop 4.4/4.7 for the diagonal
and max consensus; ``fisher_diag(state)`` exposes it, and the consensus
trainer reads it with no extra communication. So this is not
``torch.optim.AdamW``: the trainer needs ``v`` as a tree it can read.

:func:`update` works in place: it advances ``step`` and overwrites ``m``,
``v`` and the parameters, leaf by leaf and in slices of at most
``_SLICE`` elements along the leading axis. A 3.6 B-parameter model's
parameters and moments take 36 GB, and an out-of-place update would hold
as much again. Every operation is elementwise, so slicing changes no bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple

import torch

#: elements per slice of an in-place update: five float32 temporaries of
#: this size (1.3 GB in all) at a time
_SLICE = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32: () for one replica, (P,) stacked pods
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in float32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init(params) -> AdamWState:
    """Zero float32 moments and step 0 (an int32 scalar on the parameters'
    device)."""
    leaf = next(tree_leaves(params))
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaf.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _slices(t: torch.Tensor):
    """Views of ``t`` along its leading axis of at most ``_SLICE``
    elements each (``t`` itself when it is small or 0-d)."""
    if t.dim() == 0 or t.numel() <= _SLICE:
        yield t
        return
    rows = max(1, _SLICE // max(t[0].numel(), 1))
    for r in range(0, t.shape[0], rows):
        yield t.narrow(0, r, min(rows, t.shape[0] - r))


@torch.no_grad()
def _update_leaf(cfg: AdamWConfig, lr, b1c, b2c, g, m, v, p) -> None:
    for gs, ms, vs, ps in zip(_slices(g), _slices(m), _slices(v),
                              _slices(p)):
        g32 = gs.to(torch.float32)
        ms.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        vs.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        del g32
        p32 = ps.to(torch.float32)      # ps itself when it is float32
        delta = (ms / b1c) / (torch.sqrt(vs / b2c) + cfg.eps)
        delta.add_(cfg.weight_decay * p32)
        ps.copy_(p32 - lr * delta)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step, in place: ``state.step`` += 1, then ``state.m``,
    ``state.v`` and ``params`` are overwritten. Each parameter is updated
    in float32 and cast back to its type; m and v are float32. Returns
    (params, state): the same objects."""
    state.step.add_(1)
    lr = schedule(cfg, state.step)
    step32 = state.step.to(torch.float32)
    b1c = 1 - cfg.b1 ** step32
    b2c = 1 - cfg.b2 ** step32
    tree_map(lambda g, m, v, p: _update_leaf(cfg, lr, b1c, b2c, g, m, v, p),
             grads, state.m, state.v, params)
    return params, state


def fisher_leaf(v: torch.Tensor, step) -> torch.Tensor:
    """One leaf of :func:`fisher_diag`: ``v`` over its bias correction at
    ``step`` (at least 1)."""
    s = torch.clamp(torch.as_tensor(step).to(torch.float32), min=1.0)
    return v / (1 - 0.95 ** s)


def fisher_diag(state: AdamWState) -> Dict:
    """Per-parameter empirical Fisher proxy (the bias-corrected grad^2 EMA):
    the paper's 1/Vhat^i_aa diagonal weight at pod granularity, available
    with no extra communication (Prop 4.4's practical advantage). The bias
    correction uses 0.95, the default b2, as the reference does."""
    return tree_map(lambda v: fisher_leaf(v, state.step), state.v)
