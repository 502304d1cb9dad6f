"""Pod-level consensus training, the paper's technique lifted to pods; the
port of ``repro.train.consensus``.

Each pod is a "sensor": it holds a disjoint data shard and runs H local
AdamW steps. Every round the per-pod parameter estimates are combined with
the paper's one-step consensus rules (Sec. 3.1), or kept in an ADMM loop
(Sec. 3.2):

  uniform   plain average (Linear-Uniform; the FedAvg / local-SGD analogue)
  diagonal  inverse-variance weights from the per-pod Fisher diagonal
            (Adam's v EMA): Prop 4.4/4.7's weights at no extra cost
  max       per-parameter argmax-weight vote (Max-Diagonal), ties averaged
  admm      per-pod proximal objective and dual state, theta_bar by the
            weighted consensus; Thm 3.1's any-time property: theta_bar is
            a valid checkpoint after every round

Per-pod state is stacked on a leading (P, ...) axis, as in the reference.
Where the reference vmaps the local step over that axis, the port loops
over pods and each pod steps on views ``[i]`` of the stacked tensors, which
the update writes in place (``torch.func.vmap`` cannot carry the attention
kernel's autograd Function). Each pod keeps its own step counter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from ..models import transformer as T
from ..models.common import ArchConfig
from ..optim import adamw
from ..optim.adamw import AdamWState, fisher_leaf, tree_map
from .step import TrainConfig, grads_of

SCHEMES = ("uniform", "diagonal", "max", "admm")


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    n_pods: int = 2
    scheme: str = "diagonal"     # uniform | diagonal | max | admm
    h_steps: int = 4             # local steps per consensus round
    rho: float = 1.0             # ADMM penalty scale on fisher weights
    eps: float = 1e-8


class ConsensusState(NamedTuple):
    params: Any       # (P, ...) per-pod replicas
    opt: AdamWState   # (P, ...) stacked moments, (P,) step counters
    lam: Any          # (P, ...) ADMM duals (zeros unless scheme == admm)
    theta_bar: Any    # (...) consensus reference (ADMM; else last combine)


def init_state(cfg: ArchConfig, generator: torch.Generator,
               ccfg: ConsensusConfig, device=None) -> ConsensusState:
    """``model_init`` parameters (on ``device``, default the CUDA card, from
    ``generator``) copied to every pod, zero moments and duals, per-pod step
    counters at 0, and theta_bar the initial parameters."""
    params = T.model_init(cfg, generator, device)
    stacked = tree_map(lambda p: p[None].repeat(
        (ccfg.n_pods,) + (1,) * p.dim()), params)
    opt = adamw.init(stacked)
    opt = opt._replace(step=torch.zeros((ccfg.n_pods,), dtype=torch.int32,
                                        device=opt.step.device))
    lam = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), stacked)
    return ConsensusState(params=stacked, opt=opt, lam=lam, theta_bar=params)


def _fisher_weights(opt: AdamWState, eps: float):
    """Per-pod, per-parameter 1/Vhat weights from the Adam second moment,
    bias-corrected at the largest step counter."""
    step = opt.step.max()
    return tree_map(lambda v: fisher_leaf(v, step) + eps, opt.v)


def _combine_leaf(scheme: str, p, w):
    """One stacked leaf (P, ...) -> its consensus (...)."""
    if scheme == "uniform":
        return p.to(torch.float32).mean(0).to(p.dtype)
    if scheme in ("diagonal", "admm"):
        num = (p.to(torch.float32) * w).sum(0)
        return (num / w.sum(0)).to(p.dtype)
    if scheme == "max":
        # compare-and-select, as the reference does
        sel = (w == w.amax(dim=0, keepdim=True)).to(torch.float32)
        num = (p.to(torch.float32) * sel).sum(0)
        den = torch.clamp(sel.sum(0), min=1.0)     # ties averaged
        return (num / den).to(p.dtype)
    raise ValueError(f"unknown consensus scheme {scheme!r}; known: "
                     f"{', '.join(SCHEMES)}")


def combine(scheme: str, params, weights):
    """Combine per-pod stacked params (P, ...) -> consensus (...)."""
    return tree_map(lambda p, w: _combine_leaf(scheme, p, w), params,
                    weights)


def _pod(tree, i: int):
    """Pod ``i``'s views of a stacked tree."""
    return tree_map(lambda t: t[i], tree)


def make_round_step(cfg: ArchConfig, ocfg: adamw.AdamWConfig,
                    tcfg: TrainConfig, ccfg: ConsensusConfig):
    """One consensus round: H local steps per pod, then the cross-pod
    combination. ``round_step(state, batch) -> (state, metrics)`` with
    ``batch`` a dict of (P, H, local_batch, ...) tensors (pod-major); the
    per-pod parameters, moments, step counters and duals are updated in
    place, theta_bar is new. Metrics are means over pods and steps."""
    if ccfg.scheme not in SCHEMES:
        raise ValueError(f"unknown consensus scheme {ccfg.scheme!r}; "
                         f"known: {', '.join(SCHEMES)}")

    def local_step(params, opt, lam, theta_bar, batch):
        grads, metrics = grads_of(cfg, tcfg, params, batch)
        if ccfg.scheme == "admm":
            # proximal gradient: grad += lam + rho_w * (theta - theta_bar),
            # the weights at this pod's own step
            def prox(g, l, p, tb, v):
                w = fisher_leaf(v, opt.step) + ccfg.eps
                return g.to(torch.float32) + l + ccfg.rho * w * (
                    p.to(torch.float32) - tb.to(torch.float32))
            grads = tree_map(prox, grads, lam, params, theta_bar, opt.v)
        adamw.update(ocfg, grads, opt, params)
        return metrics

    @torch.no_grad()
    def end_of_round(state: ConsensusState) -> ConsensusState:
        step = state.opt.step.max()

        def leaf(p, v, lam):
            w = None if ccfg.scheme == "uniform" else \
                fisher_leaf(v, step) + ccfg.eps
            tb = _combine_leaf(ccfg.scheme, p, w)
            if ccfg.scheme == "admm":
                # dual ascent; local params stay local (joint optimisation)
                lam.add_(ccfg.rho * w * (p.to(torch.float32)
                                         - tb.to(torch.float32)[None]))
            else:
                # one-step consensus: pods restart from the combined estimate
                p.copy_(tb[None].expand_as(p))
            return tb

        theta_bar = tree_map(leaf, state.params, state.opt.v, state.lam)
        return state._replace(theta_bar=theta_bar)

    def round_step(state: ConsensusState, batch: Dict):
        per_step = []
        for h in range(ccfg.h_steps):
            for i in range(ccfg.n_pods):
                opt = AdamWState(state.opt.step[i], _pod(state.opt.m, i),
                                 _pod(state.opt.v, i))
                per_step.append(local_step(
                    _pod(state.params, i), opt, _pod(state.lam, i),
                    state.theta_bar, {k: v[i, h] for k, v in batch.items()}))
        metrics = {k: torch.stack([m[k] for m in per_step]).mean()
                   for k in per_step[0]}
        return end_of_round(state), metrics

    return round_step
