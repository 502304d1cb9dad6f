"""Single-replica training step: loss, gradient accumulation over
microbatches, AdamW update. The port of ``repro.train.step``; the
pod-consensus trainer (:mod:`.consensus`) builds on it.

Parameters are dicts of tensors on one device. Gradients come from
``torch.autograd.grad`` with respect to detached aliases of the parameters,
so the caller's tensors never take ``requires_grad``; the update then
writes them in place (:func:`repro_torch.optim.adamw.update`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from ..models import transformer as T
from ..models.common import ArchConfig
from ..optim import adamw
from ..optim.adamw import tree_leaves, tree_map
from .loss import cross_entropy


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatch: int = 0          # 0 = no accumulation
    aux_weight: float = 0.01     # MoE load-balance loss weight
    remat: bool = True
    #: the reference's mesh keeps microbatches batch-sharded; the port runs
    #: on one card, and a mesh raises
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "TrainConfig.mesh: multi-GPU training is not ported yet "
                "(ROADMAP.md queue 1, item 12); the port trains on one "
                "device")


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_state(cfg: ArchConfig, generator: torch.Generator,
               device=None) -> TrainState:
    """Parameters by ``model_init`` on ``device`` (default the CUDA card)
    from ``generator`` (a generator of that device), and a fresh AdamW
    state."""
    params = T.model_init(cfg, generator, device)
    return TrainState(params=params, opt=adamw.init(params))


def make_loss_fn(cfg: ArchConfig, tcfg: TrainConfig):
    def loss_fn(params, batch: Dict):
        logits, aux = T.forward(cfg, params, batch["tokens"],
                                enc_frames=batch.get("enc_frames"),
                                patch_embeds=batch.get("patch_embeds"),
                                remat=tcfg.remat)
        ce, metrics = cross_entropy(logits, batch["labels"])
        metrics["aux"] = aux
        return ce + tcfg.aux_weight * aux, metrics
    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """(metrics, grads) of ``loss_fn`` at ``params``, through detached
    aliases that require gradients."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, list(tree_leaves(live)))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), live)
    return {k: v.detach() for k, v in metrics.items()}, grads


def grads_of(cfg: ArchConfig, tcfg: TrainConfig, params, batch: Dict):
    """Gradients with optional microbatch accumulation: a loop over
    microbatches into float32 accumulators (the reference's ``lax.scan``),
    the metrics averaged over them. Without accumulation the gradients
    come in the parameters' types. Returns (grads, metrics)."""
    loss_fn = make_loss_fn(cfg, tcfg)
    b = batch["tokens"].shape[0]
    mb = tcfg.microbatch or b
    n_micro = max(b // mb, 1)
    if n_micro == 1:
        metrics, grads = _value_and_grad(loss_fn, params, batch)
        return grads, metrics

    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    per_micro = []
    for i in range(n_micro):
        mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        metrics, g = _value_and_grad(loss_fn, params, mbatch)
        tree_map(lambda a, g_: a.add_(g_.to(a.dtype)), acc, g)
        per_micro.append(metrics)
        del g
    grads = tree_map(lambda a: a.div_(n_micro), acc)
    metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
               for k in per_micro[0]}
    return grads, metrics


def make_train_step(cfg: ArchConfig, ocfg: adamw.AdamWConfig,
                    tcfg: TrainConfig):
    """Plain synchronous train step (the paper's 'centralized' analogue):
    ``train_step(state, batch) -> (state, metrics)``, the state updated in
    place."""
    def train_step(state: TrainState, batch: Dict):
        grads, metrics = grads_of(cfg, tcfg, state.params, batch)
        params, opt = adamw.update(ocfg, grads, state.opt, state.params)
        return TrainState(params, opt), metrics
    return train_step
