"""Model composition for the dense GQA decoder: parameters, full-sequence
forward (the prefill path), KV caches and the one-token decode step. The
port of ``repro.models.transformer`` for block kind ``"attn"`` with
``attn_kind="gqa"``.

Block parameters are stacked (a leading layer axis), as in the reference,
and a Python loop over the layer axis takes the place of ``lax.scan``; with
gradients on, ``remat`` wraps each unit in ``torch.utils.checkpoint`` as
the reference wraps its scan body in ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import attention as A
from .common import (ArchConfig, apply_norm, init_params, mlp_apply,
                     mlp_spec, norm_spec, spec)

#: what the port does not carry yet, and the ROADMAP.md item that owes it
_LATER = "ROADMAP.md queue 1, item 16"


def require_supported(cfg: ArchConfig) -> None:
    """Raise unless the port carries every block of ``cfg``."""
    missing = []
    if tuple(cfg.pattern) != ("attn",):
        missing.append(f"block pattern {cfg.pattern}")
    if cfg.attn_kind != "gqa":
        missing.append(f"attn_kind={cfg.attn_kind!r}")
    if cfg.enc_dec or cfg.n_patches:
        missing.append("encoder-decoder and multimodal inputs")
    if cfg.pos_emb not in ("rope", "none"):
        missing.append(f"pos_emb={cfg.pos_emb!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(missing)} not ported yet ({_LATER}); "
            f"the port carries dense GQA decoders")


def _stack(tree, stack: int):
    return {k: spec((stack,) + v.shape, (None,) + v.axes, v.init, v.scale,
                    v.dtype) for k, v in tree.items()}


def _block_spec(cfg: ArchConfig, stack: int):
    return {"norm1": norm_spec(cfg, stack), "norm2": norm_spec(cfg, stack),
            "attn": A.gqa_spec(cfg, stack),
            "mlp": _stack(mlp_spec(cfg), stack)}


def abstract_params(cfg: ArchConfig):
    """Full model ParamSpec tree, in the reference's layout."""
    require_supported(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab
    tree: Dict[str, Any] = {
        "embed": spec((vp, d), ("vocab", None), scale=1.0),
        "final_norm": norm_spec(cfg),
        "units": {"b0": _block_spec(cfg, cfg.n_units)},
    }
    if not cfg.tie_embeddings:
        tree["head"] = spec((d, vp), (None, "vocab"))
    return tree


def model_init(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Random parameters by the reference's init law, drawn on ``device``
    (default the CUDA card; raises without one) from ``generator``, a
    generator of that device."""
    return init_params(abstract_params(cfg), generator, cfg.torch_dtype,
                       resolve_device(device))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _layers(tree, n: int):
    """The ``n`` layers of a stacked parameter tree, as views by
    ``unbind``: its backward stacks the layers' gradients once, where a
    view per layer (:func:`_layer`) adds a zero-filled stacked gradient
    per layer."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _block_apply(cfg, p, x, positions, *, window, return_cache, cache_len):
    h = apply_norm(cfg, p["norm1"], x)
    out = A.gqa_apply(cfg, p["attn"], h, positions, window=window,
                      return_cache=return_cache, cache_len=cache_len)
    cache = None
    if return_cache:
        out, cache = out
    x = x + out
    x = x + mlp_apply(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
    return x, cache


def _logits(cfg: ArchConfig, params, x):
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["head"]


def _unit(cfg, p, x, positions, window):
    return _block_apply(cfg, p, x, positions, window=window,
                        return_cache=False, cache_len=0)[0]


def forward(cfg: ArchConfig, params: Dict, tokens, *, remat: bool = True,
            return_cache: bool = False, cache_len: int = 0,
            window_override: Optional[int] = None):
    """Full-sequence forward -> (logits, aux_loss[, cache]).

    tokens: (B, S) int64. With ``return_cache`` the per-layer KV caches,
    stacked on a leading layer axis and sized to ``cache_len`` (default S),
    are returned too: this is the prefill path. aux_loss is 0 (no MoE).
    With gradients enabled and ``remat`` set (and no cache), each unit is
    rematerialised in the backward (``checkpoint``, non-reentrant): only
    its input is kept, and the unit's forward, the attention kernel
    included, runs again. With gradients off ``remat`` changes nothing.
    """
    require_supported(cfg)
    s = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device)
    window = cfg.window if window_override is None else window_override
    rematerialise = remat and not return_cache and torch.is_grad_enabled()
    caches = []
    for p in _layers(params["units"]["b0"], cfg.n_units):
        if rematerialise:
            # the forward draws no random numbers: no RNG state to replay
            x, c = checkpoint(_unit, cfg, p, x, positions, window,
                              use_reentrant=False,
                              preserve_rng_state=False), None
        else:
            x, c = _block_apply(cfg, p, x, positions, window=window,
                                return_cache=return_cache,
                                cache_len=cache_len)
        caches.append(c)
    logits = _logits(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not return_cache:
        return logits, aux
    cache = {"units": {"b0": {
        k: torch.stack([c[k] for c in caches]) for k in ("k", "v")}}}
    return logits, aux, cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               window_override: Optional[int] = None):
    """TensorSpec cache tree (:func:`materialize_cache` allocates it)."""
    require_supported(cfg)
    window = cfg.window if window_override is None else window_override
    return {"units": {"b0": A.gqa_cache_spec(cfg, batch, max_len,
                                             cfg.n_units, window=window)}}


def materialize_cache(cfg: ArchConfig, batch: int, max_len: int,
                      window_override: Optional[int] = None, device=None):
    """A zero cache of :func:`init_cache`'s shapes on ``device`` (default
    the CUDA card; raises without one)."""
    tree = init_cache(cfg, batch, max_len, window_override)
    device = resolve_device(device)
    return {"units": {"b0": {
        k: torch.zeros(ts.shape, dtype=ts.dtype, device=device)
        for k, ts in tree["units"]["b0"].items()}}}


def decode_step(cfg: ArchConfig, params: Dict, cache, tokens, pos: int, *,
                window_override: Optional[int] = None):
    """One-token decode. tokens: (B, 1) int64, pos: int position.

    Returns (logits (B, 1, V), cache); the cache is updated in place.
    """
    x = params["embed"][tokens]
    window = cfg.window if window_override is None else window_override
    units, unit_cache = params["units"]["b0"], cache["units"]["b0"]
    for i in range(cfg.n_units):
        p = _layer(units, i)
        h = apply_norm(cfg, p["norm1"], x)
        out, _ = A.gqa_decode(cfg, p["attn"], h, _layer(unit_cache, i), pos,
                              window=window)
        x = x + out
        x = x + mlp_apply(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
    return _logits(cfg, params, x), cache
