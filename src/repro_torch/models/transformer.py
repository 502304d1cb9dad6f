"""Model composition: the block registry for attention blocks (GQA or MLA
attention with a dense MLP, ``"attn"``; GQA attention with sparse experts,
``"attn_moe"``), the RG-LRU recurrent block with a dense MLP (``"rec"``),
the xLSTM blocks, mLSTM (``"m"``) and sLSTM (``"s"``), each a pre-norm
residual with no MLP of its own, and whisper's decoder block (``"xattn"``:
causal self-attention, cross-attention on the encoder's output, a GELU
MLP) over an encoder of ``"enc"`` blocks (non-causal self-attention and
the MLP); learned positions; parameters, full-sequence forward (the
prefill path), the caches and the one-token decode step. The port of
``repro.models.transformer``.

Layers are grouped into repeating units (the config's ``pattern``); each
pattern slot ``b{slot}`` has parameters stacked on a leading unit axis, and
remainder layers ``r{r}`` (depth % pattern) are unstacked, as in the
reference. A Python loop over units takes the place of ``lax.scan``; with
gradients on, ``remat`` wraps each unit in ``torch.utils.checkpoint`` as
the reference wraps its scan body in ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import attention as A
from . import moe as M
from . import ssm as S
from . import xlstm as X
from .common import (ArchConfig, apply_norm, init_params, mlp_apply,
                     mlp_spec, norm_spec, spec)

#: the block kinds a config's pattern may name (the encoder's ``"enc"``
#: blocks come with ``enc_dec``)
KINDS = ("attn", "attn_moe", "rec", "m", "s", "xattn")
#: rows of the decoder's learned position table; a position past them
#: takes row ``pos % POS_ROWS``, as in the reference
POS_ROWS = 4096


def require_supported(cfg: ArchConfig) -> None:
    """Raise ValueError unless ``cfg`` names blocks the model runs: known
    kinds, a known attention and position kind, and cross-attention only
    over an encoder."""
    bad = []
    other = sorted(set(cfg.pattern) - set(KINDS))
    if other:
        bad.append(f"block kinds {other} (known: {', '.join(KINDS)})")
    if cfg.attn_kind not in ("gqa", "mla"):
        bad.append(f"attn_kind={cfg.attn_kind!r}")
    if cfg.pos_emb not in ("rope", "none", "learned"):
        bad.append(f"pos_emb={cfg.pos_emb!r}")
    if "xattn" in cfg.pattern and not cfg.enc_dec:
        bad.append("xattn blocks without an encoder (enc_dec=False)")
    if bad:
        raise ValueError(f"{cfg.arch_id}: {'; '.join(bad)}")


def _stack(tree, stack: int):
    if not stack:
        return tree
    return {k: spec((stack,) + v.shape, (None,) + v.axes, v.init, v.scale,
                    v.dtype) for k, v in tree.items()}


def _block_spec(cfg: ArchConfig, kind: str, stack: int):
    # the xLSTM blocks carry their own projections: no norm2, no MLP
    if kind == "m":
        return {"norm1": norm_spec(cfg, stack),
                "mix": X.mlstm_spec(cfg, stack)}
    if kind == "s":
        return {"norm1": norm_spec(cfg, stack),
                "mix": X.slstm_spec(cfg, stack)}
    p = {"norm1": norm_spec(cfg, stack), "norm2": norm_spec(cfg, stack)}
    if kind == "rec":
        p["rec"] = S.rglru_spec(cfg, stack)
        p["mlp"] = _stack(mlp_spec(cfg), stack)
        return p
    if kind == "attn_moe":
        p["attn"] = A.gqa_spec(cfg, stack)
        p["moe"] = M.moe_spec(cfg, stack)
        return p
    if kind == "xattn":
        p["norm3"] = norm_spec(cfg, stack)
        p["cross"] = A.cross_spec(cfg, stack)
    p["attn"] = (A.mla_spec(cfg, stack) if cfg.attn_kind == "mla"
                 else A.gqa_spec(cfg, stack))
    p["mlp"] = _stack(mlp_spec(cfg), stack)
    return p


def abstract_params(cfg: ArchConfig):
    """Full model ParamSpec tree, in the reference's layout."""
    require_supported(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab
    tree: Dict[str, Any] = {
        "embed": spec((vp, d), ("vocab", None), scale=1.0),
        "final_norm": norm_spec(cfg),
        "units": {f"b{slot}": _block_spec(cfg, kind, cfg.n_units)
                  for slot, kind in enumerate(cfg.pattern)},
    }
    if not cfg.tie_embeddings:
        tree["head"] = spec((d, vp), (None, "vocab"))
    if cfg.n_rem_layers:
        tree["rem"] = {f"r{r}": _block_spec(cfg, _rem_kind(cfg, r), 0)
                       for r in range(cfg.n_rem_layers)}
    if cfg.pos_emb == "learned":
        # 4096 rows, as the reference sizes it (whisper's own is 448)
        tree["pos_table"] = spec((POS_ROWS, d), (None, None))
    if cfg.enc_dec:
        tree["encoder"] = {
            "pos_table": spec((cfg.n_frames, d), (None, None)),
            "layers": _block_spec(cfg, "enc", cfg.n_enc_layers),
            "final_norm": norm_spec(cfg),
        }
    return tree


def _rem_kind(cfg: ArchConfig, r: int) -> str:
    return cfg.pattern[r % len(cfg.pattern)]


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


def _block_apply(cfg, kind, p, x, positions, *, window, return_cache,
                 cache_len, enc_out=None):
    """Full-sequence block. Returns (x, aux loss, cache|None); the aux
    loss is a float32 scalar tensor for an expert block, else 0.0.
    ``enc_out`` is the encoder's output for an ``"xattn"`` block."""
    h = apply_norm(cfg, p["norm1"], x)
    if kind in ("m", "s"):
        mix = X.mlstm_apply if kind == "m" else X.slstm_apply
        out = mix(cfg, p["mix"], h, return_cache=return_cache)
        out, cache = out if return_cache else (out, None)
        return x + out, 0.0, cache
    if kind == "rec":
        out = S.rglru_apply(cfg, p["rec"], h, return_cache=return_cache)
        cache = None
        if return_cache:
            out, cache = out
        x = x + out
        return (x + mlp_apply(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x)),
                0.0, cache)
    if kind == "enc":
        # non-causal self-attention: the frames attend to one another
        x = x + A.cross_apply(cfg, p["attn"], h, h)
        return (x + mlp_apply(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x)),
                0.0, None)
    if cfg.attn_kind == "mla":
        out = A.mla_apply(cfg, p["attn"], h, positions,
                          return_cache=return_cache, cache_len=cache_len)
    else:
        out = A.gqa_apply(cfg, p["attn"], h, positions, window=window,
                          return_cache=return_cache, cache_len=cache_len)
    cache = None
    if return_cache:
        out, cache = out
    x = x + out
    h = apply_norm(cfg, p["norm2"], x)
    if kind == "attn_moe":
        out, aux = M.moe_apply(cfg, p["moe"], h)
        return x + out, aux, cache
    if kind == "xattn":
        x = x + A.cross_apply(cfg, p["cross"], h, enc_out)
        h = apply_norm(cfg, p["norm3"], x)
    return x + mlp_apply(cfg, p["mlp"], h), 0.0, cache


def _block_decode(cfg, kind, p, x, cache, pos: int, *, window,
                  enc_out=None):
    h = apply_norm(cfg, p["norm1"], x)
    if kind in ("m", "s"):
        mix = X.mlstm_decode if kind == "m" else X.slstm_decode
        return x + mix(cfg, p["mix"], h, cache)[0]
    if kind == "rec":
        x = x + S.rglru_decode(cfg, p["rec"], h, cache)[0]
        return x + mlp_apply(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
    if cfg.attn_kind == "mla":
        out, cache = A.mla_decode(cfg, p["attn"], h, cache, pos)
    else:
        out, cache = A.gqa_decode(cfg, p["attn"], h, cache, pos,
                                  window=window)
    x = x + out
    h = apply_norm(cfg, p["norm2"], x)
    if kind == "attn_moe":
        return x + M.moe_apply(cfg, p["moe"], h)[0]
    if kind == "xattn":
        x = x + A.cross_apply(cfg, p["cross"], h, enc_out)
        h = apply_norm(cfg, p["norm3"], x)
    return x + mlp_apply(cfg, p["mlp"], h)


def _block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                 stack: int, window: int):
    if kind == "m":
        return X.mlstm_cache_spec(cfg, batch, stack)
    if kind == "s":
        return X.slstm_cache_spec(cfg, batch, stack)
    if kind == "rec":
        return S.rglru_cache_spec(cfg, batch, stack)
    if cfg.attn_kind == "mla":
        return A.mla_cache_spec(cfg, batch, max_len, stack)
    return A.gqa_cache_spec(cfg, batch, max_len, stack, window=window)


def _logits(cfg: ArchConfig, params, x):
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["head"]


def _unit(cfg, p, x, positions, window, enc_out=None, return_cache=False,
          cache_len=0):
    """One unit: the pattern's blocks in order -> (x, aux, {slot: cache})."""
    aux, caches = 0.0, {}
    for slot, kind in enumerate(cfg.pattern):
        x, a, caches[f"b{slot}"] = _block_apply(
            cfg, kind, p[f"b{slot}"], x, positions, window=window,
            return_cache=return_cache, cache_len=cache_len, enc_out=enc_out)
        aux = aux + a
    return x, aux, caches


def _remat_unit(cfg, p, x, positions, window, enc_out):
    return _unit(cfg, p, x, positions, window, enc_out)[:2]


def _stack_caches(caches):
    """Per-unit {slot: {key: tensor}} -> {slot: {key: stacked tensor}}."""
    return {slot: {k: torch.stack([c[slot][k] for c in caches])
                   for k in caches[0][slot]} for slot in caches[0]}


def _learned_positions(params, x, positions):
    """x plus the decoder's learned rows at ``positions % POS_ROWS``."""
    tbl = params["pos_table"]
    return x + tbl[positions % tbl.shape[0]].to(x.dtype)


def encode(cfg: ArchConfig, params: Dict, frames):
    """The encoder over precomputed frame embeddings ``frames`` (B, F, d)
    in the parameters' type, F <= n_frames (no conv/mel frontend, as in
    the reference): learned positions ``pos_table[:F]``, the ``"enc"``
    layers and a final norm -> (B, F, d)."""
    enc = params["encoder"]
    x = frames + enc["pos_table"][:frames.shape[1]].to(frames.dtype)
    for p in _layers(enc["layers"], cfg.n_enc_layers):
        x = _block_apply(cfg, "enc", p, x, None, window=0,
                         return_cache=False, cache_len=0)[0]
    return apply_norm(cfg, enc["final_norm"], x)


def forward(cfg: ArchConfig, params: Dict, tokens, *, enc_frames=None,
            patch_embeds=None, remat: bool = True,
            return_cache: bool = False, cache_len: int = 0,
            window_override: Optional[int] = None):
    """Full-sequence forward -> (logits, aux_loss[, cache]).

    tokens: (B, S) int64. ``patch_embeds`` (B, n_patches, d), for a config
    with ``n_patches``, replaces the first n_patches embedding rows (early
    fusion). ``enc_frames`` (B, F, d), required for an ``enc_dec`` config,
    goes through :func:`encode` once, and every ``"xattn"`` block attends
    to its output. With ``return_cache`` the per-layer caches (KV, MLA's
    latent, the RG-LRU's state and conv history, the mLSTM's (C, n, m)
    and conv history, or the sLSTM's (c, n, m, h)), stacked on a leading
    unit axis per pattern slot and sized to ``cache_len`` (default S), are
    returned too: this is the prefill path.
    aux_loss is the experts' load-balance loss summed over layers in
    float32 (0 without experts). With gradients enabled and ``remat`` set
    (and no cache), each unit is rematerialised in the backward
    (``checkpoint``, non-reentrant): only its input is kept, and the unit's
    forward, the attention kernel included, runs again. With gradients off
    ``remat`` changes nothing.
    """
    require_supported(cfg)
    s = tokens.shape[1]
    x = params["embed"][tokens]
    if patch_embeds is not None and cfg.n_patches:
        npch = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, npch:]], dim=1)
    positions = torch.arange(s, device=tokens.device)
    if cfg.pos_emb == "learned":
        x = _learned_positions(params, x, positions)
    enc_out = None
    if cfg.enc_dec:
        if enc_frames is None:
            raise ValueError(f"{cfg.arch_id} is an encoder-decoder: forward "
                             f"needs enc_frames")
        enc_out = encode(cfg, params, enc_frames)
    window = cfg.window if window_override is None else window_override
    rematerialise = remat and not return_cache and torch.is_grad_enabled()
    aux, caches = 0.0, []
    for p in _layers(params["units"], cfg.n_units):
        if rematerialise:
            # the forward draws no random numbers: no RNG state to replay
            x, a = checkpoint(_remat_unit, cfg, p, x, positions, window,
                              enc_out, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a, c = _unit(cfg, p, x, positions, window, enc_out,
                            return_cache=return_cache, cache_len=cache_len)
            caches.append(c)
        aux = aux + a
    rem = {}
    for r in range(cfg.n_rem_layers):
        x, a, rem[f"r{r}"] = _block_apply(
            cfg, _rem_kind(cfg, r), params["rem"][f"r{r}"], x, positions,
            window=window, return_cache=return_cache, cache_len=cache_len,
            enc_out=enc_out)
        aux = aux + a
    logits = _logits(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device) + aux
    if not return_cache:
        return logits, aux
    cache = {"units": _stack_caches(caches)}
    if rem:
        cache["rem"] = rem
    return logits, aux, cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               window_override: Optional[int] = None):
    """TensorSpec cache tree (:func:`materialize_cache` allocates it)."""
    require_supported(cfg)
    window = cfg.window if window_override is None else window_override
    tree: Dict[str, Any] = {"units": {
        f"b{slot}": _block_cache(cfg, kind, batch, max_len, cfg.n_units,
                                 window)
        for slot, kind in enumerate(cfg.pattern)}}
    if cfg.n_rem_layers:
        tree["rem"] = {f"r{r}": _block_cache(cfg, _rem_kind(cfg, r), batch,
                                             max_len, 0, window)
                       for r in range(cfg.n_rem_layers)}
    return tree


def materialize_cache(cfg: ArchConfig, batch: int, max_len: int,
                      window_override: Optional[int] = None, device=None):
    """A zero cache of :func:`init_cache`'s shapes on ``device`` (default
    the CUDA card; raises without one)."""
    tree = init_cache(cfg, batch, max_len, window_override)
    device = resolve_device(device)

    def zeros(node):
        if isinstance(node, dict):
            return {k: zeros(v) for k, v in node.items()}
        return torch.zeros(node.shape, dtype=node.dtype, device=device)
    return zeros(tree)


def decode_step(cfg: ArchConfig, params: Dict, cache, tokens, pos: int, *,
                enc_out=None, window_override: Optional[int] = None):
    """One-token decode. tokens: (B, 1) int64, pos: int position.
    ``enc_out`` (B, F, d), :func:`encode`'s output, is required for an
    ``enc_dec`` config: cross-attention projects its K and V anew every
    step, as the reference does.

    Returns (logits (B, 1, V), cache); the cache is updated in place.
    """
    if cfg.enc_dec and enc_out is None:
        raise ValueError(f"{cfg.arch_id} is an encoder-decoder: decode_step "
                         f"needs enc_out")
    x = params["embed"][tokens]
    if cfg.pos_emb == "learned":
        x = _learned_positions(
            params, x, torch.full((1,), pos, device=tokens.device))
    window = cfg.window if window_override is None else window_override
    units, unit_cache = params["units"], cache["units"]
    for i in range(cfg.n_units):
        p, c = _layer(units, i), _layer(unit_cache, i)
        for slot, kind in enumerate(cfg.pattern):
            x = _block_decode(cfg, kind, p[f"b{slot}"], x, c[f"b{slot}"],
                              pos, window=window, enc_out=enc_out)
    for r in range(cfg.n_rem_layers):
        x = _block_decode(cfg, _rem_kind(cfg, r), params["rem"][f"r{r}"], x,
                          cache["rem"][f"r{r}"], pos, window=window,
                          enc_out=enc_out)
    return _logits(cfg, params, x), cache
