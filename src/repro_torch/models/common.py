"""Shared model substrate: configs, parameter specs, norms, RoPE, the MLP.

The port of ``repro.models.common``. Every parameter is described by a
:class:`ParamSpec` (shape, dtype, logical axes, init law); ``init_params``
materialises a spec tree from an explicit ``torch.Generator``. Layers are
stacked (a leading layer axis on every block parameter), as in the
reference, so parameters carry across one to one.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    pattern: Tuple[str, ...] = ("attn",)   # per-layer block types, cycled
    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    # --- attention flavour ---
    attn_kind: str = "gqa"      # gqa | mla
    window: int = 0             # sliding-window size; 0 = full attention
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    # --- MLA (minicpm3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- encoder-decoder / modality stubs ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 0
    n_patches: int = 0
    # --- recurrent / ssm ---
    rglru_width: int = 0
    conv_width: int = 4
    mlstm_heads: int = 0
    proj_factor: float = 2.0
    # --- misc ---
    act: str = "swiglu"         # swiglu | geglu | gelu
    norm: str = "rms"           # rms | layer
    pos_emb: str = "rope"       # rope | learned | none
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    long_variant: str = "swa"   # how long_500k decodes: swa | native | skip
    max_target_len: int = 524_288

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256, as the reference pads it."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_rem_layers(self) -> int:
        return self.n_layers - self.n_units * len(self.pattern)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Abstract parameter: shape, dtype, logical axes and init law.

    ``axes`` names each dimension as the reference does (None, "model",
    "vocab", ...); the port runs on one card and keeps them as labels.
    """
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: Any = None
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0


def spec(shape, axes, init="normal", scale=1.0, dtype=None) -> ParamSpec:
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    return ParamSpec(tuple(shape), tuple(axes), dtype, init, scale)


def _leaves(tree, prefix=()):
    """(path, ParamSpec) pairs of a spec tree, in sorted key order."""
    if isinstance(tree, ParamSpec):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from _leaves(tree[key], prefix + (key,))


def materialize(ps: ParamSpec, generator: torch.Generator, default_dtype,
                device) -> torch.Tensor:
    """One parameter: normals of std ``scale / sqrt(fan_in)`` drawn in
    float32 (fan_in is the second-to-last dimension), or ones, or zeros."""
    dt = ps.dtype or default_dtype
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dt, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dt, device=device)
    fan_in = ps.shape[-2] if len(ps.shape) >= 2 else ps.shape[-1]
    std = ps.scale / math.sqrt(max(fan_in, 1))
    out = torch.randn(ps.shape, generator=generator, dtype=torch.float32,
                      device=device)
    return out.mul_(std).to(dt)


def init_params(tree, generator: torch.Generator, default_dtype, device=None):
    """Materialise a ParamSpec tree on ``device``, leaves in sorted key order
    from one generator (which must live on that device)."""
    out: Dict[str, Any] = {}
    for path, ps in _leaves(tree):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = materialize(ps, generator, default_dtype, device)
    return out


# -------------------------------------------------------------------- norms
def rms_norm(x, gamma, eps=1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def layer_norm(x, gamma, beta, eps=1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def apply_norm(cfg: ArchConfig, p: Dict, x):
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_spec(cfg: ArchConfig, stack: int = 0):
    shape = (cfg.d_model,) if not stack else (stack, cfg.d_model)
    axes = (None,) if not stack else (None, None)
    out = {"scale": spec(shape, axes, init="ones", dtype=torch.float32)}
    if cfg.norm == "layer":
        out["bias"] = spec(shape, axes, init="zeros", dtype=torch.float32)
    return out


# --------------------------------------------------------------------- rope
def rope_freqs(hd: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(hd: int, theta: float, device: torch.device):
    """:func:`rope_freqs` as a tensor on ``device``, copied there once: a
    host-to-device copy per call would synchronise every decode step."""
    return torch.as_tensor(rope_freqs(hd, theta), device=device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) rotated by position; positions (..., S)."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., S, D/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- activations
def act_fn(cfg: ArchConfig, gate, up):
    if cfg.act == "swiglu":
        return Fn.silu(gate) * up
    if cfg.act == "geglu":
        return Fn.gelu(gate, approximate="tanh") * up   # jax.nn.gelu's default
    raise ValueError(cfg.act)


def mlp_spec(cfg: ArchConfig, d_ff: int = 0):
    d_ff = d_ff or cfg.d_ff
    if cfg.act == "gelu":
        return {"w_in": spec((cfg.d_model, d_ff), (None, "model")),
                "w_out": spec((d_ff, cfg.d_model), ("model", None))}
    return {"w_gate": spec((cfg.d_model, d_ff), (None, "model")),
            "w_up": spec((cfg.d_model, d_ff), (None, "model")),
            "w_out": spec((d_ff, cfg.d_model), ("model", None))}


def mlp_apply(cfg: ArchConfig, p: Dict, x):
    if cfg.act == "gelu":
        return Fn.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]
    return act_fn(cfg, x @ p["w_gate"], x @ p["w_up"]) @ p["w_out"]
