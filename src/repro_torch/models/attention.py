"""Attention blocks: GQA and MLA (latent KV compression, minicpm3-style),
full-sequence (train/prefill) and one-token decode over a cache, and
whisper's cross-attention. The port of ``repro.models.attention``.

``sdpa`` takes the flash-attention kernel (``repro_torch.kernels.swa``) for
causal attention on a CUDA tensor, as the reference takes its Pallas kernel
for causal attention on the TPU. On the CPU it follows the reference's
dispatch: a blocked online-softmax scan over KV blocks above
``BLOCK_THRESHOLD`` query rows, materialised scores below it. Non-causal
attention (whisper's encoder and cross-attention) takes materialised,
unmasked scores on every device (:func:`_full_attention`), as the
reference's does: the kernel is causal only. K and V may come with fewer
heads than q (the kernel maps heads; the plain paths repeat them), so
``gqa_apply`` hands them over un-repeated. A head width the kernel is not
instantiated for (the reduced MLA config's 48) is zero-padded up to the
next one it is, with q scaled so that the kernel's 1 / sqrt(width) is the
reference's.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as Fn

from ..kernels.swa.ops import swa_op
from ..kernels.swa.kernel import HEAD_WIDTHS
from .common import ArchConfig, apply_rope, rms_norm, spec

BLOCK_THRESHOLD = 8192
KV_BLOCK = 1024
NEG_INF = -2.0e38


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor to be allocated (a cache leaf)."""
    shape: tuple
    dtype: torch.dtype


# ------------------------------------------------------------------- specs
def gqa_spec(cfg: ArchConfig, stack: int = 0):
    hd = cfg.hd
    st = (stack,) if stack else ()
    sa = (None,) if stack else ()
    p = {
        "wq": spec(st + (cfg.d_model, cfg.n_heads * hd), sa + (None, "model")),
        "wk": spec(st + (cfg.d_model, cfg.n_kv_heads * hd), sa + (None, "model")),
        "wv": spec(st + (cfg.d_model, cfg.n_kv_heads * hd), sa + (None, "model")),
        "wo": spec(st + (cfg.n_heads * hd, cfg.d_model), sa + ("model", None)),
    }
    if cfg.qk_norm:
        p["q_norm"] = spec(st + (hd,), sa + (None,), init="ones",
                           dtype=torch.float32)
        p["k_norm"] = spec(st + (hd,), sa + (None,), init="ones",
                           dtype=torch.float32)
    return p


def mla_spec(cfg: ArchConfig, stack: int = 0):
    st = (stack,) if stack else ()
    sa = (None,) if stack else ()
    qk_hd = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq_a": spec(st + (cfg.d_model, cfg.q_lora_rank), sa + (None, None)),
        "q_a_norm": spec(st + (cfg.q_lora_rank,), sa + (None,), init="ones",
                         dtype=torch.float32),
        "wq_b": spec(st + (cfg.q_lora_rank, cfg.n_heads * qk_hd),
                     sa + (None, "model")),
        "wkv_a": spec(st + (cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim),
                      sa + (None, None)),
        "kv_a_norm": spec(st + (cfg.kv_lora_rank,), sa + (None,), init="ones",
                          dtype=torch.float32),
        "wkv_b": spec(st + (cfg.kv_lora_rank,
                            cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)),
                      sa + (None, "model")),
        "wo": spec(st + (cfg.n_heads * cfg.v_head_dim, cfg.d_model),
                   sa + ("model", None)),
    }


def cross_spec(cfg: ArchConfig, stack: int = 0):
    return gqa_spec(cfg, stack)


# ---------------------------------------------------------------- core math
def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, kh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(
        b, s, kh * n_rep, d)


def _plain_attention(q, k, v, *, window: int):
    """Materialised-score causal attention. q (B,Sq,H,D), k/v (B,Sk,H,D)."""
    sq, d = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) \
        * (1.0 / math.sqrt(d))
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _full_attention(q, k, v):
    """Materialised-score attention with no mask: every query attends to
    every key. q (B,Sq,H,D), k/v (B,Sk,H,D); Sq and Sk may differ."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) \
        * (1.0 / math.sqrt(q.shape[3]))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _blocked_attention(q, k, v, *, window: int):
    """Flash-style causal online-softmax loop over KV blocks; O(KV_BLOCK)
    memory, equal to :func:`_plain_attention`."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, KV_BLOCK):
        kblk, vblk = k[:, k0:k0 + KV_BLOCK], v[:, k0:k0 + KV_BLOCK]
        kpos = torch.arange(k0, k0 + kblk.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kblk).to(torch.float32) * scale
        mask = kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask[None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p.to(q.dtype), vblk).to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _kernel_attention(q, k, v, *, window: int):
    """The flash-attention kernel (its plain version on a CPU tensor), at
    the narrowest instantiated head width at least q's: a narrower width is
    zero-padded, with q scaled by sqrt(padded / d) so the kernel's
    1 / sqrt(padded) scale gives the reference's 1 / sqrt(d)."""
    d = q.shape[-1]
    dp = min((w for w in HEAD_WIDTHS if w >= d), default=d)
    if dp == d:
        return swa_op(q, k, v, window=window)
    pad = (0, dp - d)
    out = swa_op(Fn.pad(q * math.sqrt(dp / d), pad), Fn.pad(k, pad),
                 Fn.pad(v, pad), window=window)
    return out[..., :d]


def sdpa(q, k, v, *, causal: bool = True, window: int = 0,
         force_blocked: Optional[bool] = None):
    """Attention dispatch. q (B,Sq,H,D); k, v (B,Sk,KH,D), H % KH == 0.

    Causal (Sq == Sk): a CUDA tensor runs the flash-attention kernel; a CPU
    tensor the blocked scan for long sequences, materialised scores for
    short ones. Not causal: materialised, unmasked scores on every device
    (the reference's non-causal callers all force that path), with no
    window. K and V are repeated to H heads for every plain path.
    """
    if not causal:
        if window or force_blocked:
            raise ValueError("non-causal attention takes materialised "
                             "scores with no window")
    elif q.is_cuda:
        return _kernel_attention(q, k, v, window=window)
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if not causal:
        return _full_attention(q, k, v)
    blocked = (q.shape[1] > BLOCK_THRESHOLD if force_blocked is None
               else force_blocked)
    if blocked:
        return _blocked_attention(q, k, v, window=window)
    return _plain_attention(q, k, v, window=window)


# --------------------------------------------------------------- GQA block
def _cache_from_seq(k, v, cache_len: int, window: int, kh: int):
    """Arrange full-sequence K/V (B, S, kv, hd) into the decode cache layout.

    Full attention: first S slots of a (B, cache_len) buffer. Sliding window:
    ring buffer of size min(window, cache_len) with slot = pos % eff_len.
    """
    s = k.shape[1]
    k = _repeat_kv(k, kh // k.shape[2])
    v = _repeat_kv(v, kh // v.shape[2])
    eff = min(window, cache_len) if window else cache_len
    if window and s >= eff:
        shift = (s - eff) % eff
        k_c = torch.roll(k[:, s - eff:], shift, dims=1)
        v_c = torch.roll(v[:, s - eff:], shift, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, eff - s)
        k_c = torch.nn.functional.pad(k, pad)
        v_c = torch.nn.functional.pad(v, pad)
    return {"k": k_c, "v": v_c}


def _qkv(cfg: ArchConfig, p: Dict, x, positions):
    """Projected, normed and rotated q (B,S,H,hd), k and v (B,S,KV,hd)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_apply(cfg: ArchConfig, p: Dict, x, positions, *,
              window: Optional[int] = None, return_cache: bool = False,
              cache_len: int = 0):
    """Full-sequence GQA attention (train/prefill). x: (B, S, d_model)."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    w = cfg.window if window is None else window
    cache = None
    if return_cache:
        cache = _cache_from_seq(k, v, cache_len or s, w, _cache_heads(cfg))
    out = sdpa(q, k, v, window=w)
    out = out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]
    return (out, cache) if return_cache else out


def gqa_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                   stack: int = 0, window: int = 0):
    """KV cache specs: (stack, batch, eff_len, cache heads, hd) for k and v,
    eff_len = min(max_len, window) with a window."""
    eff_len = min(max_len, window) if window else max_len
    st = (stack,) if stack else ()
    shape = st + (batch, eff_len, _cache_heads(cfg), cfg.hd)
    return {"k": TensorSpec(shape, cfg.torch_dtype),
            "v": TensorSpec(shape, cfg.torch_dtype)}


def _cache_heads(cfg: ArchConfig) -> int:
    """KV-cache head count, as the reference chooses it: the smallest
    multiple of n_kv_heads that divides n_heads and is divisible by 16 (so
    the reference's cache shards over its model axis), else n_kv_heads."""
    kh = cfg.n_kv_heads
    k = kh
    while k <= cfg.n_heads:
        if cfg.n_heads % k == 0 and k % 16 == 0:
            return k
        k += kh
    return kh


def gqa_decode(cfg: ArchConfig, p: Dict, x, cache: Dict, pos: int, *,
               window: int = 0):
    """One-token decode with a KV cache. x: (B, 1, d); pos: int position.

    Writes the new K/V into ``cache`` in place (the reference returns an
    updated copy; in place saves a cache-sized copy per layer and step) and
    returns (out, cache).
    """
    b = x.shape[0]
    hd = cfg.hd
    q, k, v = _qkv(cfg, p, x, torch.full((1,), pos, device=x.device))
    kh = _cache_heads(cfg)
    k = _repeat_kv(k, kh // cfg.n_kv_heads)
    v = _repeat_kv(v, kh // cfg.n_kv_heads)
    eff_len = cache["k"].shape[1]
    slot = pos % eff_len if window else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    kpos = torch.arange(eff_len, device=x.device)
    if window:
        valid = (kpos <= slot) | (pos >= eff_len)   # ring buffer full => all
    else:
        valid = kpos <= pos
    # grouped-query form: KV heads are never repeated for the scores
    qg = q.reshape(b, 1, kh, cfg.n_heads // kh, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, cache["k"]).to(torch.float32)
    s = s * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~valid[None, None, None, None, :], NEG_INF)
    probs = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cache["v"])
    out = out.reshape(b, 1, cfg.n_heads * hd) @ p["wo"]
    return out, cache


# --------------------------------------------------------------- MLA block
def mla_apply(cfg: ArchConfig, p: Dict, x, positions, *,
              return_cache: bool = False, cache_len: int = 0):
    """Multi-head Latent Attention, full-sequence path. x: (B, S, d).

    The cache holds the compressed latent, un-normalised, beside the rotated
    shared rope key. Attention runs at head width nope + rope, with V
    zero-padded to it and sliced back, as the reference does."""
    b, s, _ = x.shape
    nh, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    q = rms_norm(x @ p["wq_a"], p["q_a_norm"]) @ p["wq_b"]
    q = q.reshape(b, s, nh, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv_a = x @ p["wkv_a"]                                  # (B,S,rank+dr)
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora_rank], p["kv_a_norm"])
    k_rope = kv_a[..., cfg.kv_lora_rank:][:, :, None, :]   # shared by heads
    kv = (c_kv @ p["wkv_b"]).reshape(b, s, nh, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    cache = None
    if return_cache:
        entry = torch.cat([kv_a[..., :cfg.kv_lora_rank], k_rope[:, :, 0, :]],
                          dim=-1)
        cache = {"ckv": Fn.pad(entry, (0, 0, 0, (cache_len or s) - s))}
    k_rope = k_rope.expand(b, s, nh, dr)
    q_full = torch.cat([q_nope, q_rope], -1)
    k_full = torch.cat([k_nope, k_rope], -1)
    v_p = Fn.pad(v, (0, dn + dr - dv)) if dv < dn + dr else v
    out = sdpa(q_full, k_full, v_p, window=cfg.window)
    out = out[..., :dv].reshape(b, s, nh * dv) @ p["wo"]
    return (out, cache) if return_cache else out


def mla_cache_spec(cfg: ArchConfig, batch: int, max_len: int, stack: int = 0):
    """The compressed latent (kv_lora_rank + rope dims) per position."""
    st = (stack,) if stack else ()
    shape = st + (batch, max_len, cfg.kv_lora_rank + cfg.qk_rope_dim)
    return {"ckv": TensorSpec(shape, cfg.torch_dtype)}


def mla_decode(cfg: ArchConfig, p: Dict, x, cache: Dict, pos: int):
    """One-token MLA decode from the compressed cache, written in place:
    every step re-normalises the whole latent and expands it through
    ``wkv_b``, as the reference does (no weight absorption)."""
    b = x.shape[0]
    nh, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    rank = cfg.kv_lora_rank
    q = rms_norm(x @ p["wq_a"], p["q_a_norm"]) @ p["wq_b"]
    q = q.reshape(b, 1, nh, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv_a = x @ p["wkv_a"]                                   # (B,1,rank+dr)
    pp = torch.full((1,), pos, device=x.device)
    q_rope = apply_rope(q_rope, pp, cfg.rope_theta)
    kr_new = apply_rope(kv_a[:, :, None, rank:], pp, cfg.rope_theta)
    ckv = cache["ckv"]
    ckv[:, pos] = torch.cat([kv_a[:, 0, :rank], kr_new[:, 0, 0]], -1) \
        .to(ckv.dtype)
    c_all = rms_norm(ckv[..., :rank], p["kv_a_norm"])       # (B,T,rank)
    kr_all = ckv[..., rank:]                                # (B,T,dr)
    kv = (c_all @ p["wkv_b"]).reshape(b, -1, nh, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    s = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
         + torch.einsum("bqhd,bkd->bhqk", q_rope, kr_all)).to(torch.float32)
    s = s / math.sqrt(dn + dr)
    s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    probs = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, 1, nh * dv)
    return out @ p["wo"], cache


# ------------------------------------------------------- cross attn (enc-dec)
def cross_apply(cfg: ArchConfig, p: Dict, x, enc_out):
    """Cross-attention: queries from the decoder's x (B, S, d), keys and
    values from ``enc_out`` (B, Se, d), every query on every frame. K and V
    are projected from ``enc_out`` at every call, a decode step's too (no
    cross-KV cache, as in the reference)."""
    b, s, _ = x.shape
    se = enc_out.shape[1]
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (enc_out @ p["wk"]).reshape(b, se, cfg.n_kv_heads, hd)
    v = (enc_out @ p["wv"]).reshape(b, se, cfg.n_kv_heads, hd)
    out = sdpa(q, k, v, causal=False)
    return out.reshape(b, s, cfg.n_heads * hd) @ p["wo"]
