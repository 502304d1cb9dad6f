"""xLSTM blocks (arXiv:2405.04517): the chunkwise-parallel mLSTM (matrix
memory, exponential gating) and the sequential sLSTM (scalar memory,
recurrent h). The port of ``repro.models.xlstm``.

The mLSTM carries its stabilised state (C, n, m) in float32 across chunks
of ``MLSTM_CHUNK`` positions: within a chunk the work is a few batched
products, across chunks a Python loop takes the place of the reference's
``lax.scan``. The sLSTM's input projection is one product hoisted out of
its position loop, which takes the place of the second ``lax.scan``; the
recurrence itself runs one position at a time. Decode is one step of
either recurrence, and writes the new state into the cache in place.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as Fn

from .attention import TensorSpec
from .common import ArchConfig, rms_norm, spec
from .ssm import _causal_depthwise_conv

MLSTM_CHUNK = 256


# ------------------------------------------------------------------ mLSTM
def _mlstm_dims(cfg: ArchConfig):
    """(du, heads, head width) of the mLSTM block."""
    du = int(cfg.proj_factor * cfg.d_model)
    nh = cfg.mlstm_heads or cfg.n_heads
    return du, nh, du // nh


def mlstm_spec(cfg: ArchConfig, stack: int = 0):
    d = cfg.d_model
    du, nh, _ = _mlstm_dims(cfg)
    st = (stack,) if stack else ()
    sa = (None,) if stack else ()
    return {
        "w_up": spec(st + (d, 2 * du), sa + (None, "model")),
        "conv_k": spec(st + (cfg.conv_width, du), sa + (None, "model"),
                       scale=0.5),
        "w_q": spec(st + (du, du), sa + (None, "model")),
        "w_k": spec(st + (du, du), sa + (None, "model")),
        "w_v": spec(st + (du, du), sa + (None, "model")),
        # float32 whatever the config's type, as in the reference
        "w_if": spec(st + (du, 2 * nh), sa + (None, None), scale=0.3,
                     dtype=torch.float32),
        "skip": spec(st + (du,), sa + (None,), init="ones",
                     dtype=torch.float32),
        "out_norm": spec(st + (du,), sa + (None,), init="ones",
                         dtype=torch.float32),
        "w_down": spec(st + (du, d), sa + ("model", None)),
    }


def _mlstm_chunk_scan(q, k, v, li, lf):
    """Chunkwise stabilised mLSTM.

    q, k, v: (B, H, S, D); li, lf: (B, H, S) float32 log input and forget
    gates. Returns (h (B, H, S, D) float32, (C, n, m)), the state after
    the last position. S must be a multiple of the chunk when it is longer
    than one (the reference asserts the same; nothing pads).
    """
    b, h, s, d = q.shape
    L = min(MLSTM_CHUNK, s)
    if s % L:
        raise ValueError(f"mLSTM length {s} is not a multiple of the chunk "
                         f"{L}")
    nc = s // L
    scale = 1.0 / math.sqrt(d)
    # every operand in float32, as the reference's (a bf16 q times its
    # numpy scale is already float32 there)
    qc = (q.to(torch.float32) * scale).reshape(b, h, nc, L, d)
    kc = k.reshape(b, h, nc, L, d).to(torch.float32)
    vc = v.reshape(b, h, nc, L, d).to(torch.float32)
    lic = li.reshape(b, h, nc, L)
    bc = torch.cumsum(lf.reshape(b, h, nc, L), dim=-1)  # inclusive decay sums
    future = ~torch.tril(torch.ones((L, L), dtype=torch.bool,
                                    device=q.device))

    C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    hs = []
    for c in range(nc):
        qi, ki, vi = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        lii, bi = lic[:, :, c], bc[:, :, c]
        # bi: decay from the chunk's start to position j, f_j included
        m_inter = bi + m[..., None]                          # (B, H, L)
        # intra-chunk log weights D_jk = b_j - b_k + li_k (k <= j)
        Djk = bi[..., :, None] - bi[..., None, :] + lii[..., None, :]
        Djk = Djk.masked_fill(future, -math.inf)
        m_intra = Djk.amax(dim=-1)                           # (B, H, L)
        m_j = torch.maximum(m_inter, m_intra)
        Sjk = (qi @ ki.transpose(-1, -2)) * torch.exp(Djk - m_j[..., None])
        num = Sjk @ vi
        den = Sjk.sum(dim=-1)
        # the contribution of the state carried in
        w_int = torch.exp(m_inter - m_j)                     # (B, H, L)
        num = num + w_int[..., None] * (qi @ C)
        den = den + w_int * (qi @ n[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_j))[..., None])
        # the state at the chunk's end
        btot = bi[..., -1]                                   # (B, H)
        tail = btot[..., None] - bi + lii                    # (B, H, L)
        m_new = torch.maximum(btot + m, tail.amax(dim=-1))
        wk = torch.exp(tail - m_new[..., None])
        carry = torch.exp(btot + m - m_new)
        C = carry[..., None, None] * C \
            + (wk[..., None] * ki).transpose(-1, -2) @ vi
        n = carry[..., None] * n + (wk[..., None] * ki).sum(dim=-2)
        m = m_new
    return torch.stack(hs, dim=2).reshape(b, h, s, d), (C, n, m)


def mlstm_apply(cfg: ArchConfig, p: Dict, x, *, return_cache: bool = False):
    """Full-sequence mLSTM block. x: (B, S, d_model). With
    ``return_cache`` also the decode cache: C, n, m after the last position
    (float32) and the last ``conv_width - 1`` rows of the conv's input in
    the model's type, zero-padded on the left when S is shorter."""
    b, s, _ = x.shape
    du, nh, hd = _mlstm_dims(cfg)
    up = x @ p["w_up"]
    xm, z = up[..., :du], up[..., du:]
    xc = Fn.silu(_causal_depthwise_conv(xm, p["conv_k"]))

    def heads(y):
        return y.reshape(b, s, nh, hd).transpose(1, 2)

    q, k, v = heads(xc @ p["w_q"]), heads(xc @ p["w_k"]), heads(xm @ p["w_v"])
    gif = xc.to(torch.float32) @ p["w_if"]                  # (B, S, 2 nh)
    li = gif[..., :nh].transpose(1, 2)                      # log input gate
    lf = Fn.logsigmoid(gif[..., nh:]).transpose(1, 2)
    h, (C, n, m) = _mlstm_chunk_scan(q, k, v, li, lf)       # (B, H, S, hd)
    h = h.transpose(1, 2).reshape(b, s, du).to(x.dtype)
    h = rms_norm(h, p["out_norm"]) + xc * p["skip"].to(x.dtype)
    out = (h * Fn.silu(z)) @ p["w_down"]
    if not return_cache:
        return out
    w = cfg.conv_width
    hist = xm[:, -(w - 1):, :]
    hist = Fn.pad(hist, (0, 0, (w - 1) - hist.shape[1], 0))
    # a copy, so the cache holds none of the sequence-long tensors
    return out, {"C": C, "n": n, "m": m,
                 "conv": hist.to(cfg.torch_dtype).clone()}


def mlstm_cache_spec(cfg: ArchConfig, batch: int, stack: int = 0):
    du, nh, hd = _mlstm_dims(cfg)
    st = (stack,) if stack else ()
    return {"C": TensorSpec(st + (batch, nh, hd, hd), torch.float32),
            "n": TensorSpec(st + (batch, nh, hd), torch.float32),
            "m": TensorSpec(st + (batch, nh), torch.float32),
            "conv": TensorSpec(st + (batch, cfg.conv_width - 1, du),
                               cfg.torch_dtype)}


def mlstm_decode(cfg: ArchConfig, p: Dict, x, cache: Dict):
    """One-step mLSTM from the (C, n, m) state. x: (B, 1, d). Writes the
    new state and conv history into ``cache`` in place (its leaves may be
    views of a stacked cache) and returns (out, cache)."""
    b = x.shape[0]
    du, nh, hd = _mlstm_dims(cfg)
    up = x @ p["w_up"]
    xm, z = up[..., :du], up[..., du:]
    conv = cache["conv"]
    # a fresh tensor: the new history is copied into the cache's own
    # storage below, which hist[:, 1:] must not overlap
    hist = torch.cat([conv, xm.to(conv.dtype)], dim=1)
    w = p["conv_k"].shape[0]
    xc = Fn.silu(torch.einsum("bwc,wc->bc", hist[:, -w:, :].to(x.dtype),
                              p["conv_k"]))
    q = (xc @ p["w_q"]).reshape(b, nh, hd).to(torch.float32)
    k = (xc @ p["w_k"]).reshape(b, nh, hd).to(torch.float32)
    v = (xm[:, 0] @ p["w_v"]).reshape(b, nh, hd).to(torch.float32)
    gif = xc.to(torch.float32) @ p["w_if"]
    li, lf = gif[..., :nh], Fn.logsigmoid(gif[..., nh:])
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(li - m_new)
    C_new = fp[..., None, None] * C + ip[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = fp[..., None] * n + ip[..., None] * k
    qs = q * (1.0 / math.sqrt(hd))
    num = (qs[..., None, :] @ C_new)[..., 0, :]
    den = (qs * n_new).sum(dim=-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    h = h.reshape(b, du).to(x.dtype)
    h = rms_norm(h, p["out_norm"]) + xc * p["skip"].to(x.dtype)
    out = (h * Fn.silu(z[:, 0]))[:, None, :] @ p["w_down"]
    C.copy_(C_new)
    n.copy_(n_new)
    m.copy_(m_new)
    conv.copy_(hist[:, 1:, :])
    return out, cache


# ------------------------------------------------------------------ sLSTM
def slstm_spec(cfg: ArchConfig, stack: int = 0):
    d = cfg.d_model
    st = (stack,) if stack else ()
    sa = (None,) if stack else ()
    dff = int(d * 4 / 3)
    return {
        "w_gates": spec(st + (d, 4 * d), sa + (None, "model")),
        "r_gates": spec(st + (d, 4 * d), sa + (None, "model"), scale=0.5),
        "out_norm": spec(st + (d,), sa + (None,), init="ones",
                         dtype=torch.float32),
        "ff_gate": spec(st + (d, dff), sa + (None, "model")),
        "ff_up": spec(st + (d, dff), sa + (None, "model")),
        "ff_out": spec(st + (dff, d), sa + ("model", None)),
    }


def _slstm_cell(p: Dict, zx_t, state):
    """zx_t: (B, 4d), the input's gate pre-activations (x_t @ w_gates,
    hoisted out of the position loop). state: (c, n, m, h), float32."""
    c, n, m, h = state
    z4 = zx_t + h.to(zx_t.dtype) @ p["r_gates"]
    zi, zf, zz, zo = z4.to(torch.float32).chunk(4, dim=-1)
    li = zi
    lf = Fn.logsigmoid(zf)
    m_new = torch.maximum(lf + m, li)
    ip = torch.exp(li - m_new)
    fp = torch.exp(lf + m - m_new)
    c_new = fp * c + ip * torch.tanh(zz)
    n_new = fp * n + ip
    h_new = torch.sigmoid(zo) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, m_new, h_new


def _slstm_out(p: Dict, h):
    """The block's output from h (model type): norm, then the GeGLU FFN
    added (jax.nn.gelu's tanh form)."""
    h = rms_norm(h, p["out_norm"])
    ff = (Fn.gelu(h @ p["ff_gate"], approximate="tanh")
          * (h @ p["ff_up"])) @ p["ff_out"]
    return h + ff


def _slstm_scan(p: Dict, zx):
    """The position loop: the cell over zx (B, S, 4d) from the zero state
    (m at -1e30) -> (h (B, S, d) float32, the last (c, n, m, h))."""
    b, d = zx.shape[0], zx.shape[2] // 4
    z0 = torch.zeros((b, d), dtype=torch.float32, device=zx.device)
    state = (z0, z0, torch.full((b, d), -1e30, dtype=torch.float32,
                                device=zx.device), z0)
    hs = []
    for t in range(zx.shape[1]):
        state = _slstm_cell(p, zx[:, t], state)
        hs.append(state[3])
    return torch.stack(hs, dim=1), state


def slstm_apply(cfg: ArchConfig, p: Dict, x, *, return_cache: bool = False):
    """Sequential sLSTM block and its GeGLU FFN. x: (B, S, d). With
    ``return_cache`` also the state (c, n, m, h) after the last position,
    float32."""
    # the input's share of the gates: one product for every position
    hs, state = _slstm_scan(p, x @ p["w_gates"])
    out = _slstm_out(p, hs.to(x.dtype))
    if not return_cache:
        return out
    return out, dict(zip("cnmh", state))


def slstm_cache_spec(cfg: ArchConfig, batch: int, stack: int = 0):
    st = (stack,) if stack else ()
    return {k: TensorSpec(st + (batch, cfg.d_model), torch.float32)
            for k in "cnmh"}


def slstm_decode(cfg: ArchConfig, p: Dict, x, cache: Dict):
    """One sLSTM step. x: (B, 1, d). Writes the new state into ``cache``
    in place and returns (out, cache)."""
    state = tuple(cache[k] for k in "cnmh")
    new = _slstm_cell(p, x[:, 0, :] @ p["w_gates"], state)
    out = _slstm_out(p, new[3][:, None, :].to(x.dtype))
    for old, val in zip(state, new):
        old.copy_(val)
    return out, cache
