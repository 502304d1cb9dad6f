"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427): the
port of ``repro.models.ssm``.

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a y_t)          recurrence gate
    i_t = sigmoid(W_i y_t)          input gate
    a_t = exp(c * r_t * log_a)      per-channel decay, log_a = -softplus(L)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

A causal depthwise conv (width 4) precedes the RG-LRU, as in Griffin's
recurrent block. The gates' arithmetic is float32, and h stays float32 until
it meets the output gate, as in the reference. The full-sequence path takes
the place of the reference's ``jax.lax.associative_scan`` with a doubling
(Hillis-Steele) scan over the sequence axis, :func:`linear_scan`; decode is
one step that updates the cache in place.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as Fn

from .attention import TensorSpec
from .common import ArchConfig, spec

RGLRU_C = 8.0


def rglru_spec(cfg: ArchConfig, stack: int = 0):
    d, dr = cfg.d_model, cfg.rglru_width or cfg.d_model
    st = (stack,) if stack else ()
    sa = (None,) if stack else ()
    return {
        "w_x": spec(st + (d, dr), sa + (None, "model")),
        "w_gate": spec(st + (d, dr), sa + (None, "model")),
        "conv_k": spec(st + (cfg.conv_width, dr), sa + (None, "model"),
                       scale=0.5),
        "w_a": spec(st + (dr, dr), sa + ("model", None), scale=0.5),
        "w_i": spec(st + (dr, dr), sa + ("model", None), scale=0.5),
        # float32 whatever the config's type, as in the reference
        "lamb": spec(st + (dr,), sa + (None,), init="ones",
                     dtype=torch.float32),
        "w_out": spec(st + (dr, d), sa + ("model", None)),
    }


def _causal_depthwise_conv(y, kernel):
    """y: (B, S, C); kernel: (W, C). Causal depthwise conv, its taps summed
    in the reference's order."""
    w, s = kernel.shape[0], y.shape[1]
    ypad = Fn.pad(y, (0, 0, w - 1, 0))
    out = torch.zeros_like(y)
    for t in range(w):
        out = out + ypad[:, t: t + s, :] * kernel[t]
    return out


def _rglru_gates(p: Dict, y):
    """(a, gated input), both float32."""
    r = torch.sigmoid(y @ p["w_a"])
    i = torch.sigmoid(y @ p["w_i"])
    log_a = -Fn.softplus(p["lamb"]) * RGLRU_C * r.to(torch.float32)
    a = torch.exp(log_a)
    gated = (i * y).to(torch.float32) * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, gated


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1, from h_{-1} = 0: a doubling
    scan of ceil(log2 S) vectorised steps, each combining every position
    with the one ``off`` before it (``b[t] += a[t] b[t - off]``, ``a[t] *=
    a[t - off]``). It multiplies decays only across the spans it combines,
    never forms a running product from position 0: a_t can be as small as
    exp(-8 softplus(lamb)) a step, so a cumulative product underflows
    float32 within tens of steps. Out of place, so autograd can run it."""
    s, off = a.shape[1], 1
    while off < s:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]], 1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def rglru_apply(cfg: ArchConfig, p: Dict, x, *, return_cache: bool = False):
    """Full-sequence RG-LRU block. x: (B, S, d_model). With
    ``return_cache`` also the decode cache: h (B, dr) float32 at the last
    position and the last ``conv_width - 1`` rows of the conv's input in
    the model's type, zero-padded on the left when S is shorter."""
    gate = Fn.gelu(x @ p["w_gate"], approximate="tanh")
    y_raw = x @ p["w_x"]
    y = _causal_depthwise_conv(y_raw, p["conv_k"])
    a, b = _rglru_gates(p, y)
    h = linear_scan(a, b)
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    if not return_cache:
        return out
    w = cfg.conv_width
    hist = y_raw[:, -(w - 1):, :]
    hist = Fn.pad(hist, (0, 0, (w - 1) - hist.shape[1], 0))
    # copies, so the cache holds none of the sequence-long tensors
    cache = {"h": h[:, -1, :].clone(),
             "conv": hist.to(cfg.torch_dtype).clone()}
    return out, cache


def rglru_cache_spec(cfg: ArchConfig, batch: int, stack: int = 0):
    dr = cfg.rglru_width or cfg.d_model
    st = (stack,) if stack else ()
    return {"h": TensorSpec(st + (batch, dr), torch.float32),
            "conv": TensorSpec(st + (batch, cfg.conv_width - 1, dr),
                               cfg.torch_dtype)}


def rglru_decode(cfg: ArchConfig, p: Dict, x, cache: Dict):
    """One-step RG-LRU. x: (B, 1, d). Writes the new h and conv history
    into ``cache`` in place (its leaves may be views of a stacked cache)
    and returns (out, cache)."""
    gate = Fn.gelu(x @ p["w_gate"], approximate="tanh")    # (B, 1, dr)
    y = (x @ p["w_x"])[:, 0, :]                             # (B, dr)
    conv = cache["conv"]
    # a fresh tensor: the new history is copied into the cache's own
    # storage below, which hist[:, 1:] must not overlap
    hist = torch.cat([conv, y[:, None, :].to(conv.dtype)], dim=1)
    w = p["conv_k"].shape[0]
    yc = torch.einsum("bwc,wc->bc", hist[:, -w:, :].to(y.dtype), p["conv_k"])
    a, b = _rglru_gates(p, yc[:, None, :])
    h_new = a[:, 0] * cache["h"] + b[:, 0]
    out = (h_new[:, None, :].to(x.dtype) * gate) @ p["w_out"]
    cache["h"].copy_(h_new)
    conv.copy_(hist[:, 1:, :])
    return out, cache
