"""Mixture-of-Experts FFN: top-k routing with capacity-based, group-blocked
dispatch (GShard/Switch-style), shared always-on experts (qwen2-moe) and
the router's load-balance auxiliary loss. The port of
``repro.models.moe``.

Expert weights are stacked (E_pad, d, d_ff), the expert count padded to a
multiple of 16 as in the reference (whose expert axis shards over its model
axis); padding experts get no router column and are never chosen. The
expert products are plain batched matmuls over the (G, E_pad, C, d)
dispatch buffer, as the reference computes them outside any kernel.

The reference drops over-capacity (token, slot) pairs by scattering them to
an out-of-range slot with ``mode="drop"``; here they go to one spare slot
past the buffer's end, which is cut off before the expert products. Kept
slots are distinct, so the dispatch is an assignment, and the combine
gathers each token's k slot outputs and sums them: no atomics and no host
synchronisation, so a call is bitwise repeatable on the card. The backward
is too: the dispatch's source is an expanded copy of the tokens (its
gradient a sum over the k slots, not an index-add), and the combine's
gather has a scatter-add for a gradient in which only dropped pairs share
a slot, each adding an exact zero.

The dispatch, the expert products and the combine are functions of their
own (:func:`dispatch`, :func:`expert_ffn`, :func:`combine`), called through
the module, so a profiler can mark each.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as Fn

from .common import ArchConfig, act_fn, spec

#: token counts up to this are routed dropless (capacity = tokens per group)
DROPLESS_TOKENS = 4096


def padded_experts(e: int) -> int:
    """Experts padded to a multiple of 16 (qwen's 60 -> 64; llama4's 16 ->
    16). Padding experts receive no router logit and are never selected."""
    return ((e + 15) // 16) * 16


def moe_spec(cfg: ArchConfig, stack: int = 0):
    d, de = cfg.d_model, cfg.d_expert or cfg.d_ff
    e = padded_experts(cfg.n_experts)
    st = (stack,) if stack else ()
    sa = (None,) if stack else ()
    p = {
        "router": spec(st + (d, cfg.n_experts), sa + (None, None), scale=0.1,
                       dtype=torch.float32),
        "w_gate": spec(st + (e, d, de), sa + ("expert", None, "model")),
        "w_up": spec(st + (e, d, de), sa + ("expert", None, "model")),
        "w_out": spec(st + (e, de, d), sa + ("expert", "model", None)),
    }
    if cfg.n_shared_experts:
        ds = de * cfg.n_shared_experts
        p["shared_gate"] = spec(st + (d, ds), sa + (None, "model"))
        p["shared_up"] = spec(st + (d, ds), sa + (None, "model"))
        p["shared_out"] = spec(st + (ds, d), sa + ("model", None))
    return p


class Routing(NamedTuple):
    """Where each (token, slot) pair of a call goes. ``gate_idx``,
    ``gate_vals``, ``pos`` and ``keep`` are (G, Tg * k) in token-major
    order; ``cap`` is each expert's slots per group."""
    gate_idx: torch.Tensor
    gate_vals: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int
    aux: torch.Tensor


def route(cfg: ArchConfig, router, xt, n_groups: int = 16) -> Routing:
    """Softmax router, top-k with renormalised gates, the Switch auxiliary
    loss, and each pair's position within its expert's buffer of its group
    (an exclusive cumulative count in token-major (token, slot) order);
    pairs at or past the capacity are not kept. xt: (T, d)."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_tok
    probs = torch.softmax(xt.to(torch.float32) @ router, dim=-1)   # (T, E)
    # the first k of a stable descending sort: equal probabilities go to
    # the lower expert index, as jax.lax.top_k breaks ties (torch.topk
    # promises no order among them); untied rows get topk's experts,
    # order and values
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    ce = Fn.one_hot(gate_idx[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(probs.mean(0) * ce)

    g = n_groups if t % n_groups == 0 and t >= n_groups else 1
    tg = t // g
    # dropless for small token counts (decode, small batches): with
    # capacity Tg no pair can overflow
    cap = tg if t <= DROPLESS_TOKENS else \
        int(max(1, cfg.capacity_factor * k * tg / e))
    flat_idx = gate_idx.reshape(g, tg * k)
    onehot = Fn.one_hot(flat_idx, e)                            # (G, Tg*k, E)
    before = torch.cumsum(onehot, dim=1) - onehot               # exclusive
    pos = before.gather(-1, flat_idx[..., None])[..., 0]        # (G, Tg*k)
    return Routing(flat_idx, gate_vals.reshape(g, tg * k), pos, pos < cap,
                   cap, aux)


def dispatch(cfg: ArchConfig, r: Routing, xt):
    """Every kept pair's token row into its (expert, position) slot of a
    (G, E_pad, cap, d) buffer; dropped pairs go to one spare slot past the
    end, cut off after. Returns (buffer, each pair's slot)."""
    ep, k = padded_experts(cfg.n_experts), cfg.experts_per_tok
    g, cap = r.keep.shape[0], r.cap
    t, d = xt.shape
    tg = t // g
    slot = torch.where(r.keep, r.gate_idx * cap + r.pos, ep * cap)
    buf = torch.zeros((g, ep * cap + 1, d), dtype=xt.dtype, device=xt.device)
    # each token's row k times over (the values of repeat_interleave; its
    # gradient a sum over the expanded axis)
    src = xt.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(g, tg * k, d)
    buf.scatter_(1, slot[..., None].expand(g, tg * k, d), src)
    return buf[:, :ep * cap].reshape(g, ep, cap, d), slot


def expert_ffn(cfg: ArchConfig, p: Dict, buf):
    """The expert FFN per (group, expert): (G, E, C, d) x (E, d, f)."""
    h = act_fn(cfg, torch.einsum("gecd,edf->gecf", buf, p["w_gate"]),
               torch.einsum("gecd,edf->gecf", buf, p["w_up"]))
    return torch.einsum("gecf,efd->gecd", h, p["w_out"])


def combine(cfg: ArchConfig, r: Routing, out_e, slot):
    """Each pair's slot output, gate-weighted (0 if dropped), summed over
    the token's k slots -> (G * Tg, d)."""
    k = cfg.experts_per_tok
    g, e, cap, d = out_e.shape
    n_pairs = slot.shape[1]
    slot = torch.where(r.keep, slot, 0)
    w = (r.gate_vals * r.keep).to(out_e.dtype)
    picked = out_e.reshape(g, e * cap, d).gather(
        1, slot[..., None].expand(g, n_pairs, d))
    picked = torch.where(r.keep[..., None], picked * w[..., None], 0)
    return picked.reshape(g, n_pairs // k, k, d).sum(2).reshape(-1, d)


def moe_apply(cfg: ArchConfig, p: Dict, x,
              n_groups: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (output, aux load-balance loss in float32)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    r = route(cfg, p["router"], xt, n_groups)
    buf, slot = dispatch(cfg, r, xt)
    out = combine(cfg, r, expert_ffn(cfg, p, buf), slot)
    if cfg.n_shared_experts:
        out = out + act_fn(cfg, xt @ p["shared_gate"],
                           xt @ p["shared_up"]) @ p["shared_out"]
    return out.reshape(b, s, d), r.aux
