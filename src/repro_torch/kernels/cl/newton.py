"""Fused Newton-step statistics in the degree-bucket layout.

The batched engine (:mod:`repro_torch.core.batched`) solves every node of a
degree bucket at once: designs live as a channelized ``(k, C, d, n)`` tensor
and each damped Newton iteration needs, per node, the score vector

    g = sum_n Z[:, :, :, n] r[:, :, n]           (flat (k, d*C))

and the curvature Gram

    K = sum_n Z kappa Z                          ((k, d*C, d*C))

where ``r = dl/deta`` and ``kappa = -d2l/deta2`` come from the family
epilogue, in the coordinate-major flat layout ``[(d0,c0), (d0,c1), ...]``.

* :func:`bucket_newton_stats_ref` — the plain PyTorch version, with the
  reference package's contraction forms (the C = 1 single-channel products
  and the channelized einsums);
* :func:`bucket_newton_stats` — the wrapper of the CUDA kernel
  ``csrc/newton.cu``: it launches the kernel for CUDA tensors and takes the
  plain version only for CPU tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..build import LIBRARIES, check
from .epilogues import KIND_CODES, require_epilogue

#: the narrow (register-streaming) regime takes C == 1 buckets up to this
#: width; mirrors kNarrowMaxD of csrc/newton.cu, which refuses a launch
#: whose planned regime is not its own
NARROW_MAX_D = 8
#: blocks a bucket's grid should reach: four per SM of a 132-SM H100, so
#: the blocks of a short bucket hide each other's barriers and latencies
_TARGET_BLOCKS = 4 * 132
#: fewest samples a split holds when a bucket is cut into splits
_MIN_SPLIT = 16
#: largest dynamic shared memory a block may use on sm_90
_MAX_SMEM = 232448

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def _lead(eta_kcn):
    """(k, C, n) channel-middle -> (C, k, n) leading-channel (pure layout)."""
    return torch.movedim(eta_kcn, 1, 0)


def _unlead(a_ckn):
    return torch.movedim(a_ckn, 0, 1)


def bucket_residual_curvature(kind: str, eta, xi):
    """Epilogue residual r (k, C, n) and curvature kappa (k, C, C, n) at
    bucket-layout logits ``eta`` (k, C, n) for targets ``xi`` (k, n)."""
    ep = require_epilogue(kind)
    C = eta.shape[1]
    el = _lead(eta)                               # (C, k, n)
    F = ep.features(xi, C)                        # (C, k, n)
    r = _unlead(ep.residual(F, el))               # (k, C, n)
    kap = torch.movedim(ep.curvature(F, el), (0, 1), (1, 2))  # (k, C, C, n)
    return r, kap


def bucket_newton_stats_ref(kind: str, Zb, base, xi, W, sw=None):
    """(g, K) un-normalized score vector and curvature Gram, plain PyTorch.

    Zb: (k, C, d, n) bucket design; base: (k, C, n) fixed-offset logits;
    xi: (k, n) targets; W: (k, d*C) coordinate-major flat parameters;
    sw: optional (k, n) sample weights (None = unweighted). Returns
    g (k, d*C) and K (k, d*C, d*C) in the promoted type of the design and
    W (a bfloat16 design against float32 parameters computes in float32,
    as the reference's type promotion does).
    """
    k, C, d, _ = Zb.shape
    dC = d * C
    dt = torch.promote_types(Zb.dtype, W.dtype)
    Zb, base, xi, W = Zb.to(dt), base.to(dt), xi.to(dt), W.to(dt)
    if sw is not None:
        sw = sw.to(dt)
    if C == 1:
        Z1 = Zb[:, 0]
        eta = base + torch.einsum("kdn,kd->kn", Z1, W)[:, None, :]
        r, kap = bucket_residual_curvature(kind, eta, xi)
        if sw is not None:
            r = r * sw[:, None, :]
            kap = kap * sw[:, None, None, :]
        g = torch.einsum("kdn,kn->kd", Z1, r[:, 0])
        K = (Z1 * kap[:, 0, 0][:, None, :]) @ Z1.transpose(1, 2)
        return g, K
    eta = base + torch.einsum("kcdn,kdc->kcn", Zb, W.reshape(k, d, C))
    r, kap = bucket_residual_curvature(kind, eta, xi)
    if sw is not None:
        r = r * sw[:, None, :]
        kap = kap * sw[:, None, None, :]
    g = torch.einsum("kcdn,kcn->kdc", Zb, r).reshape(k, dC)
    K = torch.einsum("kcdn,kcen,kefn->kdcfe", Zb, kap, Zb).reshape(k, dC, dC)
    return g, K


class NewtonLaunch(NamedTuple):
    """How the kernel cuts one bucket: its regime and its sample splits."""
    regime: str     # "narrow" (register streaming) or "wide" (tiled product)
    splits: int     # sample splits per node
    chunk: int      # samples per split (a multiple of 8 when splits > 1)


def newton_launch_shape(k: int, C: int, d: int, n: int) -> NewtonLaunch:
    """Regime and sample splits of the kernel's grid for one bucket shape.

    A bucket of few nodes is cut into splits so that ``k * splits`` reaches
    four blocks per SM of the card, each split holding at least
    ``_MIN_SPLIT`` samples (split starts stay 16-byte aligned for the vector
    loads). Depends on the shape alone, so a shape always sums in the same
    order.
    """
    regime = "narrow" if C == 1 and d <= NARROW_MAX_D else "wide"
    want = -(-_TARGET_BLOCKS // k)
    if want <= 1 or n <= _MIN_SPLIT:
        return NewtonLaunch(regime, 1, n)
    chunk = max(_MIN_SPLIT, (n // want) // 8 * 8)
    splits = -(-n // chunk)
    return NewtonLaunch(regime, splits, chunk if splits > 1 else n)


@functools.lru_cache(maxsize=256)
def _launch_plan(k: int, C: int, d: int, n: int, code: int, weighted: bool):
    """(launch shape, floats of split scratch) of one bucket shape; raises
    for a width whose tiles do not fit a block's shared memory."""
    lib = LIBRARIES.get("newton")
    launch = newton_launch_shape(k, C, d, n)
    smem = lib.repro_newton_smem_bytes(C, d, code, int(weighted))
    if smem > _MAX_SMEM:
        raise ValueError(
            f"bucket of width d*C = {d * C} needs {smem} bytes of shared "
            f"memory per block, more than the {_MAX_SMEM} an sm_90 block can "
            f"use")
    return launch, lib.repro_newton_partial_floats(k, C, d, code,
                                                   int(weighted),
                                                   launch.splits)


def bucket_newton_stats(kind: str, Zb, base, xi, W, sw=None):
    """(g, K) bucket Newton statistics; same contract as
    :func:`bucket_newton_stats_ref`.

    A CUDA design launches ``csrc/newton.cu`` (one launch counted in
    ``bucket_newton_stats.launches``): inputs in float32, bfloat16 or
    float64 are read as float32, and g, K come back float32, as on the TPU.
    A CPU design takes the plain version.
    """
    require_epilogue(kind)
    if Zb.device.type != "cuda":
        return bucket_newton_stats_ref(kind, Zb, base, xi, W, sw)
    k, C, d, n = Zb.shape
    dC = d * C
    if Zb.dtype not in _DTYPE_CODES:
        raise TypeError(f"bucket_newton_stats takes float32, float64 or "
                        f"bfloat16 designs on CUDA, got {Zb.dtype}")
    if base.shape != (k, C, n) or xi.shape != (k, n) or W.shape != (k, dC):
        raise ValueError(
            f"shape mismatch: Zb {tuple(Zb.shape)}, base {tuple(base.shape)}, "
            f"xi {tuple(xi.shape)}, W {tuple(W.shape)}")
    if sw is not None and sw.shape != (k, n):
        raise ValueError(f"sw must be (k, n) = {(k, n)}, got "
                         f"{tuple(sw.shape)}")
    tensors = [Zb, base, xi, W] + ([] if sw is None else [sw])
    if any(t.device != Zb.device for t in tensors):
        raise ValueError("bucket_newton_stats inputs must share one device")
    # the small operands follow the design's type (W is read as float32);
    # the design itself must already be contiguous: it is never copied here
    if not Zb.is_contiguous():
        raise ValueError("bucket_newton_stats needs a contiguous design")
    base = base.to(Zb.dtype).contiguous()
    xi = xi.to(Zb.dtype).contiguous()
    W32 = W.to(torch.float32).contiguous()
    sw_c = None if sw is None else sw.to(Zb.dtype).contiguous()

    code = _DTYPE_CODES[Zb.dtype]
    launch, n_partial = _launch_plan(k, C, d, n, code, sw is not None)
    dev = Zb.device
    partial = (torch.empty(n_partial, dtype=torch.float32, device=dev)
               if n_partial else None)
    g = torch.empty((k, dC), dtype=torch.float32, device=dev)
    K = torch.empty((k, dC, dC), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = LIBRARIES.get("newton").repro_newton_stats(
        KIND_CODES[kind], code, Zb.data_ptr(), base.data_ptr(), xi.data_ptr(),
        W32.data_ptr(), None if sw_c is None else sw_c.data_ptr(),
        None if partial is None else partial.data_ptr(), g.data_ptr(),
        K.data_ptr(), k, C, d, n, launch.splits, launch.chunk,
        int(launch.regime == "narrow"), stream)
    check(err, "bucket_newton_stats kernel")
    bucket_newton_stats.launches += 1
    return g, K


bucket_newton_stats.launches = 0
