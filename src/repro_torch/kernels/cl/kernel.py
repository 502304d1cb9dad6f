"""Wrapper of the fused channelized score kernel ``csrc/score.cu``.

One CUDA kernel family for both TPU bodies of ``cl_score_channels`` (the
single-channel one and the channelized one): the channel count is a template
parameter of the kernel. The fit path always hands it float32 operands
(:func:`repro_torch.kernels.cl.family.fused_pseudo_score` casts them).
"""
from __future__ import annotations

import torch

from ..build import LIBRARIES, check
from .epilogues import KIND_CODES, require_epilogue
from .ref import cl_score_channels_ref

#: output tile edge of the kernel (rows and columns)
_TILE = 64
#: blocks the Gram product should reach (two per SM of a 132-SM H100)
_TARGET_BLOCKS = 264
#: fewest samples a split of the Gram product should hold
_MIN_SPLIT = 128


def score_launch_shape(C: int, n: int, p: int):
    """(splits, chunk) of the Gram product's sample axis for one shape."""
    tiles = -(-p // _TILE)
    base_blocks = tiles * tiles * C * C
    splits = max(1, min(-(-_TARGET_BLOCKS // base_blocks), -(-n // _MIN_SPLIT),
                        65535 // (C * C)))
    chunk = -(-n // splits)
    chunk = -(-chunk // 16) * 16
    splits = -(-n // chunk)
    return splits, chunk


def cl_score_channels(F, theta, mask, bias, *, kind: str):
    """(eta, r, S) fused channelized score statistics.

    F: (C, n, p) per-channel design features (for single-channel kinds F[0]
    is the raw sample matrix; for Potts, state indicators); theta: (C, p, p)
    per-channel couplings; mask: (p, p); bias: (C, p). Returns eta, r of
    shape (C, n, p) and ``S[c, e] = r_c^T F_e / n`` of shape (C, C, p, p),
    all float32. CUDA operands launch the kernel (one launch counted in
    ``cl_score_channels.launches``) and must be float32; CPU operands take
    the plain version.
    """
    require_epilogue(kind)
    if F.device.type != "cuda":
        return cl_score_channels_ref(F, theta, mask, bias, kind)
    C, n, p = F.shape
    ops = (F, theta, mask, bias)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("cl_score_channels takes float32 operands on CUDA, "
                        f"got {[str(t.dtype) for t in ops]}")
    if theta.shape != (C, p, p) or mask.shape != (p, p) \
            or bias.shape != (C, p):
        raise ValueError(
            f"shape mismatch: F {tuple(F.shape)}, theta {tuple(theta.shape)},"
            f" mask {tuple(mask.shape)}, bias {tuple(bias.shape)}")
    if any(t.device != F.device for t in ops):
        raise ValueError("cl_score_channels operands must share one device")
    if any(not t.is_contiguous() for t in ops):
        raise ValueError("cl_score_channels needs contiguous operands")
    lib = LIBRARIES.get("score")
    if kind == "potts" and C > lib.repro_score_max_channels():
        raise ValueError(f"the score kernel covers at most "
                         f"{lib.repro_score_max_channels()} Potts channels, "
                         f"got C = {C}")
    splits, chunk = score_launch_shape(C, n, p)
    dev = F.device
    eta = torch.empty((C, n, p), dtype=torch.float32, device=dev)
    r = torch.empty((C, n, p), dtype=torch.float32, device=dev)
    S = torch.empty((C, C, p, p), dtype=torch.float32, device=dev)
    partial = (torch.empty(splits * C * C * p * p, dtype=torch.float32,
                           device=dev) if splits > 1 else S)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_score_channels(
        KIND_CODES[kind], C, F.data_ptr(), theta.data_ptr(), mask.data_ptr(),
        bias.data_ptr(), eta.data_ptr(), r.data_ptr(), partial.data_ptr(),
        S.data_ptr(), n, p, splits, chunk, stream)
    check(err, "cl_score_channels kernel")
    cl_score_channels.launches += 1
    return eta, r, S


cl_score_channels.launches = 0
