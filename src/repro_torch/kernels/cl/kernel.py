"""Wrappers of the CL kernels of ``csrc/score.cu``.

One CUDA kernel family for both TPU bodies of ``cl_score_channels`` (the
single-channel one and the channelized one): the channel count is a template
parameter of the kernel. :func:`cl_logits` is the same masked product
without the residual and Gram stages (the TPU's ``cl_logits``).

Both take float32 or bfloat16 operands on CUDA, all four of one type, as
the TPU kernels do, and hand them to the kernel as they are: it reads them
in their own type and sums in float32 (no upcast copy, no conversion pass).
eta and r come back in F's type, rounded once from float32, and S in
float32; a bfloat16 call gives those of a float32 call on the float32
upcasts of its operands, rounded. The fit path always hands the score
kernel float32 operands
(:func:`repro_torch.kernels.cl.family.fused_pseudo_score` casts them).

The masked product follows the nonzeros of the mask: a pre-pass on the card
lists them by column, and the product walks those lists (or, for a tile of
columns whose lists fill most of their rows, a dense walk over those rows;
up to p = 128 there is no pre-pass and every tile walks all rows densely).
With finite operands eta is bitwise what a dense product over all rows gives.
Where a non-finite Theta[c, j, i] or F[c, s, j] meets a zero of the mask at
(j, i), eta[c, s, i] is NaN, as in the reference (Theta * A is formed first)
and the plain version, and r and S follow from it: after the product a scan
reads F and Theta once for non-finite values, and only when it finds one
does a fix-up kernel write those NaNs.
"""
from __future__ import annotations

import functools

import torch

from ..build import LIBRARIES, check
from .epilogues import KIND_CODES, require_epilogue
from .ref import cl_logits_ref, cl_score_channels_ref

#: output tile edge of the Gram body (``kGramTile`` in csrc/gram_body.cuh)
GRAM_TILE = 128
#: samples of one pipeline stage of the Gram body (``kGramSlab``); a split
#: holds a whole number of them
GRAM_SLAB = 16
#: blocks the Gram product should reach (two per SM of a 132-SM H100)
_TARGET_BLOCKS = 264
#: fewest samples a split of the Gram product should hold
_MIN_SPLIT = 64


def gram_tile_count(p: int, symmetric: bool) -> int:
    """Blocks of the Gram body per channel pair and split: the tiles on and
    above the diagonal (symmetric) or every tile (``gram_tile_count`` in
    csrc/gram_body.cuh)."""
    t = -(-p // GRAM_TILE)
    return t * (t + 1) // 2 if symmetric else t * t


def split_samples(blocks: int, n: int):
    """(splits, chunk) of the Gram body's sample axis for ``blocks`` output
    blocks: enough splits to fill the card in one wave, none shorter than
    ``_MIN_SPLIT`` samples, chunks a multiple of ``GRAM_SLAB``; a function
    of the shape alone, so a call repeats bitwise."""
    splits = max(1, min(_TARGET_BLOCKS // blocks, -(-n // _MIN_SPLIT), 65535))
    chunk = -(-n // splits)
    chunk = -(-chunk // GRAM_SLAB) * GRAM_SLAB
    return -(-n // chunk), chunk


def score_launch_shape(C: int, n: int, p: int):
    """(splits, chunk) of the score kernel's Gram S (all C*C channel pairs,
    every tile)."""
    return split_samples(gram_tile_count(p, False) * C * C, n)


#: operand type codes of the C entries (``Dtype`` in csrc/gram_body.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}


def copy_width(p: int, *tensors) -> int:
    """Elements of one copy of the Gram body's operand staging for rows of
    p elements of the tensors' type: a 16-byte copy where p elements are
    whole 16-byte units and every base is 16-byte aligned (4 float32, 8
    bfloat16), else a 4-byte one where they are whole 4-byte units and
    4-byte aligned (1 float32, a pair of bfloat16), else a single bfloat16
    (a plain load: cp.async copies no 2-byte unit)."""
    size = tensors[0].element_size()
    for nbytes in (16, 4):
        width = nbytes // size
        if p % width == 0 and all(t.data_ptr() % nbytes == 0
                                  for t in tensors):
            return width
    return 1


@functools.lru_cache(maxsize=None)
def _workspace_words(C: int, p: int) -> int:
    """4-byte words of the masked product's pre-pass workspace: the mask's
    nonzeros by column, sized for the worst case so no count crosses to
    the host."""
    return LIBRARIES.get("score").repro_masked_workspace_words(C, p)


def _check_operands(name, F, theta, mask, bias):
    """Types, shapes, device and layout the CL kernels take on CUDA."""
    C, n, p = F.shape
    ops = (F, theta, mask, bias)
    if F.dtype not in DTYPE_CODES or any(t.dtype != F.dtype for t in ops):
        raise TypeError(f"{name} takes float32 or bfloat16 operands on "
                        f"CUDA, all four of one type, got "
                        f"{[str(t.dtype) for t in ops]}")
    if theta.shape != (C, p, p) or mask.shape != (p, p) \
            or bias.shape != (C, p):
        raise ValueError(
            f"shape mismatch: F {tuple(F.shape)}, theta {tuple(theta.shape)},"
            f" mask {tuple(mask.shape)}, bias {tuple(bias.shape)}")
    if any(t.device != F.device for t in ops):
        raise ValueError(f"{name} operands must share one device")
    if any(not t.is_contiguous() for t in ops):
        raise ValueError(f"{name} needs contiguous operands")


def cl_logits(F, theta, mask, bias):
    """Channelized masked logits ``eta_c = F_c (theta_c * mask) + b_c``.

    F: (C, n, p); theta: (C, p, p); mask: (p, p); bias: (C, p). Returns
    (C, n, p) in F's type. CUDA operands launch the kernel (one launch
    counted in ``cl_logits.launches``), must be all float32 or all bfloat16
    and have at most ``repro_score_max_channels()`` channels; CPU operands
    take the plain version.
    """
    if F.device.type != "cuda":
        return cl_logits_ref(F, theta, mask, bias)
    _check_operands("cl_logits", F, theta, mask, bias)
    C, n, p = F.shape
    lib = LIBRARIES.get("score")
    if C > lib.repro_score_max_channels():
        raise ValueError(f"the logits kernel covers at most "
                         f"{lib.repro_score_max_channels()} channels, "
                         f"got C = {C}")
    eta = torch.empty((C, n, p), dtype=F.dtype, device=F.device)
    words = _workspace_words(C, p)
    work = (torch.empty(words, dtype=torch.int32, device=F.device)
            if words else None)
    err = lib.repro_cl_logits(DTYPE_CODES[F.dtype], C, F.data_ptr(),
                              theta.data_ptr(),
                              mask.data_ptr(), bias.data_ptr(),
                              work.data_ptr() if words else None,
                              eta.data_ptr(), n, p,
                              torch.cuda.current_stream(F.device).cuda_stream)
    check(err, "cl_logits kernel")
    cl_logits.launches += 1
    return eta


cl_logits.launches = 0


def ising_cl_logits(x, theta, mask, bias):
    """``eta = x (theta * mask) + bias``: the C = 1 instance of
    :func:`cl_logits` for x (n, p), theta and mask (p, p), bias (p,)."""
    return cl_logits(x[None], theta[None], mask, bias[None])[0]


def cl_score_channels(F, theta, mask, bias, *, kind: str):
    """(eta, r, S) fused channelized score statistics.

    F: (C, n, p) per-channel design features (for single-channel kinds F[0]
    is the raw sample matrix; for Potts, state indicators); theta: (C, p, p)
    per-channel couplings; mask: (p, p); bias: (C, p). Returns eta, r of
    shape (C, n, p) in F's type and ``S[c, e] = r_c^T F_e / n`` of shape
    (C, C, p, p) in float32, formed from r before it is rounded. CUDA
    operands launch the kernel (one launch counted in
    ``cl_score_channels.launches``) and must be all float32 or all bfloat16;
    CPU operands take the plain version.
    """
    require_epilogue(kind)
    if F.device.type != "cuda":
        return cl_score_channels_ref(F, theta, mask, bias, kind)
    _check_operands("cl_score_channels", F, theta, mask, bias)
    C, n, p = F.shape
    lib = LIBRARIES.get("score")
    if kind == "potts" and C > lib.repro_score_max_channels():
        raise ValueError(f"the score kernel covers at most "
                         f"{lib.repro_score_max_channels()} Potts channels, "
                         f"got C = {C}")
    splits, chunk = score_launch_shape(C, n, p)
    dev = F.device
    eta = torch.empty((C, n, p), dtype=F.dtype, device=dev)
    r = torch.empty((C, n, p), dtype=F.dtype, device=dev)
    S = torch.empty((C, C, p, p), dtype=torch.float32, device=dev)
    # one float32 scratch buffer: r before rounding, which the Gram reads
    # (bfloat16 only), the Gram partials (when the samples are split), then
    # the pre-pass's workspace (none for a small p)
    rwords = C * n * p if F.dtype == torch.bfloat16 else 0
    part = splits * C * C * p * p if splits > 1 else 0
    words = rwords + part + _workspace_words(C, p)
    scratch = torch.empty(words, dtype=torch.float32, device=dev) \
        if words else None
    base = scratch.data_ptr() if words else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_score_channels(
        KIND_CODES[kind], DTYPE_CODES[F.dtype], C, F.data_ptr(),
        theta.data_ptr(), mask.data_ptr(), bias.data_ptr(),
        base + 4 * (rwords + part), eta.data_ptr(), r.data_ptr(),
        base if rwords else None, base + 4 * rwords if part else S.data_ptr(),
        S.data_ptr(), n, p, splits, chunk, copy_width(p, F), stream)
    check(err, "cl_score_channels kernel")
    cl_score_channels.launches += 1
    return eta, r, S


cl_score_channels.launches = 0
