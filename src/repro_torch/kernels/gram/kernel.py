"""Wrapper of the Gram kernel ``csrc/gram.cu``: ``G = S^T S / n``.

The kernel is the score kernel's Gram body (``csrc/gram_body.cuh``) with
r = F = S and one channel, in its symmetric mode: only the tiles on and
above the diagonal are launched (:func:`gram_launch_shape`). S may be
float32 or bfloat16; the kernel reads it in its own type and sums in
float32, and G is float32 either way, as the TPU kernel's.
"""
from __future__ import annotations

import torch

from ..build import LIBRARIES, check
from ..cl.kernel import DTYPE_CODES, copy_width, gram_tile_count, split_samples
from .ref import gram_ref


def gram_launch_shape(n: int, d: int):
    """(splits, chunk) of the sample axis for G of an (n, d) matrix: as many
    splits as fill the card with the triangle's tiles."""
    return split_samples(gram_tile_count(d, True), n)


def gram(s):
    """G = s^T s / n for s (n, d) -> (d, d) float32.

    A CUDA tensor launches the kernel (one launch counted in
    ``gram.launches``) and must be a contiguous float32 or bfloat16 matrix;
    a CPU tensor takes the plain version.
    """
    if s.device.type != "cuda":
        return gram_ref(s)
    if s.dtype not in DTYPE_CODES:
        raise TypeError(f"gram takes a float32 or bfloat16 matrix on CUDA, "
                        f"got {s.dtype}")
    if s.dim() != 2 or not s.is_contiguous():
        raise ValueError(f"gram needs a contiguous (n, d) matrix, got shape "
                         f"{tuple(s.shape)}")
    n, d = s.shape
    splits, chunk = gram_launch_shape(n, d)
    G = torch.empty((d, d), dtype=torch.float32, device=s.device)
    partial = (torch.empty(splits * d * d, dtype=torch.float32,
                           device=s.device) if splits > 1 else G)
    err = LIBRARIES.get("gram").repro_gram(
        DTYPE_CODES[s.dtype], s.data_ptr(), partial.data_ptr(), G.data_ptr(),
        n, d, splits, chunk, copy_width(d, s),
        torch.cuda.current_stream(s.device).cuda_stream)
    check(err, "gram kernel")
    gram.launches += 1
    return G


gram.launches = 0
