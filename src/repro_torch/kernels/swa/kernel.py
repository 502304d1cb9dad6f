"""Wrapper of the flash-attention kernel ``csrc/swa.cu``.

The kernel reads q, k and v through their strides in the (b, s, h, d)
layout and maps query head ``hq`` to KV head ``hq // (h // kh)``, so K and V
are never repeated or copied. It takes float32 and bfloat16 and the head
widths it is instantiated for (64, 96, 128, 256).
"""
from __future__ import annotations

import ctypes

import torch

from ..build import LIBRARIES, check
from .ref import swa_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the head widths the kernel is instantiated for
HEAD_WIDTHS = (64, 96, 128, 256)
#: cudaErrorNotSupported: the bfloat16 kernel at d = 64 and 128 reads K and V
#: by TMA only, and no tensor map could be made for them
_NO_TENSOR_MAP = 801


def swa_attention(q, k, v, *, window: int = 0):
    """Causal (optionally sliding-window) attention forward.

    q: (b, s, h, d); k, v: (b, s, kh, d) with h % kh == 0. Returns
    (b, s, h, d) in q's type. CUDA tensors launch the kernel (one launch
    counted in ``swa_attention.launches``); CPU tensors take the plain
    version.
    """
    if q.device.type != "cuda":
        return swa_attention_ref(q, k, v, window=window)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("swa_attention takes (b, s, h, d) tensors")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if k.shape != (b, s, kh, d) or v.shape != k.shape or h % kh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (h must be a "
                         f"multiple of kh)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"swa_attention takes float32 or bfloat16 q, k, v of "
                        f"one type on CUDA, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("swa_attention operands must share one device")
    if int(window) != window or window < 0:
        raise ValueError(f"window must be a non-negative integer, got "
                         f"{window}")
    lib = LIBRARIES.get("swa")
    if not lib.repro_swa_supports(d):
        raise ValueError(f"the swa kernel is instantiated for head widths "
                         f"64, 96, 128 and 256, got d = {d}")
    if b * h > 65535:
        raise ValueError(f"b * h = {b * h} exceeds the kernel's grid")
    # bfloat16 rows are read with 16-byte vector loads
    vec = 8 if q.dtype == torch.bfloat16 else 1
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % (vec * t.element_size()):
            raise ValueError(f"swa_attention needs {name} with a contiguous "
                             f"head-width dimension and rows aligned to "
                             f"{vec * t.element_size()} bytes; got strides "
                             f"{t.stride()}")
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, o)
                                         for st in t.stride()[:3]))
    err = lib.repro_swa_attention(
        _DTYPE_CODES[q.dtype], d, b, s, h, kh, int(window), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err == _NO_TENSOR_MAP and q.dtype == torch.bfloat16 and d in (64, 128):
        raise RuntimeError(f"swa_attention: no TMA tensor map describes k "
                           f"(strides {k.stride()}) and v (strides "
                           f"{v.stride()}), or the driver lacks "
                           f"cuTensorMapEncodeTiled")
    check(err, "swa_attention kernel")
    swa_attention.launches += 1
    return o


swa_attention.launches = 0
