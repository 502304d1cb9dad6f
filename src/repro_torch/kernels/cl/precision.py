"""Per-precision conformance tolerances for the fused CL kernels.

``Plan.precision`` picks the type the sample matrix is cast to before the
local solves. float64 and float32 run the plain path in that type (the
solver state follows it). On the card every kernel sums in float32: the
Newton kernel (``csrc/newton.cu``) loads a bfloat16, float32 or float64
design, reads it as float32 and returns g and K in float32; the score,
``cl_logits`` and ``gram`` kernels (``csrc/score.cu``, ``csrc/gram.cu``)
load bfloat16 or float32 operands and return eta and r in the operands'
type and S and G in float32. The fit path's score pass still runs in
float32 (the pseudo-score casts to it first, as the reference does).
bfloat16 trims memory traffic, never the reduction type.

The table is the documented fused-vs-plain gate each precision must pass
(max-abs error of the fused statistics against the float32 plain version
on the conformance shapes):

==========  =========  =====================================================
precision   tolerance  why
==========  =========  =====================================================
float64     1e-10      the plain path in float64; a fixed contraction order
float32     1e-5       float32 reduction jitter across contraction orders
bfloat16    5e-2       8-bit mantissa loads; accumulation still float32, so
                       the error is load-quantization, not drift
==========  =========  =====================================================
"""
from __future__ import annotations

__all__ = ["PRECISION_TOLERANCES", "precision_tolerance"]

#: max-abs fused-vs-plain tolerance per Plan.precision (see the docstring)
PRECISION_TOLERANCES = {
    "float64": 1e-10,
    "float32": 1e-5,
    "bfloat16": 5e-2,
}


def precision_tolerance(precision: str) -> float:
    """The documented conformance tolerance for one ``Plan.precision``."""
    try:
        return PRECISION_TOLERANCES[precision]
    except KeyError:
        raise ValueError(
            f"no documented tolerance for precision {precision!r}; known: "
            f"{tuple(PRECISION_TOLERANCES)}") from None
