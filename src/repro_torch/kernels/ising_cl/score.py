"""Import shim: the fused score entry points live in
:mod:`repro_torch.kernels.cl` (``BM``/``BN``/``BK`` are not exported; see
the package docstring)."""
from ..cl.kernel import cl_score_channels
from ..cl.score import (KERNEL_KINDS, cl_score, cl_score_channels_padded,
                        cl_score_padded, ising_cl_score,
                        ising_cl_score_padded)

__all__ = [
    "KERNEL_KINDS", "cl_score", "cl_score_padded", "cl_score_channels",
    "cl_score_channels_padded", "ising_cl_score", "ising_cl_score_padded",
]
