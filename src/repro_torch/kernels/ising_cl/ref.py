"""Import shim: the plain versions live in :mod:`repro_torch.kernels.cl.ref`."""
from ..cl.ref import (cl_score_channels_ref, cl_score_ref,
                      ising_cl_logits_ref, ising_cl_score_ref)

__all__ = [
    "cl_score_ref", "cl_score_channels_ref", "ising_cl_logits_ref",
    "ising_cl_score_ref",
]
