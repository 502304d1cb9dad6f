"""Import shim: the masked conditional-logit kernel lives in
:mod:`repro_torch.kernels.cl.kernel` (``BM``/``BN``/``BK`` are not
exported; see the package docstring)."""
from ..cl.kernel import cl_logits, ising_cl_logits

__all__ = ["ising_cl_logits", "cl_logits"]
