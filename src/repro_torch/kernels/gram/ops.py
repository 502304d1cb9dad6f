"""Dispatch for the Gram kernel: a CUDA tensor goes to the kernel, a CPU
tensor to the plain version; ``use_kernel=False`` asks for the plain version
on any device (the reference's ``use_pallas=False``)."""
from ..cl.ops import resolve_kernel_path
from .kernel import gram
from .ref import gram_ref


def gram_op(s, *, use_kernel: bool = True):
    """G = s^T s / n in float32."""
    if resolve_kernel_path(s.device, use_kernel) == "cuda":
        return gram(s)
    return gram_ref(s)
