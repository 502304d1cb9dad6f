"""Gram / empirical-Fisher accumulation ``G = S^T S / n``: the plain version
(:mod:`.ref`), the wrapper of ``csrc/gram.cu`` (:mod:`.kernel`) and the
dispatch (:mod:`.ops`)."""
from .kernel import gram, gram_launch_shape
from .ops import gram_op
from .ref import gram_ref

__all__ = ["gram", "gram_launch_shape", "gram_op", "gram_ref"]
