"""Causal, optionally sliding-window flash attention: the plain version
(:mod:`.ref`), the wrapper of ``csrc/swa.cu`` (:mod:`.kernel`) and the
dispatch with its recompute backward (:mod:`.ops`)."""
from .kernel import swa_attention
from .ops import SwaFunction, swa_op
from .ref import swa_attention_ref

__all__ = ["SwaFunction", "swa_attention", "swa_attention_ref", "swa_op"]
