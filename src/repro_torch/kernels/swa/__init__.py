"""Causal, optionally sliding-window flash attention: the plain version
(:mod:`.ref`), the wrapper of ``csrc/swa.cu`` (:mod:`.kernel`) and the
forward-only dispatch (:mod:`.ops`)."""
from .kernel import swa_attention
from .ops import swa_op
from .ref import swa_attention_ref

__all__ = ["swa_attention", "swa_attention_ref", "swa_op"]
