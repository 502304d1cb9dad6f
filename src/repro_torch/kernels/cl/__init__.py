"""Family-generic fused conditional-likelihood (CL) kernels.

* :mod:`.epilogues` — the per-family residual / curvature registry;
* :mod:`.newton` — bucket Newton statistics: plain version and the wrapper
  of ``csrc/newton.cu``;
* :mod:`.ref` / :mod:`.kernel` — masked logits and fused channelized score
  statistics: plain versions and the wrappers of ``csrc/score.cu``;
* :mod:`.ops` — dispatch (``cuda`` or ``ref``);
* :mod:`.family` — model-family adapters and the fused pseudo-score.
"""
from .epilogues import (Epilogue, get_epilogue, register_epilogue,
                        registered_kinds)
from .family import family_kernel_inputs, fused_pseudo_score
from .kernel import cl_logits, cl_score_channels, ising_cl_logits
from .newton import bucket_newton_stats, bucket_newton_stats_ref
from .ops import (bucket_newton_stats_op, conditional_logits_op,
                  resolve_kernel_path, score_stats_channels_op)
from .ref import cl_logits_ref, cl_score_channels_ref, ising_cl_logits_ref

__all__ = [
    "Epilogue", "register_epilogue", "get_epilogue", "registered_kinds",
    "cl_logits", "cl_logits_ref", "ising_cl_logits", "ising_cl_logits_ref",
    "conditional_logits_op",
    "cl_score_channels", "cl_score_channels_ref", "bucket_newton_stats",
    "bucket_newton_stats_ref", "resolve_kernel_path",
    "score_stats_channels_op", "bucket_newton_stats_op",
    "family_kernel_inputs", "fused_pseudo_score",
]
