"""Family-generic fused conditional-likelihood (CL) kernels.

* :mod:`.epilogues` — the per-family residual / curvature registry;
* :mod:`.newton` — bucket Newton statistics: plain version and the wrapper
  of ``csrc/newton.cu``;
* :mod:`.ref` / :mod:`.kernel` — masked logits and fused channelized score
  statistics: plain versions and the wrappers of ``csrc/score.cu``;
* :mod:`.score` — the single-channel and padded-buffer entry points over
  the channelized score kernel;
* :mod:`.precision` — the documented per-``Plan.precision`` conformance
  tolerances;
* :mod:`.ops` — dispatch (``cuda`` or ``ref``) with telemetry tags;
* :mod:`.family` — model-family adapters and the fused pseudo-score.

The seed's ``repro_torch.kernels.ising_cl`` package remains as import
shims.
"""
from .epilogues import (Epilogue, get_epilogue, register_epilogue,
                        registered_kinds)
from .family import family_kernel_inputs, family_score_stats, fused_pseudo_score
from .kernel import cl_logits, cl_score_channels, ising_cl_logits
from .newton import bucket_newton_stats, bucket_newton_stats_ref
from .ops import (KERNEL_PATHS, bucket_newton_stats_op, conditional_logits_op,
                  default_kernel_path, resolve_kernel_path,
                  score_stats_channels_op, score_stats_op)
from .precision import PRECISION_TOLERANCES, precision_tolerance
from .ref import (cl_logits_ref, cl_score_channels_ref, cl_score_ref,
                  ising_cl_logits_ref, ising_cl_score_ref)
from .score import (KERNEL_KINDS, cl_score, cl_score_channels_padded,
                    cl_score_padded, ising_cl_score, ising_cl_score_padded)

__all__ = [
    "Epilogue", "register_epilogue", "get_epilogue", "registered_kinds",
    "cl_logits", "ising_cl_logits", "cl_score_channels",
    "cl_score", "cl_score_padded", "cl_score_channels_padded",
    "ising_cl_score", "ising_cl_score_padded", "KERNEL_KINDS",
    "cl_score_ref", "cl_score_channels_ref", "cl_logits_ref",
    "ising_cl_logits_ref", "ising_cl_score_ref",
    "bucket_newton_stats", "bucket_newton_stats_ref",
    "conditional_logits_op", "score_stats_op", "score_stats_channels_op",
    "bucket_newton_stats_op", "KERNEL_PATHS", "default_kernel_path",
    "resolve_kernel_path",
    "PRECISION_TOLERANCES", "precision_tolerance",
    "family_kernel_inputs", "family_score_stats", "fused_pseudo_score",
]
