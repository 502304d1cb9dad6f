"""Import shim: the dispatching ops live in :mod:`repro_torch.kernels.cl.ops`."""
from ..cl.ops import (conditional_logits_op, score_stats_channels_op,
                      score_stats_op)

__all__ = ["conditional_logits_op", "score_stats_op",
           "score_stats_channels_op"]
