"""Per-family kernel epilogues: the registry the fused CL kernels key on.

The channelized score kernel (:mod:`.kernel`) and the bucket Newton
statistics (:mod:`.newton`) are family-agnostic: one load -> eta -> residual
-> score/Gram skeleton. Everything family-specific is three elementwise maps
over **leading-channel** tensors (channel axis first):

* ``features(x, C) -> (C, ...)`` — the family's feature of a raw node value
  (identity for Ising/Gaussian, state indicators for Potts);
* ``residual(F, eta) -> (C, ...)`` — the per-sample score dl/deta given the
  node's own features ``F`` and its channel logits ``eta``; for Potts the
  softmax residual over all C = q - 1 channels at once, with the reference
  channel's zero logit implicit;
* ``curvature(F, eta) -> (C, C, ...)`` — closed-form -d2l/deta2, including
  the cross-channel softmax coupling ``diag(pi) - pi pi'`` for Potts.

These are the plain PyTorch versions; the CUDA kernels in ``csrc/`` carry
the same three maps as device functions selected by a template parameter.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """One family's fused-kernel math (leading-channel layout throughout)."""
    kind: str
    channels: str                 # "single" | "multi"
    features: Callable            # (x (...,), C) -> (C, ...)
    residual: Callable            # (F, eta) (C, ...) -> (C, ...)
    curvature: Callable           # (F, eta) (C, ...) -> (C, C, ...)

    def __post_init__(self):
        if self.channels not in ("single", "multi"):
            raise ValueError("channels must be 'single' or 'multi'")


_REGISTRY: Dict[str, Epilogue] = {}


def register_epilogue(ep: Epilogue) -> Epilogue:
    """Register (or replace) the epilogue for ``ep.kind``."""
    if not ep.kind:
        raise ValueError("epilogue needs a non-empty kind")
    _REGISTRY[ep.kind] = ep
    return ep


def get_epilogue(kind: Optional[str]) -> Optional[Epilogue]:
    """The registered epilogue for ``kind``, or None (no fused path)."""
    if kind is None:
        return None
    return _REGISTRY.get(kind)


def require_epilogue(kind: str) -> Epilogue:
    ep = get_epilogue(kind)
    if ep is None:
        raise ValueError(f"fused CL kernel has no epilogue for {kind!r}; "
                         f"registered: {registered_kinds()}")
    return ep


def registered_kinds() -> Tuple[str, ...]:
    """All registered epilogue kinds, name-sorted."""
    return tuple(sorted(_REGISTRY))


# ------------------------------------------------------------------ ising
def _ising_features(x, C: int = 1):
    return x[None]


def _ising_residual(F, eta):
    # logistic score of x in {-1, +1}: r = 2 x sigma(-2 x eta)
    return 2.0 * F * torch.sigmoid(-2.0 * F * eta)


def _ising_curvature(F, eta):
    r = _ising_residual(F, eta)
    return (r * (2.0 * F - r))[None]   # = 4 sigma(2 eta) sigma(-2 eta)


# ---------------------------------------------------------------- gaussian
def _gaussian_features(x, C: int = 1):
    return x[None]


def _gaussian_residual(F, eta):
    # unit-conditional-variance linear-Gaussian score: r = x - eta
    return F - eta


def _gaussian_curvature(F, eta):
    return torch.ones_like(eta)[None]


# ------------------------------------------------------------------- potts
def _potts_features(x, C: int):
    return torch.stack([(x == float(c)).to(x.dtype) for c in range(1, C + 1)])


def _potts_pi(eta):
    """Softmax over the C live channels with the reference channel's zero
    logit implicit: (C, ...) -> (C, ...)."""
    zero = torch.zeros_like(eta[:1])
    return torch.softmax(torch.cat([zero, eta], dim=0), dim=0)[1:]


def _potts_residual(F, eta):
    # multinomial-logistic score: y - pi, with y = the node's own indicator
    # features (state 0 is the reference, all-zero feature row)
    return F - _potts_pi(eta)


def _potts_curvature(F, eta):
    pi = _potts_pi(eta)
    C = eta.shape[0]
    return torch.stack([
        torch.stack([(pi[c] - pi[c] * pi[e]) if c == e else (-pi[c] * pi[e])
                     for e in range(C)])
        for c in range(C)])


ISING_EPILOGUE = register_epilogue(Epilogue(
    kind="ising", channels="single", features=_ising_features,
    residual=_ising_residual, curvature=_ising_curvature))
GAUSSIAN_EPILOGUE = register_epilogue(Epilogue(
    kind="gaussian", channels="single", features=_gaussian_features,
    residual=_gaussian_residual, curvature=_gaussian_curvature))
POTTS_EPILOGUE = register_epilogue(Epilogue(
    kind="potts", channels="multi", features=_potts_features,
    residual=_potts_residual, curvature=_potts_curvature))

#: kind -> the integer the CUDA entry points take for their template switch
KIND_CODES = {"ising": 0, "gaussian": 1, "potts": 2}
