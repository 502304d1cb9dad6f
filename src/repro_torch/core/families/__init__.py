"""Model-family registry.

Families register here by name; the batched engine, the combiners and the
session resolve families through :func:`get_family` /
:func:`registered_families`.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .base import ModelFamily
from .gaussian import GaussianMRF
from .ising import IsingFamily
from .potts import PottsFamily

_REGISTRY: Dict[str, ModelFamily] = {}


def register_family(family: ModelFamily) -> ModelFamily:
    """Register (or replace) a family instance under ``family.name``."""
    if not family.name:
        raise ValueError("family needs a non-empty name")
    _REGISTRY[family.name] = family
    return family


def get_family(name: str) -> ModelFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model family {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def registered_families() -> Tuple[ModelFamily, ...]:
    """All registered families, name-sorted."""
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


#: canonical instances — the three families of this repro
ISING = register_family(IsingFamily())
GAUSSIAN = register_family(GaussianMRF())
POTTS3 = register_family(PottsFamily(q=3))

__all__ = [
    "ModelFamily", "IsingFamily", "GaussianMRF", "PottsFamily",
    "ISING", "GAUSSIAN", "POTTS3",
    "register_family", "get_family", "registered_families",
]
