"""The estimation-plan API: a :class:`Plan` -> an :class:`EstimationSession`
on one device -> ``fit`` -> an :class:`EstimateResult`."""
from .plan import MESH_POLICIES, Plan
from .result import EstimateResult
from .session import EstimationSession

__all__ = ["Plan", "EstimationSession", "EstimateResult", "MESH_POLICIES"]
