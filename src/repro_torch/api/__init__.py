"""The estimation-plan API: a :class:`Plan` -> an :class:`EstimationSession`
on one device -> ``fit`` or ``joint`` (an :class:`EstimateResult`),
``stream`` (a streaming estimator) or ``simulate`` (a sensor-network
simulator)."""
from .plan import MESH_POLICIES, Plan
from .result import EstimateResult
from .session import EstimationSession

__all__ = ["Plan", "EstimationSession", "EstimateResult", "MESH_POLICIES"]
