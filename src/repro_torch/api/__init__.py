"""The estimation-plan API: a :class:`Plan` -> an :class:`EstimationSession`
on one device -> ``fit`` or ``joint`` (an :class:`EstimateResult`),
``stream`` (a streaming estimator), ``simulate`` (a sensor-network
simulator) or ``select`` (a :class:`StructureResult`, configured by a
:class:`StructureSpec`); a :class:`TelemetrySpec` on the plan instruments
them all."""
from ..structure import StructureResult, StructureSpec
from ..telemetry import TelemetrySpec
from .plan import MESH_POLICIES, Plan
from .result import EstimateResult
from .session import EstimationSession

__all__ = ["Plan", "EstimationSession", "EstimateResult", "MESH_POLICIES",
           "StructureSpec", "StructureResult", "TelemetrySpec"]
