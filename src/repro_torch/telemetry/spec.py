"""The frozen, serializable telemetry declaration a :class:`Plan` carries.

Like :class:`~repro_torch.stream.faults.FaultPlan`, a :class:`TelemetrySpec`
is a plain hashable value object: it rides on the (frozen, hashable) plan,
keys the session cache, and round-trips exactly through
``to_dict``/``from_dict`` in the reference package's schema.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Declarative telemetry configuration.

    spans — record hierarchical spans (``fit`` -> bucket solve -> combine;
        ``stream`` -> round -> refit; ``joint`` -> ADMM iteration;
        ``select`` -> screen, dense fit, path, vote) with wall time and the
        kernel-library builds paid while they were open.
    metrics — record counters, gauges and histograms (comm scalars by
        scheme, buffer occupancy, window effective counts, fault
        injections, robust-combiner rejections, per-bucket Newton
        iterations) and per-round timeline points.
    jsonl — path of an append-only JSONL event log (None = in memory
        only). Replaying the log reconstructs the exact comm accounting
        (see :mod:`repro_torch.telemetry.replay`).
    profile_dir — when set, a ``torch.profiler`` trace (CPU and CUDA
        activities) around the outermost span of each instrumented verb is
        written into this directory.
    """

    spans: bool = True
    metrics: bool = True
    jsonl: Optional[str] = None
    profile_dir: Optional[str] = None

    def __post_init__(self):
        for field in ("jsonl", "profile_dir"):
            v = getattr(self, field)
            if v is not None and not isinstance(v, str):
                raise TypeError(f"TelemetrySpec.{field} must be a path "
                                f"string or None, got {type(v).__name__}")

    def to_dict(self) -> dict:
        """Plain-JSON form; exact inverse of :meth:`from_dict`."""
        return {"spans": self.spans, "metrics": self.metrics,
                "jsonl": self.jsonl, "profile_dir": self.profile_dir}

    @classmethod
    def from_dict(cls, d: dict) -> "TelemetrySpec":
        return cls(spans=bool(d.get("spans", True)),
                   metrics=bool(d.get("metrics", True)),
                   jsonl=d.get("jsonl"),
                   profile_dir=d.get("profile_dir"))
