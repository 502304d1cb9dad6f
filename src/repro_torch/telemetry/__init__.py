"""Telemetry: structured spans, a metrics registry, and pluggable sinks.

A frozen :class:`TelemetrySpec` on a :class:`~repro_torch.api.Plan` turns
recording on; the default is the shared :data:`NULL_RECORDER`, whose every
method is a no-op, so instrumented hot paths stay allocation-free and
bitwise unchanged when telemetry is off. A live recorder only reads: the
outputs with telemetry on are bitwise those with it off.

* :class:`Recorder` — hierarchical spans (wall time and the kernel-library
  builds paid), counters, gauges, histograms, per-round timeline points,
  and kernel-dispatch tags.
* sinks — every event lands in the in-memory aggregate (exposed as
  ``EstimateResult.telemetry`` / ``StreamResult.timeline(metric)``) and,
  when ``TelemetrySpec.jsonl`` names a path, in an append-only JSONL event
  log in the reference package's line format.
* :mod:`~repro_torch.telemetry.replay` — reconstructs the exact comm
  accounting (the :class:`~repro_torch.stream.network.Network` counters)
  from a JSONL log.
"""
from .recorder import (NULL_RECORDER, NullRecorder, Recorder,
                       TelemetrySnapshot, make_recorder, record_kernel_trace)
from .replay import (read_events, replay_comm_scalars,
                     replay_network_counters, timeline_from_events)
from .sinks import JsonlSink, read_jsonl
from .spec import TelemetrySpec

__all__ = [
    "TelemetrySpec", "Recorder", "NullRecorder", "NULL_RECORDER",
    "TelemetrySnapshot", "make_recorder", "record_kernel_trace",
    "JsonlSink", "read_jsonl", "read_events", "replay_network_counters",
    "replay_comm_scalars", "timeline_from_events",
]
