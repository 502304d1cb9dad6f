"""Recorders: hierarchical spans, a metrics registry, and the null default.

Two implementations of one implicit protocol:

* :class:`NullRecorder` (the module singleton :data:`NULL_RECORDER`) — the
  default every instrumented code path receives when telemetry is off.
  Every method is a constant no-op and ``span`` returns one shared,
  stateless context manager, so hot paths stay allocation-free; callers
  guard tag-building work, and every read that waits for the device,
  behind ``recorder.enabled``.
* :class:`Recorder` — the live implementation. Spans nest (a span's
  ``path`` is the slash-joined stack of open span names) and carry wall
  time plus ``new_compiles``, the kernel-library builds
  (``kernels/build.py::LIBRARIES.builds``) paid while they were open;
  counters accumulate, gauges keep the last value, histograms keep
  observations, and ``point`` records (round, value) timeline samples.
  Every event lands in the in-memory list and, when the spec names a
  ``jsonl`` path, in the append-only JSONL sink.

While any real span is open the recorder is also *active* for kernel
tags: :func:`record_kernel_trace`, called from the kernel dispatch layer
(``repro_torch.kernels.cl.ops``), lands kernel-kind, path and shape events
on the innermost active recorder. The reference tags while jit traces a
compiled region, so each compiled shape is tagged once and a warm call
emits none. PyTorch has no trace: here a recorder keeps the first dispatch
of each (name, tags) it sees and drops the rest, so a fresh session's cold
fit is tagged and a warm fit emits nothing, as in the reference. The set
of seen tags lives on the recorder, not in this module. Dispatchers call
the hook only when :func:`tracing_active` says a recorder has an open span,
so with telemetry off they build no tag.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kernels.build import LIBRARIES
from .sinks import JsonlSink
from .spec import TelemetrySpec

__all__ = ["NullRecorder", "NULL_RECORDER", "Recorder", "TelemetrySnapshot",
           "make_recorder", "record_kernel_trace", "tracing_active"]


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The zero-overhead default: every method is a no-op."""

    __slots__ = ()
    enabled = False

    def span(self, name, **tags):
        return _NULL_SPAN

    def inc(self, name, value=1, **tags):
        pass

    def gauge(self, name, value, **tags):
        pass

    def observe(self, name, value, **tags):
        pass

    def event(self, name, **tags):
        pass

    def point(self, metric, rnd, value):
        pass

    def mark(self) -> int:
        return 0

    def snapshot(self, since: int = 0):
        return None

    def flush(self):
        pass


NULL_RECORDER = NullRecorder()

#: stack of recorders with an open span: the kernel-tag target
_ACTIVE: List["Recorder"] = []


def tracing_active() -> bool:
    """Whether a recorder has an open span. Dispatchers check this before
    they build a kernel tag, so telemetry off costs one call per
    dispatch."""
    return bool(_ACTIVE)


def record_kernel_trace(name: str, **tags) -> None:
    """Tag the innermost active recorder with a kernel-dispatch event (the
    first dispatch of each (name, tags) per recorder; see the module
    docstring). With telemetry off (no active recorder) this is one list
    check."""
    if _ACTIVE:
        _ACTIVE[-1]._kernel_tag(name, tags)


class _Span:
    """One open span; records start/end events and restores the stack,
    also when its body raises."""

    __slots__ = ("rec", "name", "_t0", "_c0")

    def __init__(self, rec: "Recorder", name: str, tags: dict):
        self.rec = rec
        self.name = name
        if not rec._stack and rec.spec.profile_dir is not None:
            rec._profile_start()
        rec._stack.append(name)
        _ACTIVE.append(rec)
        self._c0 = LIBRARIES.builds
        try:
            rec._emit("span_start", "/".join(rec._stack), tags=tags or None)
        except BaseException:
            # the span never opens: undo the pushes and the profiler start
            _ACTIVE.pop()
            rec._stack.pop()
            if not rec._stack:
                rec._profile_discard()
            raise
        self._t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        rec = self.rec
        try:
            rec._emit("span_end", "/".join(rec._stack), value=dur,
                      new_compiles=LIBRARIES.builds - self._c0)
        finally:
            rec._stack.pop()
            _ACTIVE.pop()
            if not rec._stack:
                rec._profile_stop()
        return False


class Recorder:
    """Live telemetry recorder (see the module docstring). With
    ``spec.profile_dir`` set, each outermost span writes one
    ``torch.profiler`` trace into that directory."""

    enabled = True

    def __init__(self, spec: Optional[TelemetrySpec] = None) -> None:
        self.spec = spec if spec is not None else TelemetrySpec()
        self.events: List[dict] = []
        self._seq = 0
        self._t0 = time.perf_counter()
        self._stack: List[str] = []
        self._sink = (JsonlSink(self.spec.jsonl)
                      if self.spec.jsonl else None)
        self._prof = None
        self._tagged = set()

    # ------------------------------------------------------------ emission
    def _emit(self, kind: str, name: str, value=None, tags=None,
              rnd=None, new_compiles=None) -> None:
        ev = {"seq": self._seq, "t": time.perf_counter() - self._t0,
              "kind": kind, "name": name}
        if value is not None:
            ev["value"] = value
        if rnd is not None:
            ev["round"] = int(rnd)
        if new_compiles is not None:
            ev["new_compiles"] = int(new_compiles)
        if tags:
            ev["tags"] = tags
        self._seq += 1
        self.events.append(ev)
        if self._sink is not None:
            self._sink.write(ev)

    def _kernel_tag(self, name: str, tags: dict) -> None:
        key = (name, repr(sorted(tags.items())))
        if key not in self._tagged:
            self._tagged.add(key)
            self.event(name, **tags)

    # ------------------------------------------------------------- recording
    def span(self, name: str, **tags):
        """Open a hierarchical span (a context manager); on exit records
        wall seconds and the kernel-library builds paid meanwhile."""
        if not self.spec.spans:
            return _NULL_SPAN
        return _Span(self, name, tags)

    def inc(self, name: str, value=1, **tags) -> None:
        if self.spec.metrics:
            self._emit("counter", name, value=value, tags=tags or None)

    def gauge(self, name: str, value, **tags) -> None:
        if self.spec.metrics:
            self._emit("gauge", name, value=value, tags=tags or None)

    def observe(self, name: str, value, **tags) -> None:
        if self.spec.metrics:
            self._emit("hist", name, value=value, tags=tags or None)

    def event(self, name: str, **tags) -> None:
        self._emit("event", name, tags=tags or None)

    def point(self, metric: str, rnd: int, value) -> None:
        """One any-time timeline sample: metric value at stream round."""
        if self.spec.metrics:
            self._emit("point", metric, value=float(value), rnd=rnd)

    # ------------------------------------------------------------ profiling
    def _profile_start(self) -> None:
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    supported_activities)
        acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                if a in supported_activities()]
        prof = profile(activities=acts)
        if ProfilerActivity.CUDA in acts and torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.start()
        self._prof = prof

    def _profile_discard(self) -> None:
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.stop()

    def _profile_stop(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.spec.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.spec.profile_dir,
            f"repro_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json"))

    # ----------------------------------------------------------- reading out
    def mark(self) -> int:
        """Current event index: pass to :meth:`snapshot` to scope one
        verb's events out of a long-lived recorder."""
        return len(self.events)

    def snapshot(self, since: int = 0) -> "TelemetrySnapshot":
        """Aggregate events[since:] into a :class:`TelemetrySnapshot`."""
        return TelemetrySnapshot.from_events(self.events[since:])

    def flush(self) -> None:
        if self._sink is not None:
            self._sink.flush()

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()


@dataclasses.dataclass
class TelemetrySnapshot:
    """The in-memory aggregate of one run's events.

    events     — the raw event dicts (same schema as the JSONL log).
    counters   — name -> accumulated total.
    gauges     — name -> last recorded value.
    histograms — name -> list of observations.
    spans      — span path -> {"count", "total_s", "new_compiles"}.
    points     — metric -> list of (round, value) timeline samples.
    """

    events: List[dict]
    counters: Dict[str, float]
    gauges: Dict[str, float]
    histograms: Dict[str, List[float]]
    spans: Dict[str, dict]
    points: Dict[str, List[Tuple[int, float]]]

    @classmethod
    def from_events(cls, events: List[dict]) -> "TelemetrySnapshot":
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, List[float]] = {}
        spans: Dict[str, dict] = {}
        points: Dict[str, List[Tuple[int, float]]] = {}
        for ev in events:
            kind, name = ev["kind"], ev["name"]
            if kind == "counter":
                counters[name] = counters.get(name, 0) + ev["value"]
            elif kind == "gauge":
                gauges[name] = ev["value"]
            elif kind == "hist":
                hists.setdefault(name, []).append(ev["value"])
            elif kind == "span_end":
                agg = spans.setdefault(
                    name, {"count": 0, "total_s": 0.0, "new_compiles": 0})
                agg["count"] += 1
                agg["total_s"] += ev["value"]
                agg["new_compiles"] += ev.get("new_compiles", 0)
            elif kind == "point":
                points.setdefault(name, []).append(
                    (ev["round"], ev["value"]))
        return cls(events=events, counters=counters, gauges=gauges,
                   histograms=hists, spans=spans, points=points)

    def counter(self, name: str, **tags) -> float:
        """Accumulated total of one counter restricted to increments whose
        tags include every given ``key=value`` pair."""
        total = 0.0
        for ev in self.events:
            if ev["kind"] != "counter" or ev["name"] != name:
                continue
            evt = ev.get("tags") or {}
            if all(evt.get(k) == v for k, v in tags.items()):
                total += ev["value"]
        return total

    def timeline(self, metric: str) -> Tuple[np.ndarray, np.ndarray]:
        """(rounds, values) arrays for one recorded timeline metric."""
        if metric not in self.points:
            raise KeyError(
                f"no timeline recorded for {metric!r}; have "
                f"{sorted(self.points)}")
        pts = self.points[metric]
        return (np.asarray([r for r, _ in pts], dtype=np.int64),
                np.asarray([v for _, v in pts], dtype=np.float64))


def make_recorder(spec) -> "Recorder | NullRecorder":
    """The recorder for a plan's telemetry declaration: the shared
    :data:`NULL_RECORDER` when ``spec`` is None/falsy, a live
    :class:`Recorder` otherwise. Accepts an existing recorder unchanged
    (so simulators can share a session's recorder)."""
    if spec is None or spec is False:
        return NULL_RECORDER
    if isinstance(spec, (Recorder, NullRecorder)):
        return spec
    if isinstance(spec, dict):
        spec = TelemetrySpec.from_dict(spec)
    if not isinstance(spec, TelemetrySpec):
        raise TypeError(f"expected TelemetrySpec, Recorder, or None; got "
                        f"{type(spec).__name__}")
    return Recorder(spec)
