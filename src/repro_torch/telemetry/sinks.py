"""Telemetry sinks.

Every :class:`~repro_torch.telemetry.recorder.Recorder` aggregates in
memory; a :class:`JsonlSink` also appends each event, one JSON object per
line, to a durable log whose replay reconstructs the run's accounting
(:mod:`repro_torch.telemetry.replay`). The line format is the reference
package's, so each package reads the other's logs. The file is opened
lazily in append mode, so several recorders (or resumed runs) can extend
one log.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, List


def _jsonable(v):
    """Coerce tag/value payloads to plain JSON scalars and lists."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item"):          # numpy scalars, 0-d tensors
        return v.item()
    return str(v)


class JsonlSink:
    """Append-only JSONL event log (one event object per line)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = None

    def write(self, event: dict) -> None:
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a")
        self._f.write(json.dumps(
            {k: _jsonable(v) for k, v in event.items()}) + "\n")

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __del__(self):
        self.close()


def iter_jsonl(path: str) -> Iterator[dict]:
    """Stream events back out of a JSONL log."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def read_jsonl(path: str) -> List[dict]:
    """The whole event log as a list (see :func:`iter_jsonl` to stream)."""
    return list(iter_jsonl(path))
