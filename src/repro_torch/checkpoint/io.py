"""Streaming-state checkpoints: flat arrays in ``arrays.npz`` and JSON
meta in ``manifest.json``, numpy and json only.

Layout: ``<dir>/step_<N>/arrays.npz + manifest.json``, written to
``step_<N>.tmp`` and renamed into place, so a reader never sees a half
written step. The manifest records each array's dtype and shape and
carries the meta under ``extra``; JSON float reprs round-trip float64
exactly. The layout is the reference package's, so either package reads
the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np


def latest_step(directory: str) -> Optional[int]:
    """The largest N of the finished ``step_<N>`` entries, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def save_state(directory: str, step: int, arrays: Dict[str, np.ndarray],
               meta: Dict) -> str:
    """Save a flat name -> array dict and a JSON meta blob atomically at
    ``<directory>/step_<step>``; returns that path."""
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "extra": meta,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_state(directory: str,
               step: Optional[int] = None) -> Tuple[Dict[str, np.ndarray],
                                                    Dict]:
    """Inverse of :func:`save_state`; ``step=None`` loads the latest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no step_<N> checkpoints under {directory!r}")
    path = os.path.join(directory, f"step_{step}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)["extra"]
    return arrays, meta


def save_stream(directory: str, step: int, sim) -> str:
    """Durable mid-stream checkpoint of a
    :class:`~repro_torch.stream.simulator.StreamSimulator`: everything its
    ``state_dict`` reports (buffers, warm thetas, fitted banks, owed and
    in-flight messages, counters and every RNG state)."""
    arrays, meta = sim.state_dict()
    return save_state(directory, step, arrays, meta)


def restore_stream(directory: str, sim, step: Optional[int] = None):
    """Restore ``sim``, a fresh simulator of the same configuration (graph,
    pool, scheme, network, faults, seed), in place from a
    :func:`save_stream` checkpoint (the latest when ``step`` is None);
    returns ``sim``."""
    arrays, meta = load_state(directory, step)
    sim.load_state(arrays, meta)
    return sim
