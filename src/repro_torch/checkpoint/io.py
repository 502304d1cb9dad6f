"""Checkpoints: pytrees of tensors (training states) and streaming state,
as flat arrays in ``arrays.npz`` and JSON meta in ``manifest.json``.

Layout: ``<dir>/step_<N>/arrays.npz + manifest.json``, written to
``step_<N>.tmp`` and renamed into place, so a reader never sees a half
written step. The manifest records each array's dtype and shape and
carries the meta under ``extra``; JSON float reprs round-trip float64
exactly. The layout and the pytree keys (paths joined by '/', NamedTuple
fields by name) are the reference package's, so either package reads the
other's checkpoints. numpy has no bfloat16: a bfloat16 leaf is stored as
its raw 2-byte words (``|V2``, as the reference's ``np.savez`` writes it)
with ``bfloat16`` in the manifest, which :func:`restore` reads back
exactly.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_BF16 = "bfloat16"


def latest_step(directory: str) -> Optional[int]:
    """The largest N of the finished ``step_<N>`` entries, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _write(directory: str, step: int, arrays: Dict[str, np.ndarray],
           dtypes: Dict[str, str], meta: Dict) -> str:
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "dtypes": dtypes,
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "extra": meta,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_state(directory: str, step: int, arrays: Dict[str, np.ndarray],
               meta: Dict) -> str:
    """Save a flat name -> array dict and a JSON meta blob atomically at
    ``<directory>/step_<step>``; returns that path."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return _write(directory, step, arrays,
                  {k: str(v.dtype) for k, v in arrays.items()}, meta)


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


# ------------------------------------------------------------------ pytrees
def _leaves_with_path(tree, path=()) -> Iterator[Tuple[str, Any]]:
    """('/'-joined path, leaf) pairs in the reference's order: dict keys
    sorted, NamedTuple fields by name in field order, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves_with_path(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array ``np.savez`` writes and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")     # keeps 0-d arrays 0-d
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(like, values: Iterator):
    """``like``'s structure with its leaves taken from ``values`` in the
    order of :func:`_leaves_with_path`."""
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], values) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), values)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values) for v in like)
    return next(values)


def save(directory: str, step: int, tree, extra: Optional[Dict] = None
         ) -> str:
    """Save a pytree (nested dicts, NamedTuples and sequences of tensors,
    e.g. a ``TrainState`` or ``ConsensusState``) at
    ``<directory>/step_<step>``, keys '/'-joined paths as the reference
    builds them; returns the final path."""
    arrays, dtypes = {}, {}
    for key, leaf in _leaves_with_path(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    return _write(directory, step, arrays, dtypes, extra or {})


def restore(directory: str, step: int, like) -> Any:
    """Restore into the structure of ``like`` (a pytree template of
    tensors): each leaf takes the template leaf's dtype and device. A shape
    that differs from the template's raises. A leaf the manifest records as
    ``bfloat16`` (raw 2-byte words) is read exactly."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f)["dtypes"]
    vals = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in _leaves_with_path(like):
            if key not in data.files:
                raise KeyError(f"checkpoint {path} has no array {key!r}")
            t = _from_numpy(data[key], dtypes[key])
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)},"
                                 f" template {tuple(leaf.shape)}")
            vals.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return _rebuild(like, iter(vals))
