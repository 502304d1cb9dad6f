"""Durable checkpoints of streaming state.

:func:`save_state`/:func:`load_state` move a flat name -> array dict with a
JSON meta blob through the reference's atomic ``step_<N>/arrays.npz +
manifest.json`` layout; :func:`save_stream`/:func:`restore_stream` capture
a full :class:`~repro_torch.stream.simulator.StreamSimulator` mid-stream so
a killed fleet restores to identical ``estimate_at(t)`` trajectories. A
directory the reference's ``save_stream`` wrote loads with
:func:`load_state`. The pytree ``save``/``restore`` serve training and come
with the training slice.
"""
from .io import (latest_step, load_state, restore_stream, save_state,
                 save_stream)

__all__ = ["latest_step", "save_state", "load_state", "save_stream",
           "restore_stream"]
