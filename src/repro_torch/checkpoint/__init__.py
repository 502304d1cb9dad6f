"""Durable checkpoints: training pytrees and streaming state.

:func:`save`/:func:`restore` move a pytree of tensors (a ``TrainState``,
a ``ConsensusState``, its ``theta_bar``) through the reference's atomic
``step_<N>/arrays.npz + manifest.json`` layout with the reference's
'/'-joined keys; :func:`save_state`/:func:`load_state` move a flat name ->
array dict with a JSON meta blob; :func:`save_stream`/
:func:`restore_stream` capture a full
:class:`~repro_torch.stream.simulator.StreamSimulator` mid-stream so a
killed fleet restores to identical ``estimate_at(t)`` trajectories.
Directories the reference wrote load here, and the reverse.
"""
from .io import (latest_step, load_state, restore, restore_stream, save,
                 save_state, save_stream)

__all__ = ["latest_step", "save", "restore", "save_state", "load_state",
           "save_stream", "restore_stream"]
