"""Shape-stable growing sample buffer for streaming estimation, on a device.

The buffer zero-pads to a capacity that doubles on overflow, so every
consumer sees a (capacity, p) tensor whose shape changes only O(log n)
times over a stream, and expresses "only the first n rows are real" with
per-node fit weights (0/1 prefix masks, optionally windowed or discounted),
which the batched engine and the fused score kernel treat exactly.

The pool lives on the estimator's device: ``append`` copies only the new
rows, growth doubles on the device, and the weight masks are built there
from the per-node counts (a (p, capacity) float32 mask at the field scale
is hundreds of MB, which a host build and upload would pay per refit).
``rows`` and ``data`` hand out numpy, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


def as_device_rows(rows, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """``rows`` (numpy, nested lists or a tensor) as a tensor of ``dtype``
    on ``device``; read-only numpy arrays are copied first."""
    if not isinstance(rows, torch.Tensor):
        rows = np.asarray(rows)
        if not rows.flags.writeable:
            rows = rows.copy()
        rows = torch.as_tensor(rows)
    return rows.to(device=device, dtype=dtype)


def discount_table(discount: float, capacity: int) -> np.ndarray:
    """float32 ``discount ** age`` for ages 0 .. capacity-1, taken in
    float64 and then cast, as the reference's weights are."""
    return (float(discount) ** np.arange(capacity, dtype=np.int64)
            ).astype(np.float32)


class SampleBuffer:
    """Append-only (capacity, p) sample store with power-of-two growth."""

    def __init__(self, p: int, capacity: int = 64,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        if capacity < 1:
            raise ValueError("capacity must be positive")
        self._X = torch.zeros((int(capacity), int(p)), dtype=dtype,
                              device=resolve_device(device))
        self.n = 0

    @property
    def p(self) -> int:
        return self._X.shape[1]

    @property
    def capacity(self) -> int:
        return self._X.shape[0]

    @property
    def device(self) -> torch.device:
        return self._X.device

    @property
    def tensor(self) -> torch.Tensor:
        """The zero-padded (capacity, p) pool on its device (live, do not
        mutate)."""
        return self._X

    @property
    def data(self) -> np.ndarray:
        """The zero-padded (capacity, p) pool as numpy."""
        return self._X.cpu().numpy()

    @property
    def rows(self) -> np.ndarray:
        """Only the real samples, shape (n, p), as numpy."""
        return self._X[: self.n].cpu().numpy()

    def load(self, pool, n: int) -> None:
        """Replace the pool by ``pool`` (its capacity included) holding
        ``n`` real rows."""
        self._X = as_device_rows(pool, self._X.dtype, self._X.device).clone()
        self.n = int(n)

    def append(self, rows) -> None:
        rows = as_device_rows(rows, self._X.dtype, self._X.device)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.shape[1] != self.p:
            raise ValueError(f"expected {self.p} columns, got "
                             f"{tuple(rows.shape)}")
        need = self.n + rows.shape[0]
        cap = self.capacity
        if need > cap:
            while cap < need:
                cap *= 2
            grown = torch.zeros((cap, self.p), dtype=self._X.dtype,
                                device=self._X.device)
            grown[: self.n] = self._X[: self.n]
            self._X = grown
        self._X[self.n: need] = rows
        self.n = need

    def _counts(self, counts) -> np.ndarray:
        counts = np.asarray(counts, dtype=np.int64)
        if np.any(counts > self.n):
            raise ValueError("count exceeds samples in buffer")
        return counts

    def prefix_masks(self, counts) -> torch.Tensor:
        """(len(counts), capacity) float32 0/1 masks on the pool's device:
        row i covers the first ``counts[i]`` samples."""
        return self.window_weights(counts)

    def window_weights(self, counts, window: Optional[int] = None,
                       discount: Optional[float] = None) -> torch.Tensor:
        """(len(counts), capacity) float32 per-row fit weights over the
        pool, on its device.

        With both knobs None this is the 0/1 prefix mask; ``window`` keeps
        only each node's most recent ``window`` observed rows; ``discount``
        in (0, 1) weighs a node's age-k row ``discount**k`` (its newest row
        weighs 1). The two compose. Values equal the reference's bit for
        bit: the powers are taken on the host in float64 and cast to
        float32, then gathered by age on the device.
        """
        counts = self._counts(counts)
        dev = self._X.device
        c = torch.as_tensor(counts, device=dev)[:, None]
        idx = torch.arange(self.capacity, device=dev)[None, :]
        keep = idx < c
        if window is not None:
            keep &= idx >= c - int(window)
        if discount is None or discount >= 1.0:
            return keep.to(torch.float32)
        table = torch.as_tensor(discount_table(discount, self.capacity),
                                device=dev)
        age = torch.clamp(c - 1 - idx, min=0)
        return torch.where(keep, table[age], torch.zeros((), device=dev))
