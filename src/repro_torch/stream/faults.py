"""Declarative fault injection for the streaming simulator.

A :class:`FaultPlan` is the frozen, hashable, JSON-serializable description
of one hostile-network scenario — who crashes when, who lies on the wire
and how, whether stale messages get replayed, and when the environment's
true parameter drifts. The :class:`~repro_torch.stream.simulator.
StreamSimulator` *executes* the plan; every random draw it requires (noise
lies, replay coin-flips) comes from a generator seeded from the
simulator's one seed, so a hostile scenario is exactly as reproducible as
a clean one.

Fault semantics (the "liar on the wire" model):

* **crash** — a crashed sensor stops sampling, stops transmitting, and
  loses messages addressed to it while down; its last local fit persists
  (the home sensor keeps reporting its stale view). On ``restart_at`` the
  node resumes with its buffer intact — a process restart, not data loss.
* **byzantine** — corruption applies to *outbound messages only*: the
  node's own local estimation stays honest (its sensor hardware works; its
  network stack lies). This matches the pseudo-likelihood setting, where
  each edge block has exactly two owners — a corrupted *home* fit would
  exceed every symmetric breakdown point, so the meaningful defense is the
  receiver anchoring robust fusion on its own honest fit (see the
  ``trimmed_mean`` / ``krum`` combiners).
* **replay** — after a successful send, an adversary may re-inject the
  link's *previous* payload with extra delay: a stale, duplicated message.
  Replayed copies spend real bandwidth (they are billed as sent scalars)
  and are deduplicated receiver-side by the freshest-version-wins rule.
* **drift** — at each change-point the environment's true parameter jumps
  by a random perturbation and the *unseen* remainder of the sample pool
  is re-drawn from the drifted model (``family.exact_sample``); rows a
  sensor has already seen keep their values. The draws are keyed off the
  simulator's seed and the change-point round alone, so a restored
  simulator re-draws the same tail.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

#: outbound-message corruption models a Byzantine node may run
BYZANTINE_KINDS = ("sign_flip", "scaled_noise", "fixed_value")


def _require_nonneg_int(value, what: str) -> int:
    iv = int(value)
    if iv < 0:
        raise ValueError(f"{what} must be a round index >= 0, got {value!r}")
    return iv


@dataclasses.dataclass(frozen=True)
class CrashSpec:
    """Node ``node`` is down during rounds [``at``, ``restart_at``).

    ``restart_at=None`` means it never comes back.
    """
    node: int
    at: int
    restart_at: Optional[int] = None

    def __post_init__(self):
        _require_nonneg_int(self.at, "crash time 'at'")
        if self.node < 0:
            raise ValueError(f"crash node must be >= 0, got {self.node!r}")
        if self.restart_at is not None and self.restart_at <= self.at:
            raise ValueError(
                f"restart_at ({self.restart_at!r}) must be strictly after "
                f"the crash round at={self.at!r}")

    def down(self, rnd: int) -> bool:
        return self.at <= rnd and (self.restart_at is None
                                   or rnd < self.restart_at)


@dataclasses.dataclass(frozen=True)
class ByzantineSpec:
    """Node ``node`` corrupts every outbound estimate from round ``start``.

    kind — "sign_flip" (sends -estimate), "scaled_noise" (adds
    ``scale``-sized Gaussian noise per transmitted scalar), or
    "fixed_value" (sends the colluding constant ``value`` for every
    parameter — several nodes with the same ``value`` collude exactly).
    """
    node: int
    kind: str = "sign_flip"
    start: int = 0
    scale: float = 5.0
    value: float = 3.0

    def __post_init__(self):
        if self.kind not in BYZANTINE_KINDS:
            raise ValueError(
                f"unknown byzantine kind {self.kind!r}; choose from "
                f"{list(BYZANTINE_KINDS)}")
        _require_nonneg_int(self.start, "byzantine start")
        if self.node < 0:
            raise ValueError(f"byzantine node must be >= 0, "
                             f"got {self.node!r}")
        if not np.isfinite(self.scale):
            raise ValueError(f"byzantine scale must be finite, "
                             f"got {self.scale!r}")
        if not np.isfinite(self.value):
            raise ValueError(f"byzantine value must be finite, "
                             f"got {self.value!r}")

    def active(self, rnd: int) -> bool:
        return rnd >= self.start


@dataclasses.dataclass(frozen=True)
class ReplaySpec:
    """After each successful send, replay the link's previous payload with
    probability ``prob``, arriving ``delay`` extra rounds late."""
    prob: float = 0.25
    delay: int = 3

    def __post_init__(self):
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(
                f"replay prob must be a probability in [0, 1], "
                f"got {self.prob!r}")
        if self.delay < 1:
            raise ValueError(f"replay delay must be >= 1 round "
                             f"(0 would not be stale), got {self.delay!r}")


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """At round ``at`` the true parameter jumps by a ``scale``-sized random
    perturbation on the free coordinates and unseen pool samples are
    re-drawn from the drifted model."""
    at: int
    scale: float = 0.5

    def __post_init__(self):
        _require_nonneg_int(self.at, "drift change-point 'at'")
        if not (np.isfinite(self.scale) and self.scale >= 0.0):
            raise ValueError(f"drift scale must be finite and >= 0, "
                             f"got {self.scale!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One hostile scenario: crash schedules, Byzantine corruption,
    message replay, parameter drift. Frozen and hashable, so a
    :class:`repro_torch.api.Plan` carrying one still keys the session cache."""
    crashes: Tuple[CrashSpec, ...] = ()
    byzantine: Tuple[ByzantineSpec, ...] = ()
    replay: Optional[ReplaySpec] = None
    drift: Tuple[DriftSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "crashes", tuple(self.crashes))
        object.__setattr__(self, "byzantine", tuple(self.byzantine))
        object.__setattr__(self, "drift", tuple(self.drift))
        for c in self.crashes:
            if not isinstance(c, CrashSpec):
                raise TypeError(f"crashes entries must be CrashSpec, "
                                f"got {type(c).__name__}")
        for b in self.byzantine:
            if not isinstance(b, ByzantineSpec):
                raise TypeError(f"byzantine entries must be ByzantineSpec, "
                                f"got {type(b).__name__}")
        for d in self.drift:
            if not isinstance(d, DriftSpec):
                raise TypeError(f"drift entries must be DriftSpec, "
                                f"got {type(d).__name__}")
        if self.replay is not None and not isinstance(self.replay,
                                                      ReplaySpec):
            raise TypeError(f"replay must be a ReplaySpec, "
                            f"got {type(self.replay).__name__}")

    # ------------------------------------------------------------- queries
    def crashed(self, node: int, rnd: int) -> bool:
        return any(c.node == node and c.down(rnd) for c in self.crashes)

    def byzantine_for(self, node: int, rnd: int) -> Optional[ByzantineSpec]:
        for b in self.byzantine:
            if b.node == node and b.active(rnd):
                return b
        return None

    def drift_at(self, rnd: int) -> Optional[DriftSpec]:
        for d in self.drift:
            if d.at == rnd:
                return d
        return None

    @property
    def empty(self) -> bool:
        return not (self.crashes or self.byzantine or self.drift
                    or self.replay is not None)

    # ------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        """Plain-JSON representation; exact inverse of :meth:`from_dict`."""
        return {
            "crashes": [dataclasses.asdict(c) for c in self.crashes],
            "byzantine": [dataclasses.asdict(b) for b in self.byzantine],
            "replay": (None if self.replay is None
                       else dataclasses.asdict(self.replay)),
            "drift": [dataclasses.asdict(d) for d in self.drift],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        rep = d.get("replay")
        return cls(
            crashes=tuple(CrashSpec(**c) for c in d.get("crashes", ())),
            byzantine=tuple(ByzantineSpec(**b)
                            for b in d.get("byzantine", ())),
            replay=None if rep is None else ReplaySpec(**rep),
            drift=tuple(DriftSpec(**s) for s in d.get("drift", ())),
        )
