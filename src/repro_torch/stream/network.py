"""Message-network model: per-round link schedules, drops, delivery delay.

Communication in the simulator is explicit: every estimate that moves
between sensors is a :class:`Message` with a scalar count, pushed through a
:class:`Network` that may refuse the link this round (gossip schedules),
drop the message outright, or delay delivery by a fixed latency plus random
jitter — the staleness/asynchrony regime of dynamic-consensus estimation
(George 2018; Rahimian & Jadbabaie 2016). All randomness comes from one
seeded generator consumed in deterministic iteration order, so a simulation
is exactly reproducible. The generators are numpy ``RandomState``s, so the
port delivers the reference's message sequences for the same seeds.

With a live telemetry recorder every message transition is logged as a
``net.send`` / ``net.drop`` / ``net.deliver`` counter valued at its scalar
count, so a JSONL log replays the exact bandwidth ledger
(:mod:`repro_torch.telemetry.replay`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry.recorder import NULL_RECORDER


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Network behavior knobs.

    drop_prob — probability a sent message never arrives (bandwidth is still
      spent: dropped messages count toward scalars_sent).
    delay — fixed delivery latency in rounds (0 = arrives the same round).
    jitter — extra uniform random latency in {0, ..., jitter}.
    link_prob — per-round probability a directed link is usable at all
      (asynchronous gossip schedules; refusal costs no bandwidth).
    seed — None (the default) lets an owner inject its generator (the
      simulator threads one from its own seed); an explicit int pins a
      private legacy ``RandomState(seed)`` regardless of injection.
    """
    drop_prob: float = 0.0
    delay: int = 0
    jitter: int = 0
    link_prob: float = 1.0
    seed: Optional[int] = None


@dataclasses.dataclass
class Message:
    src: int
    dst: int
    payload: Any
    n_scalars: int
    created: int      # round the message was sent
    deliver_at: int   # round it becomes visible at dst


class Network:
    """Directed links with exact bandwidth accounting and a delivery queue."""

    def __init__(self, links: Sequence[Tuple[int, int]],
                 config: NetworkConfig = NetworkConfig(),
                 rng: Optional[np.random.RandomState] = None,
                 recorder=None) -> None:
        self.links = tuple(links)
        self._link_set = set(self.links)
        self.config = config
        #: telemetry recorder (see the module docstring)
        self.recorder = NULL_RECORDER if recorder is None else recorder
        if config.seed is not None:
            self._rng = np.random.RandomState(config.seed)
        elif rng is not None:
            self._rng = rng
        else:
            self._rng = np.random.RandomState(0)
        self._queue: List[Message] = []
        self.msgs_sent = 0
        self.msgs_dropped = 0
        self.msgs_delivered = 0
        self.scalars_sent = 0
        self.scalars_dropped = 0
        self.scalars_delivered = 0

    def link_active(self, rnd: int, src: int, dst: int) -> bool:
        """Whether the (src, dst) link is schedulable this round."""
        if (src, dst) not in self._link_set:
            return False
        if self.config.link_prob >= 1.0:
            return True
        return bool(self._rng.rand() < self.config.link_prob)

    def send(self, rnd: int, src: int, dst: int, payload: Any,
             n_scalars: int, extra_delay: int = 0) -> bool:
        """Transmit; returns False if the message was dropped in flight.
        ``extra_delay`` adds rounds of latency on top of the configured
        delay/jitter (replayed stale copies arrive late by construction)."""
        self.msgs_sent += 1
        self.scalars_sent += int(n_scalars)
        rec = self.recorder
        if rec.enabled:
            rec.inc("net.send", int(n_scalars), src=src, dst=dst, round=rnd)
        if self.config.drop_prob > 0.0 and \
                self._rng.rand() < self.config.drop_prob:
            self.msgs_dropped += 1
            self.scalars_dropped += int(n_scalars)
            if rec.enabled:
                rec.inc("net.drop", int(n_scalars), src=src, dst=dst,
                        round=rnd)
            return False
        lat = self.config.delay + int(extra_delay)
        if self.config.jitter > 0:
            lat += int(self._rng.randint(self.config.jitter + 1))
        self._queue.append(Message(src=src, dst=dst, payload=payload,
                                   n_scalars=int(n_scalars), created=rnd,
                                   deliver_at=rnd + lat))
        return True

    def deliver(self, rnd: int) -> List[Message]:
        """Pop every message due by round ``rnd``, in deterministic order."""
        due = [m for m in self._queue if m.deliver_at <= rnd]
        self._queue = [m for m in self._queue if m.deliver_at > rnd]
        due.sort(key=lambda m: (m.deliver_at, m.created, m.src, m.dst))
        self.msgs_delivered += len(due)
        self.scalars_delivered += sum(m.n_scalars for m in due)
        if self.recorder.enabled:
            for m in due:
                self.recorder.inc("net.deliver", m.n_scalars, src=m.src,
                                  dst=m.dst, round=rnd, created=m.created)
        return due

    @property
    def in_flight(self) -> int:
        return len(self._queue)

    @property
    def scalars_in_flight(self) -> int:
        return sum(m.n_scalars for m in self._queue)

    # --------------------------------------------------------- durability
    _COUNTERS = ("msgs_sent", "msgs_dropped", "msgs_delivered",
                 "scalars_sent", "scalars_dropped", "scalars_delivered")

    def counters_dict(self) -> dict:
        return {k: int(getattr(self, k)) for k in self._COUNTERS}

    def set_counters(self, counters: dict) -> None:
        for k in self._COUNTERS:
            setattr(self, k, int(counters[k]))


def rng_state_to_json(rng: np.random.RandomState) -> list:
    """A RandomState's full MT19937 state as plain JSON values. Every entry
    round-trips exactly: the key vector is uint32 ints, and json keeps the
    cached gaussian's float64 repr."""
    kind, keys, pos, has_gauss, cached = rng.get_state()
    return [kind, [int(v) for v in keys], int(pos), int(has_gauss),
            float(cached)]


def rng_state_from_json(rng: np.random.RandomState, state: list) -> None:
    kind, keys, pos, has_gauss, cached = state
    rng.set_state((kind, np.asarray(keys, dtype=np.uint32), int(pos),
                   int(has_gauss), float(cached)))
