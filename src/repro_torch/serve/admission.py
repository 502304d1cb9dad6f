"""Admission control: per-tenant communication budgets and queue bounds.

The serving tier's admission decisions are made in the currency the paper
cares about — *scalars on the wire*. A tenant's request is billed the exact
number of scalars its plan's one-step consensus messages would transmit
(the combiner-registry accounting of :mod:`repro_torch.stream.costs`, the
same single source the simulator's measured counters reconcile against), so
a per-tenant :class:`BudgetSpec` is a communication budget in the sense of
Liu & Ihler 2014 (arXiv:1410.2653): it caps the information a tenant may
pull out of the sensor network per replenishment window.

Decisions are deterministic functions of (queue depth, budget ledger,
clock). The clock is injected — production servers run on
``time.monotonic``, the deterministic load harness and the admission tests
drive a :class:`VirtualClock` by hand so replenishment schedules are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["BudgetSpec", "BudgetState", "VirtualClock",
           "REJECT_QUEUE_FULL", "REJECT_BUDGET"]

#: admission rejection reasons, surfaced verbatim on tickets and as the
#: ``reason`` tag of the ``serve.rejected`` telemetry counter
REJECT_QUEUE_FULL = "queue_full"
REJECT_BUDGET = "budget_exhausted"


class VirtualClock:
    """A hand-advanced logical clock (seconds). Deterministic stand-in for
    ``time.monotonic`` in tests, benches, and the load harness."""

    def __init__(self, t0: float = 0.0) -> None:
        self.t = float(t0)

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clocks only move forward, got dt={dt!r}")
        self.t += float(dt)
        return self.t

    def __call__(self) -> float:
        return self.t


@dataclasses.dataclass(frozen=True)
class BudgetSpec:
    """Declarative per-tenant communication budget.

    scalars         — scalars the tenant may transmit per window; every
                      admitted request is charged its plan's exact one-step
                      message cost up front (so an accepted request is
                      never dropped later for lack of funds).
    replenish_every — logical seconds between refills; each refill restores
                      the ledger to the full ``scalars`` (reset, not
                      additive). ``None`` never replenishes — a hard
                      lifetime cap.
    """

    scalars: int
    replenish_every: Optional[float] = None

    def __post_init__(self):
        if int(self.scalars) < 0:
            raise ValueError(
                f"budget scalars must be >= 0, got {self.scalars!r}")
        object.__setattr__(self, "scalars", int(self.scalars))
        if self.replenish_every is not None:
            ev = float(self.replenish_every)
            if not ev > 0.0:
                raise ValueError(
                    f"replenish_every must be a positive interval (None "
                    f"disables replenishment), got {self.replenish_every!r}")
            object.__setattr__(self, "replenish_every", ev)

    def to_dict(self) -> dict:
        return {"scalars": self.scalars,
                "replenish_every": self.replenish_every}

    @classmethod
    def from_dict(cls, d: dict) -> "BudgetSpec":
        return cls(scalars=int(d["scalars"]),
                   replenish_every=d.get("replenish_every"))


class BudgetState:
    """One tenant's live ledger for a :class:`BudgetSpec`.

    ``try_charge`` first applies every replenishment the clock has earned
    (refill boundaries are multiples of ``replenish_every`` from
    registration time, independent of traffic), then admits iff the full
    cost fits in the remaining ledger — a request is either funded
    completely at admission or rejected, never half-billed.
    """

    def __init__(self, spec: BudgetSpec, now: float) -> None:
        self.spec = spec
        self.remaining = spec.scalars
        self._next_refill = (None if spec.replenish_every is None
                             else now + spec.replenish_every)

    def replenish(self, now: float) -> None:
        if self._next_refill is None or now < self._next_refill:
            return
        every = self.spec.replenish_every
        missed = int((now - self._next_refill) // every) + 1
        self.remaining = self.spec.scalars
        self._next_refill += missed * every

    def try_charge(self, cost: int, now: float) -> bool:
        if cost < 0:
            raise ValueError(f"negative request cost {cost!r}")
        self.replenish(now)
        if cost > self.remaining:
            return False
        self.remaining -= cost
        return True
