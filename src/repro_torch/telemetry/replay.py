"""Replay: reconstruct run accounting from a telemetry event stream.

The network layer emits one counter event per message transition
(``net.send`` / ``net.drop`` / ``net.deliver``, each valued at the
message's scalar count), so a JSONL log (or the in-memory event list) is a
complete, ordered record of the bandwidth ledger. Replaying it rebuilds
the exact :class:`~repro_torch.stream.network.Network` counters, the
in-flight remainders included, and with them the scalar-conservation
identity ``sent == delivered + dropped + in_flight``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .sinks import read_jsonl

#: event names the network layer emits, in ledger order
NET_EVENTS = ("net.send", "net.drop", "net.deliver")


def read_events(path: str) -> List[dict]:
    """Load a JSONL event log (:func:`repro_torch.telemetry.sinks.
    read_jsonl`, re-exported here because replay is its main reader)."""
    return read_jsonl(path)


def replay_network_counters(events: List[dict]) -> Dict[str, int]:
    """Rebuild the full :class:`Network` bandwidth ledger from events:
    every counter of ``Network.counters_dict()`` plus the derived
    ``in_flight`` / ``scalars_in_flight`` remainders; exact by
    construction, since every transition was logged with its scalar
    count."""
    msgs = dict.fromkeys(NET_EVENTS, 0)
    scal = dict.fromkeys(NET_EVENTS, 0)
    for ev in events:
        name = ev.get("name")
        if ev.get("kind") == "counter" and name in msgs:
            msgs[name] += 1
            scal[name] += int(ev["value"])
    return {
        "msgs_sent": msgs["net.send"],
        "msgs_dropped": msgs["net.drop"],
        "msgs_delivered": msgs["net.deliver"],
        "scalars_sent": scal["net.send"],
        "scalars_dropped": scal["net.drop"],
        "scalars_delivered": scal["net.deliver"],
        "in_flight": msgs["net.send"] - msgs["net.drop"]
        - msgs["net.deliver"],
        "scalars_in_flight": scal["net.send"] - scal["net.drop"]
        - scal["net.deliver"],
    }


def replay_comm_scalars(events: List[dict]) -> int:
    """Total scalars transmitted, reconstructed from the log (equals
    ``Network.scalars_sent``)."""
    return replay_network_counters(events)["scalars_sent"]


def timeline_from_events(events: List[dict],
                         metric: str) -> Tuple[np.ndarray, np.ndarray]:
    """(rounds, values) for one timeline metric out of a raw event list."""
    pts = [(ev["round"], ev["value"]) for ev in events
           if ev.get("kind") == "point" and ev.get("name") == metric]
    if not pts:
        raise KeyError(f"no timeline points for {metric!r} in event log")
    return (np.asarray([r for r, _ in pts], dtype=np.int64),
            np.asarray([v for _, v in pts], dtype=np.float64))
