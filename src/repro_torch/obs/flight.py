"""Async flight recorder: a bounded ring of structured wire events.

The asynchronous driver's pathologies (staleness spirals, starved
quorums, retry storms) are *sequencing* bugs — the per-commit
``RoundTrace`` aggregates are too coarse to reconstruct who was in
flight when. The flight recorder keeps the last ``capacity`` raw events
(dispatch / arrival / drop / retire / commit, each stamped with client
id, model version, and server clock) so a post-mortem can replay the
tail of the event history exactly. ``retire`` is an upload whose client
churned out while it was in the air (scenario dynamics); the
reference's recorder lists the asynchronous driver's ``retire`` event
nowhere in its vocabulary and so refuses it, which the port does not
copy.

Truncation semantics: the ring keeps the MOST RECENT ``capacity``
events; ``total`` counts every event ever recorded and ``truncated``
how many old events fell off the front. Dumps are JSONL, one event per
line, oldest surviving event first.
"""
from __future__ import annotations

import collections
import json
import pathlib

# the event vocabulary (report/check-schema validate against this)
EVENT_KINDS = ("dispatch", "arrival", "drop", "retire", "commit")


class FlightRecorder:
    """Bounded ring buffer of ``{"kind", "t", ...}`` event dicts."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.total = 0

    def record(self, kind: str, t: float, **fields) -> None:
        """Append one event; ``t`` is the simulated server clock."""
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown flight event kind {kind!r}; want one of "
                f"{EVENT_KINDS}")
        self.total += 1
        self._ring.append({"kind": kind, "t": float(t), **fields})

    @property
    def truncated(self) -> int:
        """Events that fell off the front of the ring."""
        return self.total - len(self._ring)

    def events(self) -> "list[dict]":
        """Surviving events, oldest first."""
        return list(self._ring)

    def stats(self) -> dict:
        return {"capacity": self.capacity, "total": self.total,
                "kept": len(self._ring), "truncated": self.truncated}

    def to_jsonl(self, path) -> pathlib.Path:
        """Dump the surviving events as JSONL (one event per line)."""
        path = pathlib.Path(path)
        with path.open("w") as f:
            for ev in self._ring:
                f.write(json.dumps(ev) + "\n")
        return path


class NullFlightRecorder:
    """No-op recorder backing the disabled-telemetry path."""

    __slots__ = ()
    capacity = 0
    total = 0
    truncated = 0

    def record(self, kind: str, t: float, **fields) -> None:
        pass

    def events(self) -> "list[dict]":
        return []

    def stats(self) -> dict:
        return {"capacity": 0, "total": 0, "kept": 0, "truncated": 0}


NULL_FLIGHT = NullFlightRecorder()
