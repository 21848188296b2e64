"""Byte-accurate per-round communication accounting.

Counterpart of ``repro.comm.metrics`` (numpy only, as there).
``RoundTrace`` is the record the round driver accumulates: who was
scheduled, who delivered, how many encoded bytes moved each way, and the
simulated wall-clock the round cost. ``summarize`` and the
``cumulative_*`` helpers fold a trajectory of traces into the curves
benchmarks plot (loss vs bytes, loss vs simulated time); ``Transport`` is
the bundle a ``Session`` hands back for ``History`` assembly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RoundTrace:
    """One communication round, as observed on the (simulated) wire.

    Synchronous rounds leave the async-only fields at their defaults;
    asynchronous server steps (``repro.comm.async_driver``) additionally
    record which model ``version`` the step produced and the per-client
    ``staleness`` — for each committed client, how many server steps its
    base model lagged the server (NaN for clients not in the commit).
    ``sim_time_s`` is then the *server-clock increment* between commits,
    so ``cumulative_time`` yields the server-clock axis in both modes.

    Async field semantics differ per client: ``scheduled`` is the
    committed cohort plus clients whose upload was LOST in this commit
    window (so ``scheduled & ~delivered`` still counts drops), while
    ``bytes_down`` bills model broadcasts when they are *dispatched* —
    a client still in flight can carry ``bytes_down > 0`` in a trace
    whose ``scheduled`` row is False. Per-trace totals and cumulative
    curves are conserved in both modes; only the per-client pairing of
    ``bytes_down`` with ``scheduled`` is sync-specific.

    Population-mode (cohort) traces set ``ids`` to the cohort's client
    ids and ``population`` to the population size m: every per-client
    array is then cohort-length (``len(ids)``), never ``(m,)`` — at
    m ~ 10⁵ with q ~ 10⁻³ a trace stores ~100 rows instead of 100 000.
    Dense traces leave ``ids=None`` / ``population=0``; all aggregate
    properties work identically on both forms.
    """

    round: int
    scheduled: np.ndarray  # (m,) bool — asked to participate
    delivered: np.ndarray  # (m,) bool — scheduled and not dropped
    straggler: np.ndarray  # (m,) bool — delivered late (slowdown applied)
    bytes_up: np.ndarray  # (m,) encoded uplink bytes (0 if not delivered)
    bytes_down: np.ndarray  # (m,) broadcast bytes (0 if not scheduled)
    sim_time_s: float  # round wall-clock (sync) / server-clock delta (async)
    staleness: "np.ndarray | None" = None  # (m,) server steps of lag, NaN = absent
    version: int = -1  # model version this commit produced (-1 for sync)
    ids: "np.ndarray | None" = None  # cohort client ids (population mode)
    population: int = 0  # population size m (0 = dense trace)

    @property
    def clients(self) -> int:
        """Denominator for participation: population m, or the dense
        per-client axis length."""
        return self.population if self.population else len(self.delivered)

    @property
    def total_bytes(self) -> int:
        return int(self.bytes_up.sum() + self.bytes_down.sum())

    @property
    def mean_staleness(self) -> float:
        """Mean staleness over committed clients (0.0 for sync rounds).

        All-NaN rows (a commit that delivered nobody — only possible in
        degenerate configs, but representable) are defined as 0.0, not
        NaN: the mean is over committed clients and an empty cohort has
        no lag to report.
        """
        if self.staleness is None:
            return 0.0
        hit = ~np.isnan(self.staleness)
        return float(self.staleness[hit].mean()) if hit.any() else 0.0

    def to_dict(self) -> dict:
        """JSON-able record of this trace (``History.to_jsonl`` line).

        Per-client NaN staleness (clients absent from the commit) is
        encoded as ``null`` — strict JSON has no NaN token.
        """
        return {
            "round": int(self.round),
            "scheduled": [bool(v) for v in self.scheduled],
            "delivered": [bool(v) for v in self.delivered],
            "straggler": [bool(v) for v in self.straggler],
            "bytes_up": [float(v) for v in self.bytes_up],
            "bytes_down": [float(v) for v in self.bytes_down],
            "sim_time_s": float(self.sim_time_s),
            "staleness": (None if self.staleness is None else
                          [None if np.isnan(v) else float(v)
                           for v in self.staleness]),
            "version": int(self.version),
            **({} if self.ids is None else
               {"ids": [int(v) for v in self.ids],
                "population": int(self.population)}),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RoundTrace":
        stale = d.get("staleness")
        return cls(
            round=int(d["round"]),
            scheduled=np.asarray(d["scheduled"], dtype=bool),
            delivered=np.asarray(d["delivered"], dtype=bool),
            straggler=np.asarray(d["straggler"], dtype=bool),
            bytes_up=np.asarray(d["bytes_up"], dtype=np.float64),
            bytes_down=np.asarray(d["bytes_down"], dtype=np.float64),
            sim_time_s=float(d["sim_time_s"]),
            staleness=(None if stale is None else np.asarray(
                [np.nan if v is None else v for v in stale],
                dtype=np.float64)),
            version=int(d.get("version", -1)),
            ids=(None if d.get("ids") is None
                 else np.asarray(d["ids"], dtype=np.int64)),
            population=int(d.get("population", 0)),
        )


def summarize(traces: "list[RoundTrace]") -> dict:
    """Aggregate totals for reports / JSON artifacts."""
    if not traces:
        return {"rounds": 0, "total_bytes_up": 0, "total_bytes_down": 0,
                "sim_time_s": 0.0, "mean_participation": 0.0,
                "dropped_client_rounds": 0, "mean_staleness": 0.0}
    up = sum(int(t.bytes_up.sum()) for t in traces)
    down = sum(int(t.bytes_down.sum()) for t in traces)
    part = float(np.mean([t.delivered.sum() / t.clients for t in traces]))
    dropped = sum(int((t.scheduled & ~t.delivered).sum()) for t in traces)
    return {
        "rounds": len(traces),
        "total_bytes_up": up,
        "total_bytes_down": down,
        "sim_time_s": float(sum(t.sim_time_s for t in traces)),
        "mean_participation": part,
        "dropped_client_rounds": dropped,
        "mean_staleness": float(np.mean([t.mean_staleness for t in traces])),
    }


def cumulative_bytes(traces: "list[RoundTrace]") -> np.ndarray:
    """(T+1,) cumulative up+down bytes after each round (0 at round 0)."""
    per_round = np.array([t.total_bytes for t in traces], dtype=np.float64)
    return np.concatenate([[0.0], np.cumsum(per_round)])


def cumulative_bytes_up(traces: "list[RoundTrace]") -> np.ndarray:
    """(T+1,) cumulative uplink bytes (all clients) after each round."""
    per_round = np.array([float(t.bytes_up.sum()) for t in traces])
    return np.concatenate([[0.0], np.cumsum(per_round)])


def cumulative_bytes_down(traces: "list[RoundTrace]") -> np.ndarray:
    """(T+1,) cumulative downlink (broadcast) bytes after each round."""
    per_round = np.array([float(t.bytes_down.sum()) for t in traces])
    return np.concatenate([[0.0], np.cumsum(per_round)])


def cumulative_time(traces: "list[RoundTrace]") -> np.ndarray:
    """(T+1,) cumulative simulated seconds after each round."""
    per_round = np.array([t.sim_time_s for t in traces], dtype=np.float64)
    return np.concatenate([[0.0], np.cumsum(per_round)])


@dataclasses.dataclass(frozen=True)
class Transport:
    """Transport axes one ``Session`` produces for ``History`` assembly.

    ``traces``/``staleness``/``ef_residuals`` are None on the
    no-transport path (``run_rounds(..., comm=None)``), where the bytes
    curve is the identity-codec byte plan of the round and simulated
    time is identically zero.
    """

    cumulative_bytes: np.ndarray  # (T+1,) up+down, all clients
    sim_time_s: np.ndarray  # (T+1,) cumulative simulated seconds
    traces: Optional[list] = None  # per-round RoundTrace records
    staleness: Optional[np.ndarray] = None  # (T,) mean commit staleness
    ef_residuals: Optional[dict] = None  # final EF memory norms


def transport_from_traces(
    traces: "list[RoundTrace]",
    staleness: "np.ndarray | None" = None,
    ef_residuals: "dict | None" = None,
) -> Transport:
    """Fold a trace trajectory into the ``Transport`` axes — the one
    assembly both transport drivers share, so a new axis cannot be added
    to one driver's ``History`` and silently missed in the other's."""
    return Transport(
        cumulative_bytes=cumulative_bytes(traces),
        sim_time_s=cumulative_time(traces),
        traces=traces,
        staleness=staleness,
        ef_residuals=ef_residuals,
    )
