"""The telemetry runtime ``run_rounds`` threads through the Session
drivers.

``TelemetryConfig`` is the user-facing declaration (hung off
``run_rounds(..., obs=...)``); ``Telemetry`` is the per-run runtime
bundling the span tracer, the metrics registry, the async flight
recorder, and the record sink. ``NULL_TELEMETRY`` is the shared
disabled instance the driver uses when ``obs=None`` (the default):
every producer call site degrades to a no-op whose cost is an attribute
lookup, and — the load-bearing guarantee — NOTHING telemetry does ever
reaches the optimizer's round or the tensors it computes: it stays on
the host, so instrumented and uninstrumented trajectories are
bit-identical (tested, null sink and jsonl sink alike).

Counterpart of ``repro.obs.telemetry`` with the same records and
``SCHEMA``. PyTorch compiles nothing ahead of a call, so "compile" is
the first execution of each round variant (lazy module loads, cuBLAS
handles, allocator growth, a kernel build nothing did before): the
same rounds the reference bills as trace-and-compile.

Record stream (what a sink sees, one dict per record):

  * per round:  ``{"type": "round", "round": t, "wall_s", "compile",
                  "phases": {name: seconds}, ...session annotations}``
  * flight:     ``{"type": "flight", ...event}`` (async runs, dumped at
                  finalize, ring-truncated to the most recent events)
  * summary:    ``{"type": "summary", "compile_s", "exec_s",
                  "exec_s_per_round", "phase_s", "setup_phase_s",
                  "metrics", "flight", ...driver extras}``

Every record carries the config's ``label`` so several runs can share
one JSONL artifact.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

from repro_torch.obs.flight import NULL_FLIGHT, FlightRecorder
from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from repro_torch.obs.sinks import make_sink
from repro_torch.obs.trace import NULL_TRACER, Tracer

# schema version stamped on summary records; repro_torch.obs.report
# --check-schema fails on records claiming a different major version. The
# reference's name, unchanged: both packages write the same records
SCHEMA = "repro.obs/v1"


@dataclasses.dataclass
class TelemetryConfig:
    """Declarative telemetry switchboard for one ``run_rounds`` call.

    ``sink`` — where records go: ``"null"`` (default — measure nothing
    downstream, still collect the in-process summary), ``"stdout"``, or
    ``"jsonl:<path>"`` (appends; runs are distinguished by ``label``).
    ``flight_capacity`` — ring size of the async flight recorder.
    ``profile_rounds`` — opt-in ``torch.profiler`` hook: record CPU and
    CUDA activity around the FIRST N executed rounds (0 = off) and
    export a Chrome trace into ``profile_dir``. It wraps rounds from the
    host; the round code is never modified.
    """

    sink: str = "null"
    label: str = ""
    flight_capacity: int = 1024
    profile_rounds: int = 0
    profile_dir: str = "results/torch_trace"


class Telemetry:
    """Per-run telemetry runtime (see module docstring)."""

    enabled = True

    def __init__(self, config: "TelemetryConfig | None" = None):
        self.config = config if config is not None else TelemetryConfig()
        self.sink = make_sink(self.config.sink)
        self.metrics = MetricsRegistry()
        self.flight = FlightRecorder(self.config.flight_capacity)
        self.trace = Tracer(self._attribute_span)
        self.rounds: "list[dict]" = []
        self._current: "dict | None" = None
        self._setup_phase_s: "dict[str, float]" = {}
        self._finalized: "dict | None" = None

    # -- span attribution ----------------------------------------------------
    def _attribute_span(self, name: str, dur: float, depth: int) -> None:
        """Closed spans aggregate by name into the live round record, or
        into the setup bucket outside any round (prepare, probes)."""
        target = (self._current["phases"] if self._current is not None
                  else self._setup_phase_s)
        target[name] = target.get(name, 0.0) + dur

    # -- round lifecycle -----------------------------------------------------
    @contextlib.contextmanager
    def round(self, t: int, *, compile_expected: bool = False):
        """Time one driver round. ``compile_expected`` marks the first
        execution of a round variant: its wall time lands in
        ``compile_s``, steady-state rounds in ``exec_s``."""
        rec = {"type": "round", "round": int(t),
               "compile": bool(compile_expected), "phases": {}}
        self._current = rec
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            rec["wall_s"] = time.perf_counter() - t0
            self._current = None
            self.rounds.append(rec)
            self.sink.emit({"label": self.config.label, **rec})

    def annotate(self, **fields) -> None:
        """Merge fields into the live round record (sessions report
        per-round bytes / staleness / cohort sizes here); outside a
        round this is a no-op."""
        if self._current is not None:
            self._current.update(fields)

    # -- finalize ------------------------------------------------------------
    def finalize(self, extra: "dict | None" = None) -> dict:
        """Fold the run into one summary record, flush the flight ring
        and the summary to the sink, close the sink, and return the
        summary. Idempotent (drivers call it once; a late second call
        returns the same dict)."""
        if self._finalized is not None:
            return self._finalized
        compile_rounds = [r for r in self.rounds if r["compile"]]
        exec_rounds = [r for r in self.rounds if not r["compile"]]
        compile_s = sum(r["wall_s"] for r in compile_rounds)
        exec_s = sum(r["wall_s"] for r in exec_rounds)
        phase_s: "dict[str, float]" = {}
        for r in self.rounds:
            for name, dur in r["phases"].items():
                phase_s[name] = phase_s.get(name, 0.0) + dur
        summary = {
            "type": "summary",
            "schema": SCHEMA,
            "label": self.config.label,
            "rounds": len(self.rounds),
            "compile_rounds": len(compile_rounds),
            "compile_s": compile_s,
            "exec_s": exec_s,
            "exec_s_per_round": exec_s / max(len(exec_rounds), 1),
            "phase_s": phase_s,
            "setup_phase_s": dict(self._setup_phase_s),
            "metrics": self.metrics.snapshot(),
            "flight": self.flight.stats(),
        }
        if extra:
            summary.update(extra)
        label = self.config.label
        for ev in self.flight.events():
            self.sink.emit({"type": "flight", "label": label, **ev})
        self.sink.emit(summary)
        self.sink.close()
        self._finalized = summary
        return summary


class NullTelemetry:
    """Disabled telemetry: shared singleton, every surface a no-op.

    Producer sites guard expensive derivations with ``if obs.enabled:``;
    plain span/metric/flight calls are cheap enough to leave unguarded.
    """

    enabled = False
    trace = NULL_TRACER
    metrics = NULL_METRICS
    flight = NULL_FLIGHT
    rounds: "list[dict]" = []

    @contextlib.contextmanager
    def round(self, t: int, *, compile_expected: bool = False):
        yield None

    def annotate(self, **fields) -> None:
        pass

    def finalize(self, extra: "dict | None" = None) -> None:
        return None


NULL_TELEMETRY = NullTelemetry()
