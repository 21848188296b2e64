"""`repro_torch.obs` — the observability layer.

Counterpart of ``repro.obs``, with the same module names, record shapes
and schema (``repro.obs/v1``), so ``python -m repro.obs.report
--check-schema`` accepts the port's streams as well as its own.

Host-side telemetry for the federated round drivers: a nestable span
tracer (host wall-clock around the round calls, never inside them), a metrics
registry (counters / gauges / histograms the Sessions populate), an
async flight recorder (bounded ring of dispatch/arrival/drop/commit
events), pluggable record sinks (``null`` / ``stdout`` /
``jsonl:<path>``), and a structured driver logger.

Entry point: ``run_rounds(..., obs=TelemetryConfig(...))``. The default
(``obs=None``) is the shared ``NULL_TELEMETRY`` no-op: the drivers run
exactly the code they run without telemetry, and the trajectories are
bit-identical (tested). Render or schema-check the emitted artifacts
with ``python -m repro_torch.obs.report``.
"""
from repro_torch.obs.flight import (
    EVENT_KINDS,
    NULL_FLIGHT,
    FlightRecorder,
    NullFlightRecorder,
)
from repro_torch.obs.metrics import (
    NULL_METRICS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullMetricsRegistry,
)
from repro_torch.obs.sinks import JsonlSink, NullSink, StdoutSink, make_sink
from repro_torch.obs.telemetry import (
    NULL_TELEMETRY,
    SCHEMA,
    NullTelemetry,
    Telemetry,
    TelemetryConfig,
)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "Counter",
    "EVENT_KINDS",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "NULL_FLIGHT",
    "NULL_METRICS",
    "NULL_TELEMETRY",
    "NULL_TRACER",
    "NullFlightRecorder",
    "NullMetricsRegistry",
    "NullSink",
    "NullTelemetry",
    "NullTracer",
    "SCHEMA",
    "StdoutSink",
    "Telemetry",
    "TelemetryConfig",
    "Tracer",
    "make_sink",
]
