"""Lightweight host-side span tracer.

Spans time *host* work around the round calls — the driver's
``prepare`` / ``begin_variant`` / ``step`` / ``eval`` phases — never
code inside the optimizer's round. PyTorch launches CUDA work
asynchronously, so a span around a launch measures the launch; the
driver synchronizes the device inside its ``step`` span when telemetry
is on, so the span covers the round's device work too: the wall-clock
an end user waits through.

Spans nest (``with trace.span("step"): ... with trace.span("schedule")``)
and every *closed* span reports ``(name, duration, depth)`` to the
telemetry object, which attributes it to the round currently executing
(or to the setup phase outside any round). Aggregation is by name, so
the driver keeps phase names sibling-disjoint where per-phase totals
should partition the round wall-clock.
"""
from __future__ import annotations

import time
from typing import Callable


class _Span:
    """One active span; re-entrant use is not supported (make a new one
    via ``Tracer.span``)."""

    __slots__ = ("_tracer", "name", "_t0")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self.name = name
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._tracer._depth += 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._t0
        self._tracer._depth -= 1
        self._tracer._report(self.name, dur, self._tracer._depth)
        return False


class Tracer:
    """Factory for nestable timing spans.

    ``report(name, duration_s, depth)`` is called once per closed span;
    ``depth`` is 0 for top-level spans. The telemetry runtime installs
    its round-attribution callback here.
    """

    def __init__(self, report: Callable[[str, float, int], None]):
        self._report = report
        self._depth = 0

    def span(self, name: str) -> _Span:
        return _Span(self, name)


class _NullSpan:
    """Shared no-op span: the zero-overhead path when telemetry is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracer stand-in whose spans cost one attribute lookup + one
    (shared, stateless) context-manager enter/exit."""

    __slots__ = ()

    def span(self, name: str) -> _NullSpan:
        return NULL_SPAN


NULL_TRACER = NullTracer()
