"""Telemetry metrics registry: counters, gauges, histograms.

Deliberately tiny — these are *host-side* simulation metrics at
federated-round granularity (hundreds to low-thousands of observations
per run), not a wire-format for a metrics backend. Histograms therefore
keep their raw observations and compute exact quantiles at snapshot
time instead of maintaining approximate buckets.

The registry is get-or-create by name so producer sites stay one-liners
(``metrics.counter("bytes_up").inc(n)``) and the consumer (the run
summary / ``repro_torch.obs.report``) discovers whatever was populated.
"""
from __future__ import annotations

from typing import Dict, List


class Counter:
    """Monotonically increasing total."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-written value (e.g. a final memory footprint)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact-quantile histogram over raw observations."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def observe_many(self, vs) -> None:
        self.values.extend(float(v) for v in vs)

    def snapshot(self) -> dict:
        if not self.values:
            return {"count": 0}
        xs = sorted(self.values)
        n = len(xs)

        def q(p: float) -> float:
            return xs[min(n - 1, int(p * n))]

        return {
            "count": n,
            "sum": sum(xs),
            "mean": sum(xs) / n,
            "min": xs[0],
            "max": xs[-1],
            "p50": q(0.50),
            "p90": q(0.90),
            "p99": q(0.99),
        }


class MetricsRegistry:
    """Named counters/gauges/histograms, get-or-create per kind.

    A name is owned by the kind that first created it; asking for the
    same name as a different kind raises (silent shadowing would split
    one logical metric across two objects).
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """JSON-able dump: ``{counters: {...}, gauges: {...},
        histograms: {name: {count, mean, p50, ...}}}``."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out


class _NullMetric:
    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def observe_many(self, vs) -> None:
        pass


_NULL_METRIC = _NullMetric()


class NullMetricsRegistry:
    """No-op registry backing the disabled-telemetry path."""

    __slots__ = ()

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}


NULL_METRICS = NullMetricsRegistry()
