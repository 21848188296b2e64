"""Telemetry record sinks.

A sink consumes JSON-able record dicts (``emit``) and flushes on
``close``. Specs are strings so ``TelemetryConfig`` stays declarative:

  * ``"null"``          — drop everything (the default; zero overhead)
  * ``"stdout"``        — one JSON line per record to stdout
  * ``"jsonl:<path>"``  — append JSON lines to a file (parent dirs are
                          created; the file is APPENDED to, so several
                          runs — e.g. one per benchmark optimizer — can
                          share one artifact, distinguished by their
                          ``label`` field)

NaN/Infinity never reach the wire: non-finite floats are serialized as
``null`` (json.dumps would otherwise emit tokens invalid in strict
JSON parsers, which is exactly what a downstream dashboard would use).
"""
from __future__ import annotations

import json
import math
import pathlib
import sys


def _scrub(obj):
    """Replace non-finite floats with None, recursively."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    return obj


def encode_record(record: dict) -> str:
    """One strict-JSON line for a record (shared by all sinks)."""
    return json.dumps(_scrub(record), allow_nan=False)


class NullSink:
    def emit(self, record: dict) -> None:
        pass

    def close(self) -> None:
        pass


class StdoutSink:
    def emit(self, record: dict) -> None:
        sys.stdout.write(encode_record(record) + "\n")

    def close(self) -> None:
        sys.stdout.flush()


class JsonlSink:
    """Line-buffered append to ``path`` (opened lazily on first emit, so
    configuring a jsonl sink on a run that records nothing creates
    nothing)."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self._f = None

    def emit(self, record: dict) -> None:
        if self._f is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = self.path.open("a")
        self._f.write(encode_record(record) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def make_sink(spec: str):
    """Resolve a sink spec string (see module docstring)."""
    if spec == "null":
        return NullSink()
    if spec == "stdout":
        return StdoutSink()
    kind, sep, arg = str(spec).partition(":")
    if kind == "jsonl" and sep and arg:
        return JsonlSink(arg)
    raise ValueError(
        f"unknown telemetry sink {spec!r}; want 'null', 'stdout', or "
        f"'jsonl:<path>'")
