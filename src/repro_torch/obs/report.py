"""Render (and schema-check) telemetry artifacts.

Two artifact kinds are understood:

  * a telemetry JSONL stream (``TelemetryConfig(sink="jsonl:...")``):
    per-round records, flight events, and per-run summaries — rendered
    as one table per run covering phase timings, the compile-vs-exec
    wall-clock split, byte totals, and the staleness distribution;
  * ``BENCH_round_time.json`` (``benchmarks/run.py --only round_time``):
    the per-optimizer perf-trajectory record — rendered as a table.

``--check-schema`` validates the artifact's structure instead of
rendering and exits non-zero on drift, so a silently-changed record
shape fails loudly rather than rotting every downstream consumer.
The record shapes and schema names are ``repro.obs.report``'s: each
package's checker accepts the other's streams.

  PYTHONPATH=src python -m repro_torch.obs.report results/telemetry.jsonl
  PYTHONPATH=src python -m repro_torch.obs.report BENCH_round_time.json --check-schema
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.obs.flight import EVENT_KINDS
from repro_torch.obs.telemetry import SCHEMA

BENCH_SCHEMA = "bench_round_time/v1"

# required record shapes (schema drift = a missing key or unknown type)
_SUMMARY_KEYS = ("rounds", "compile_rounds", "compile_s", "exec_s",
                 "exec_s_per_round", "phase_s", "setup_phase_s", "metrics",
                 "flight")
_ROUND_KEYS = ("round", "wall_s", "compile", "phases")
_BENCH_OPT_KEYS = ("compile_s", "exec_s_per_round", "bytes_total",
                   "loss_final", "loss_at_budget")


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def _fmt_bytes(x: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("kB", 1e3)):
        if x >= div:
            return f"{x / div:.2f} {unit}"
    return f"{x:.0f} B"


def load_records(path: pathlib.Path) -> "list[dict]":
    records = []
    with path.open() as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not a JSON record ({e})")
    return records


# ---------------------------------------------------------------------------
# telemetry JSONL
# ---------------------------------------------------------------------------

def check_jsonl_schema(records: "list[dict]") -> "list[str]":
    """Structural validation; returns human-readable violations."""
    problems = []
    summaries = 0
    for i, rec in enumerate(records):
        where = f"record {i + 1}"
        kind = rec.get("type")
        if kind == "summary":
            summaries += 1
            if rec.get("schema") != SCHEMA:
                problems.append(
                    f"{where}: summary schema {rec.get('schema')!r} != "
                    f"{SCHEMA!r}")
            missing = [k for k in _SUMMARY_KEYS if k not in rec]
            if missing:
                problems.append(f"{where}: summary missing keys {missing}")
        elif kind == "round":
            missing = [k for k in _ROUND_KEYS if k not in rec]
            if missing:
                problems.append(f"{where}: round missing keys {missing}")
        elif kind == "flight":
            if rec.get("kind") not in EVENT_KINDS:
                problems.append(
                    f"{where}: unknown flight event kind {rec.get('kind')!r}")
            if "t" not in rec:
                problems.append(f"{where}: flight event missing 't'")
        else:
            problems.append(f"{where}: unknown record type {kind!r}")
    if summaries == 0:
        problems.append("no summary record (incomplete/truncated stream?)")
    return problems


def _render_histogram(name: str, h: dict) -> str:
    if h.get("count", 0) == 0:
        return f"  {name}: (empty)"
    return (f"  {name}: n={h['count']} mean={h['mean']:.2f} "
            f"p50={h['p50']:.0f} p90={h['p90']:.0f} max={h['max']:.0f}")


def render_summary(rec: dict) -> str:
    """One run's summary table (phase timings, compile-vs-exec split,
    byte totals, staleness distribution)."""
    label = rec.get("label") or rec.get("optimizer") or "(unlabelled)"
    lines = [f"== run {label} =="]
    lines.append(
        f"  rounds: {rec['rounds']} ({rec['compile_rounds']} compile)   "
        f"compile {_fmt_s(rec['compile_s'])} | "
        f"exec {_fmt_s(rec['exec_s'])} "
        f"({_fmt_s(rec['exec_s_per_round'])}/round)")
    for title, phases in (("phases", rec.get("phase_s", {})),
                          ("setup", rec.get("setup_phase_s", {}))):
        if phases:
            body = "  ".join(
                f"{name} {_fmt_s(dur)}" for name, dur in
                sorted(phases.items(), key=lambda kv: -kv[1]))
            lines.append(f"  {title}: {body}")
    metrics = rec.get("metrics", {})
    counters = metrics.get("counters", {})
    up = counters.get("bytes_up", rec.get("total_bytes_up"))
    down = counters.get("bytes_down", rec.get("total_bytes_down"))
    if up is not None or down is not None:
        lines.append(
            f"  bytes: up {_fmt_bytes(up or 0.0)}  "
            f"down {_fmt_bytes(down or 0.0)}  "
            f"total {_fmt_bytes((up or 0.0) + (down or 0.0))}")
    elif "total_bytes" in rec:
        lines.append(f"  bytes: total {_fmt_bytes(rec['total_bytes'])}")
    if "sim_time_s" in rec:
        lines.append(f"  sim clock: {rec['sim_time_s']:.3f}s")
    for name in ("staleness", "commit_buffer_depth", "buffered_upload_age_s",
                 "inflight_depth"):
        h = metrics.get("histograms", {}).get(name)
        if h is not None:
            lines.append(_render_histogram(name, h))
    extra_counters = {k: v for k, v in counters.items()
                      if k not in ("bytes_up", "bytes_down")}
    if extra_counters:
        lines.append("  counters: " + "  ".join(
            f"{k}={v:g}" for k, v in sorted(extra_counters.items())))
    gauges = metrics.get("gauges", {})
    if gauges:
        # scenario-dynamics / EF state gauges (active_population,
        # ef_memory_bytes, ...) — last-set values at run end
        lines.append("  gauges: " + "  ".join(
            f"{k}={v:g}" for k, v in sorted(gauges.items())))
    fl = rec.get("flight", {})
    if fl.get("total"):
        lines.append(
            f"  flight: {fl['kept']} events kept of {fl['total']} "
            f"(capacity {fl['capacity']}, {fl['truncated']} truncated)")
    return "\n".join(lines)


def render_jsonl(records: "list[dict]") -> str:
    out = []
    rounds_by_label: "dict[str, int]" = {}
    for rec in records:
        if rec.get("type") == "round":
            label = rec.get("label", "")
            rounds_by_label[label] = rounds_by_label.get(label, 0) + 1
        elif rec.get("type") == "summary":
            out.append(render_summary(rec))
    if not out:
        return "(no summary records)"
    return "\n\n".join(out)


# ---------------------------------------------------------------------------
# BENCH_round_time.json
# ---------------------------------------------------------------------------

def check_bench_schema(doc: dict) -> "list[str]":
    problems = []
    if doc.get("schema") != BENCH_SCHEMA:
        problems.append(
            f"schema {doc.get('schema')!r} != {BENCH_SCHEMA!r}")
    for key in ("dataset", "rounds", "budget_bytes", "optimizers"):
        if key not in doc:
            problems.append(f"missing top-level key {key!r}")
    opts = doc.get("optimizers", {})
    if not opts:
        problems.append("no optimizers recorded")
    for name, row in opts.items():
        missing = [k for k in _BENCH_OPT_KEYS if k not in row]
        if missing:
            problems.append(f"optimizer {name!r} missing keys {missing}")
    return problems


def render_bench(doc: dict) -> str:
    lines = [
        f"== BENCH round_time: {doc.get('dataset')} "
        f"({doc.get('rounds')} rounds, budget "
        f"{_fmt_bytes(float(doc.get('budget_bytes', 0.0)))}) ==",
        f"{'optimizer':>14} {'compile_s':>10} {'exec/round':>11} "
        f"{'bytes':>10} {'loss@budget':>12} {'loss_final':>11}",
    ]
    for name, row in sorted(doc.get("optimizers", {}).items()):
        lines.append(
            f"{name:>14} {row['compile_s']:>10.3f} "
            f"{_fmt_s(row['exec_s_per_round']):>11} "
            f"{_fmt_bytes(row['bytes_total']):>10} "
            f"{row['loss_at_budget']:>12.6f} {row['loss_final']:>11.6f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render or schema-check repro_torch.obs telemetry artifacts.")
    ap.add_argument("path", type=pathlib.Path,
                    help="telemetry JSONL or BENCH_round_time.json")
    ap.add_argument("--check-schema", action="store_true",
                    help="validate structure instead of rendering; "
                         "exit 1 on drift")
    args = ap.parse_args(argv)

    text = args.path.read_text()
    doc = None
    try:
        parsed = json.loads(text)
        if isinstance(parsed, dict) and "schema" in parsed:
            doc = parsed  # a single-document BENCH json
    except json.JSONDecodeError:
        pass

    if doc is not None:
        problems = check_bench_schema(doc)
        if args.check_schema:
            if problems:
                print(f"SCHEMA DRIFT in {args.path}:")
                for p in problems:
                    print(f"  - {p}")
                return 1
            print(f"schema OK: {args.path} ({BENCH_SCHEMA}, "
                  f"{len(doc['optimizers'])} optimizers)")
            return 0
        if problems:
            print(f"warning: schema problems in {args.path}: {problems}",
                  file=sys.stderr)
        print(render_bench(doc))
        return 0

    records = load_records(args.path)
    problems = check_jsonl_schema(records)
    if args.check_schema:
        if problems:
            print(f"SCHEMA DRIFT in {args.path}:")
            for p in problems:
                print(f"  - {p}")
            return 1
        n_sum = sum(1 for r in records if r.get("type") == "summary")
        print(f"schema OK: {args.path} ({SCHEMA}, {len(records)} records, "
              f"{n_sum} run summaries)")
        return 0
    print(render_jsonl(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
