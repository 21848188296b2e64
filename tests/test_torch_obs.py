"""repro_torch's observability layer against repro's, on the CPU.

  * Units: the metrics registry's kinds, the flight ring's truncation,
    the sink specs, the all-NaN staleness of a ``RoundTrace``,
    ``warn_with_context``'s log record and warning, and the port's three
    driver warnings, which carry the reference's context fields.
  * Off equals today: each of the five drivers (no transport, sync,
    sync population, async, async population) gives the same trajectory
    bit for bit with ``obs=None``, ``TelemetryConfig()`` and a
    ``jsonl:`` sink.
  * Parity: the same five drivers with the reference's draws injected
    (``test_torch_comm.py``, ``test_torch_async.py``,
    ``test_torch_population.py``) and both packages writing JSONL: the
    summaries' round and compile counts, metric names, kinds and values,
    the flight events and the per-round annotations equal the
    reference's. One more case runs the async driver under scenario
    dynamics (churn with a diurnal channel and regional outages,
    ``tests/test_torch_dynamics.py``'s first scenario), whose counters
    (``clients_departed``, ``uploads_retired``), gauge
    (``active_population``) and flight ``retire`` events must equal the
    reference's too; the reference's flight recorder lacks the word
    ``retire`` its own driver records, so it runs with the word added.
    The span names are the reference's except one: the
    reference's no-transport session probes each variant's byte plan
    with a shape-only trace (span ``probe_plan``), and the port's records
    it inside the variant's first round, so it has no such span.
  * The reference's ``repro.obs.report --check-schema`` and the port's
    own read the port's stream; the ``torch.profiler`` hook writes a
    Chrome trace and leaves the trajectory alone.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import json
import logging
import warnings

import jax
import jax.numpy as jnp
import numpy as np

import repro.core as jcore
import repro.dynamics as jdyn
from repro.core.base import History as JHistory
from repro.core.federated import _dirichlet_sizes as j_dirichlet_sizes
from repro.obs import TelemetryConfig as JTelemetryConfig
from repro.obs import flight as jflight
from repro.obs import report as jreport
from repro_torch import dynamics as tdyn
from repro_torch.comm import ChannelModel, CommConfig, RoundTrace
from repro_torch.core import (
    FLeNS,
    History,
    SyntheticPopulation,
    make_optimizer,
    newton_solve,
    run_rounds,
)
from repro_torch.core.federated import _dirichlet_sizes
from repro_torch.obs import (
    FlightRecorder,
    MetricsRegistry,
    TelemetryConfig,
    make_sink,
)
from repro_torch.obs import log as obs_log
from repro_torch.obs import report

from test_torch_async import config_pair as async_config_pair
from test_torch_async import inject_event_draws, version_basis
from test_torch_comm import config_pair as sync_config_pair
from test_torch_comm import (  # noqa: F401
    inject_reference_draws,
    quickstart,
    reference_basis,
)
from test_torch_population import COMP, EDGE, synthetic  # noqa: F401
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

pytestmark = pytest.mark.telemetry

SEED = 0
COMM_SEED = 1
K = 32
DRIVERS = ("null", "sync", "async", "population-sync", "population-async")
RECORD_FIELDS = ("bytes_up", "bytes_down", "delivered", "dropped", "version",
                 "mean_staleness", "sim_time_s", "formula_bytes")


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_metrics_registry_kinds():
    reg = MetricsRegistry()
    c = reg.counter("n")
    c.inc()
    c.inc(2.5)
    assert reg.counter("n") is c  # get-or-create
    reg.gauge("g").set(7)
    reg.histogram("h").observe_many([1.0, 2.0, 3.0])
    with pytest.raises(TypeError):
        reg.gauge("n")  # a kind clash must not silently shadow
    snap = reg.snapshot()
    assert snap["counters"]["n"] == 3.5
    assert snap["gauges"]["g"] == 7.0
    assert snap["histograms"]["h"]["count"] == 3
    assert snap["histograms"]["h"]["p50"] == 2.0


def test_flight_recorder_ring_truncation():
    """The ring keeps the most recent events; total and truncated count
    every event ever recorded."""
    rec = FlightRecorder(capacity=3)
    for i in range(7):
        rec.record("dispatch", float(i), client=i)
    assert rec.total == 7 and rec.truncated == 4
    assert [e["client"] for e in rec.events()] == [4, 5, 6]  # oldest first
    assert rec.stats() == {"capacity": 3, "total": 7, "kept": 3,
                           "truncated": 4}
    with pytest.raises(ValueError):
        rec.record("teleport", 0.0)
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_sink_specs(tmp_path, capsys):
    path = tmp_path / "sub" / "records.jsonl"
    for _ in range(2):  # the jsonl sink appends
        sink = make_sink(f"jsonl:{path}")
        sink.emit({"type": "round", "x": float("nan"), "y": float("inf")})
        sink.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(recs) == 2
    assert recs[0]["x"] is None and recs[0]["y"] is None  # strict JSON
    make_sink("stdout").emit({"type": "round", "n": 1})
    assert json.loads(capsys.readouterr().out)["n"] == 1
    make_sink("null").emit({"whatever": 1})
    with pytest.raises(ValueError):
        make_sink("csv:nope")


def test_mean_staleness_all_nan():
    """A commit that delivered nobody reports 0.0, not NaN (and no
    warning of an empty mean)."""
    m = 4
    tr = RoundTrace(round=0, scheduled=np.zeros(m, dtype=bool),
                    delivered=np.zeros(m, dtype=bool),
                    straggler=np.zeros(m, dtype=bool), bytes_up=np.zeros(m),
                    bytes_down=np.zeros(m), sim_time_s=0.0,
                    staleness=np.full(m, np.nan))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tr.mean_staleness == 0.0
    assert RoundTrace(
        round=0, scheduled=np.ones(m, bool), delivered=np.ones(m, bool),
        straggler=np.zeros(m, bool), bytes_up=np.zeros(m),
        bytes_down=np.zeros(m), sim_time_s=1.0).mean_staleness == 0.0


def test_warn_with_context_dual_emission(caplog):
    """A diagnostic is a structured log record on "repro_torch.obs" AND a
    real warning."""
    with caplog.at_level(logging.WARNING, logger="repro_torch.obs"):
        with pytest.warns(UserWarning, match="probe failed"):
            obs_log.warn_with_context("probe failed", round=3,
                                      optimizer="flens", policy=None)
    assert len(caplog.records) == 1
    rec = caplog.records[0]
    assert rec.name == "repro_torch.obs"
    assert rec.context == {"round": 3, "optimizer": "flens", "policy": None}
    assert "round=3" in rec.getMessage() and "policy" not in rec.getMessage()


def _context(caplog, logger: str) -> dict:
    recs = [r for r in caplog.records if r.name == logger]
    assert len(recs) == 1, [r.getMessage() for r in caplog.records]
    return recs[0].context


def test_quorum_cap_warning_matches_reference(quickstart, caplog):
    """The async quorum cap still warns (the port's category,
    RuntimeWarning) and logs the reference's context."""
    (jp, jw0, jw_star), (tp, tw0, tw_star) = quickstart
    kw = dict(seed=1, async_mode=True, buffer_size=tp.m,
              scheduler="uniform:0.4")
    from repro.comm import CommConfig as JCommConfig
    with caplog.at_level(logging.WARNING):
        with pytest.warns(UserWarning, match="quorum capped"):
            jcore.run_rounds(jcore.make_optimizer("fedavg"), jp, jw0,
                             jw_star, rounds=1, comm=JCommConfig(**kw))
        with pytest.warns(RuntimeWarning, match="quorum capped"):
            run_rounds(make_optimizer("fedavg"), tp, tw0, tw_star, rounds=1,
                       comm=CommConfig(**kw))
    assert (_context(caplog, "repro_torch.obs")
            == _context(caplog, "repro.obs"))


def test_rotating_ef_and_dirichlet_warnings_carry_context(quickstart, caplog):
    """The two other driver diagnostics log the reference's context
    fields (rotate+EF: the same values; the Dirichlet pad: the same
    fields for the same sizes)."""
    _, (tp, tw0, tw_star) = quickstart
    with caplog.at_level(logging.WARNING, logger="repro_torch.obs"):
        with pytest.warns(RuntimeWarning, match="rotating sketch policy"):
            run_rounds(FLeNS(k=8, variant="plus", sketch="srht:rotate=3"),
                       tp, tw0, tw_star, rounds=1,
                       comm=CommConfig(async_mode=True, buffer_size=4,
                                       codecs=COMP, error_feedback=True))
    ref_policy = jcore.make_optimizer("flens_plus", k=8,
                                      sketch="srht:rotate=3").policy
    assert caplog.records[-1].context == {"optimizer": "flens_plus",
                                          "policy": ref_policy.spec()}
    caplog.clear()
    key = jax.random.PRNGKey(40)
    props = np.asarray(jax.random.dirichlet(key, jnp.full((40,), 0.05)),
                       dtype=np.float64)
    with caplog.at_level(logging.WARNING):
        with pytest.warns(UserWarning, match="dirichlet shard sizes"):
            mine = _dirichlet_sizes(props, 600)
        with pytest.warns(UserWarning, match="dirichlet shard sizes"):
            ref = j_dirichlet_sizes(key, 600, 40, 0.05)
    np.testing.assert_array_equal(mine, ref)
    assert (_context(caplog, "repro_torch.obs")
            == _context(caplog, "repro.obs"))


def test_history_jsonl_roundtrip_with_telemetry(quickstart, tmp_path):
    """to_jsonl/from_jsonl keep every curve, each trace and the summary;
    the reference's reader takes the port's file too."""
    _, (tp, tw0, tw_star) = quickstart
    comm = CommConfig(seed=1, async_mode=True, buffer_size=2,
                      channel=ChannelModel(straggler_prob=0.3,
                                           straggler_slowdown=4.0))
    hist = run_rounds(make_optimizer("fedavg"), tp, tw0, tw_star, rounds=4,
                      comm=comm, obs=TelemetryConfig(label="rt"))
    path = hist.to_jsonl(tmp_path / "hist.jsonl")
    for back in (History.from_jsonl(path), JHistory.from_jsonl(path)):
        np.testing.assert_array_equal(back.loss, hist.loss)
        np.testing.assert_array_equal(back.cumulative_bytes,
                                      hist.cumulative_bytes)
        np.testing.assert_array_equal(back.staleness, hist.staleness)
        assert back.telemetry == json.loads(json.dumps(hist.telemetry))
        assert back.telemetry["label"] == "rt"
        assert [t.to_dict() for t in back.traces] == [
            t.to_dict() for t in hist.traces]


# ---------------------------------------------------------------------------
# the five drivers
# ---------------------------------------------------------------------------

DENSE_CHANNEL = dict(straggler_prob=0.3, straggler_slowdown=10.0,
                     dropout_prob=0.2)


def _port_config(driver: str):
    """The port's own (uninjected) configuration of each driver."""
    if driver == "null":
        return None
    if driver in ("sync", "async"):
        kw = dict(async_mode=True, buffer_size=3, staleness="inverse") \
            if driver == "async" else {}
        return CommConfig(seed=COMM_SEED, channel=ChannelModel(**DENSE_CHANNEL),
                          codecs=COMP, error_feedback=True, **kw)
    kw = dict(async_mode=True, buffer_size=5, staleness="inverse") \
        if driver == "population-async" else {}
    return CommConfig(seed=COMM_SEED, channel=ChannelModel(**EDGE),
                      scheduler="uniform:0.01", codecs=COMP,
                      error_feedback=True, **kw)


@pytest.fixture(scope="module")
def small_population():
    pop = SyntheticPopulation(m=1000, dim=16, seed=1, dirichlet_alpha=0.3,
                              device="cpu")
    w0 = torch.zeros(16, dtype=torch.float64)
    return pop, w0, newton_solve(pop.eval_problem(), w0)


def _trajectory(hist) -> tuple:
    return (hist.loss.tolist(), hist.grad_norm.tolist(),
            hist.cumulative_bytes.tolist(), hist.sim_time_s.tolist(),
            [t.to_dict() for t in hist.traces or []],
            None if hist.staleness is None else hist.staleness.tolist())


@pytest.mark.parametrize("driver", DRIVERS)
def test_telemetry_off_equals_today(quickstart, small_population, driver,
                                    tmp_path):
    """Instrumented and uninstrumented runs are bit-equal on every
    driver, null sink and jsonl sink alike; the summary adds up."""
    if driver.startswith("population"):
        problem, w0, w_star = small_population
    else:
        _, (problem, w0, w_star) = quickstart
    rounds = 5
    path = tmp_path / "tel.jsonl"
    runs = [run_rounds(FLeNS(k=8, variant="plus"), problem, w0, w_star,
                       rounds=rounds, comm=_port_config(driver), obs=obs)
            for obs in (None, TelemetryConfig(),
                        TelemetryConfig(sink=f"jsonl:{path}", label=driver))]
    bare, null, jsonl = runs
    assert bare.telemetry is None
    for hist in (null, jsonl):
        assert _trajectory(hist) == _trajectory(bare)
    tel = jsonl.telemetry
    assert tel["rounds"] == rounds and tel["compile_rounds"] == 1
    assert tel["exec_s_per_round"] == pytest.approx(tel["exec_s"]
                                                    / (rounds - 1))
    assert {"step", "eval", "begin_variant"} == set(tel["phase_s"])
    counters = tel["metrics"]["counters"]
    if driver == "null":
        assert counters["formula_bytes"] == bare.cumulative_bytes[-1]
    else:
        assert counters["bytes_up"] == sum(
            float(t.bytes_up.sum()) for t in bare.traces)
        assert counters["bytes_down"] == sum(
            float(t.bytes_down.sum()) for t in bare.traces)
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["type"] for r in records].count("round") == rounds
    assert records[-1]["type"] == "summary"
    assert sum(r["type"] == "flight" for r in records) == tel["flight"]["kept"]
    assert (tel["flight"]["total"] > 0) == driver.endswith("async")


def _churn(pkg):
    """``tests/test_torch_dynamics.py``'s churn scenario in package ``pkg``."""
    return pkg.DynamicsConfig(
        churn="poisson:0.05", seed=1, channel=pkg.ChannelProcess(
            uplink_bytes_per_s="sin:24,0.5", outage="outage:0.05,3,4",
            seed=1))


def _reference_and_port(driver, quickstart, synthetic, monkeypatch,
                        tmp_path):
    """Both packages' runs of ``driver`` under the reference's draws, each
    writing JSONL; returns their (summary, records) pairs. ``async-churn``
    is the async driver under the churn scenario."""
    rounds = 6
    jpath, tpath = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    jobs, tobs = (JTelemetryConfig(sink=f"jsonl:{jpath}", label=driver),
                  TelemetryConfig(sink=f"jsonl:{tpath}", label=driver))
    if driver.startswith("population"):
        (jp, jw0, jw_star), (tp, tw0, tw_star) = synthetic
        kw = dict(async_mode=True, buffer_size=5, staleness="inverse") \
            if driver == "population-async" else {}
        from repro.comm import ChannelModel as JChannelModel
        from repro.comm import CommConfig as JCommConfig
        common = dict(seed=COMM_SEED, scheduler="uniform:0.01", codecs=COMP,
                      error_feedback=True, **kw)
        jcfg = JCommConfig(channel=JChannelModel(**EDGE), **common)
        tcfg = CommConfig(channel=ChannelModel(**EDGE), **common)
        sketch = version_basis("srht", rounds)
        inject = inject_event_draws
        k = 8
    else:
        (jp, jw0, jw_star), (tp, tw0, tw_star) = quickstart
        k = K
        if driver.startswith("async"):
            jcfg, tcfg = async_config_pair(
                DENSE_CHANNEL, async_mode=True, buffer_size=3,
                staleness="inverse", codecs=COMP, error_feedback=True)
            sketch, inject = version_basis("srht", rounds), inject_event_draws
            if driver == "async-churn":
                jcfg = dataclasses.replace(jcfg, dynamics=_churn(jdyn))
                tcfg = dataclasses.replace(tcfg, dynamics=_churn(tdyn))
                monkeypatch.setattr(jflight, "EVENT_KINDS",
                                    jflight.EVENT_KINDS + ("retire",))
        else:
            jcfg, tcfg = sync_config_pair(COMP, scheduler="bandwidth:0.5",
                                          error_feedback=True)
            sketch = reference_basis("srht")
            inject = inject_reference_draws
        if driver == "null":
            jcfg = tcfg = None
    jh = jcore.run_rounds(jcore.make_optimizer("flens_plus", k=k), jp, jw0,
                          jw_star, rounds=rounds, seed=SEED, comm=jcfg,
                          obs=jobs)
    if jcfg is not None:
        inject(monkeypatch, jcfg)
    th = run_rounds(FLeNS(k=k, variant="plus", sketch=sketch), tp, tw0,
                    tw_star, rounds=rounds, seed=SEED, comm=tcfg, obs=tobs)
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-9, atol=0)
    read = [[json.loads(line) for line in p.read_text().splitlines()]
            for p in (jpath, tpath)]
    return (jh.telemetry, read[0]), (th.telemetry, read[1])


def _flight(records) -> list:
    return [r for r in records if r["type"] == "flight"]


@pytest.mark.parametrize("driver", DRIVERS + ("async-churn",))
def test_telemetry_matches_reference(driver, quickstart, synthetic,
                                     monkeypatch, tmp_path):
    (jsum, jrec), (tsum, trec) = _reference_and_port(
        driver, quickstart, synthetic, monkeypatch, tmp_path)
    for key in ("rounds", "compile_rounds", "flight", "optimizer", "driver",
                "rounds_requested", "clients", "total_bytes", "sim_time_s",
                "label", "schema"):
        assert tsum[key] == jsum[key], key
    jm, tm = jsum["metrics"], tsum["metrics"]
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(tm[kind]) == sorted(jm[kind]), kind
    assert tm["counters"] == jm["counters"]
    assert tm["gauges"] == jm["gauges"]
    for name, h in jm["histograms"].items():
        mine = tm["histograms"][name]
        assert (mine["count"], mine["min"], mine["max"]) == (
            h["count"], h["min"], h["max"]), name
        np.testing.assert_allclose(mine["sum"], h["sum"], rtol=1e-12)
    # span names: the reference's, but for its no-transport plan probe
    spans = set(tsum["phase_s"]) | set(tsum["setup_phase_s"])
    ref_spans = set(jsum["phase_s"]) | set(jsum["setup_phase_s"])
    assert spans == ref_spans - ({"probe_plan"} if driver == "null"
                                 else set())
    assert spans == {"prepare", "begin_variant", "step", "eval", "finalize"}
    # per-round records: keys, compile flags and annotations
    jr = [r for r in jrec if r["type"] == "round"]
    tr = [r for r in trec if r["type"] == "round"]
    assert len(tr) == len(jr) == tsum["rounds"]
    for mine, ref in zip(tr, jr):
        assert sorted(mine) == sorted(ref)
        assert mine["compile"] == ref["compile"]
        for field in RECORD_FIELDS:
            assert mine.get(field) == ref.get(field), field
    # the flight events, in order
    jf, tf = _flight(jrec), _flight(trec)
    assert len(tf) == len(jf) == tsum["flight"]["kept"]
    assert (len(tf) > 0) == ("async" in driver)
    for mine, ref in zip(tf, jf):
        assert sorted(mine) == sorted(ref)
        np.testing.assert_allclose(mine["t"], ref["t"], rtol=1e-12)
        if "eta" in ref:
            np.testing.assert_allclose(mine["eta"], ref["eta"], rtol=1e-12)
        for field in ("kind", "client", "version", "retry", "clients",
                      "server_version", "buffered", "inflight", "straggler"):
            assert mine.get(field) == ref.get(field), (field, mine, ref)
    if driver == "async":
        assert any(e["kind"] == "drop" for e in tf)
        assert tm["counters"]["upload_retries"] > 0
    if driver == "async-churn":
        assert any(e["kind"] == "retire" for e in tf)
        assert tm["counters"]["uploads_retired"] > 0
        assert tm["counters"]["clients_departed"] > 0
        assert 0 < tm["gauges"]["active_population"] < tsum["clients"]


def test_reports_read_the_port_stream(quickstart, tmp_path, capsys):
    """One JSONL with a sync and an async run: the reference's checker
    and the port's accept it, and the port's renderer prints one table
    per run."""
    _, (tp, tw0, tw_star) = quickstart
    path = tmp_path / "tel.jsonl"
    for label in ("sync", "async"):
        run_rounds(make_optimizer("fedavg"), tp, tw0, tw_star, rounds=3,
                   comm=_port_config(label),
                   obs=TelemetryConfig(sink=f"jsonl:{path}", label=label))
    assert jreport.main([str(path), "--check-schema"]) == 0
    assert report.main([str(path), "--check-schema"]) == 0
    assert "schema OK" in capsys.readouterr().out
    assert report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert out.count("== run ") == 2
    assert "== run sync ==" in out and "== run async ==" in out
    assert "staleness" in out and "bytes" in out
    # a summary that lost a key is schema drift
    records = [json.loads(line) for line in path.read_text().splitlines()]
    next(r for r in records if r["type"] == "summary").pop("compile_s")
    drifted = tmp_path / "drifted.jsonl"
    drifted.write_text("\n".join(json.dumps(r) for r in records) + "\n")
    assert report.main([str(drifted), "--check-schema"]) == 1
    assert "SCHEMA DRIFT" in capsys.readouterr().out


def test_variant_retraces_counted(quickstart):
    """A new round variant after the first counts one retrace, and its
    first execution is a compile round."""
    _, (tp, tw0, tw_star) = quickstart
    opt = make_optimizer("fedavg", lr=1.0, local_steps=2)
    opt.round_signature = lambda t, state: t // 2
    hist = run_rounds(opt, tp, tw0, tw_star, rounds=4,
                      comm=CommConfig(seed=1), obs=TelemetryConfig())
    assert hist.telemetry["metrics"]["counters"]["variant_retraces"] == 1
    assert hist.telemetry["compile_rounds"] == 2


def test_profiler_hook_writes_a_trace(quickstart, tmp_path, caplog,
                                      monkeypatch):
    """profile_rounds=1 exports a Chrome trace and logs its summary; the
    trajectory is the uninstrumented one. A profiler that cannot start
    warns and the run goes on."""
    _, (tp, tw0, tw_star) = quickstart
    comm = _port_config("sync")
    bare = run_rounds(make_optimizer("fedavg"), tp, tw0, tw_star, rounds=3,
                      comm=comm)
    obs = TelemetryConfig(profile_rounds=1, profile_dir=str(tmp_path / "tr"),
                          label="prof")
    with caplog.at_level(logging.INFO, logger="repro_torch.obs"):
        hist = run_rounds(make_optimizer("fedavg"), tp, tw0, tw_star,
                          rounds=3, comm=comm, obs=obs)
    assert _trajectory(hist) == _trajectory(bare)
    traces = list((tmp_path / "tr").glob("prof_*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    written = [r for r in caplog.records if "trace written" in r.getMessage()]
    assert len(written) == 1 and written[0].context["kernels"]

    import torch.profiler

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.warns(UserWarning, match="trace hook unavailable"):
        again = run_rounds(make_optimizer("fedavg"), tp, tw0, tw_star,
                           rounds=3, comm=comm, obs=obs)
    assert _trajectory(again) == _trajectory(bare)
    assert len(list((tmp_path / "tr").glob("*.json"))) == 1
