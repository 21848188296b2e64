"""repro_torch.dynamics against repro.dynamics, on the CPU.

  * The port's own samplers, as ``tests/test_dynamics.py`` checks the
    reference's: spec errors and ranges, null normalization and
    ``forces_mask``, churn that is pure per id, a time-varying and
    clipped channel, region-correlated outages, a per-id attacker set,
    the robust aggregators' invariants and ``BoundedMemory.retire``.
  * The seams: given the reference's per-id draws (churn uniforms, a
    modulator stage's phases and signs, outage coins, attacker coins),
    churn, the channel process and the threat give the reference's
    eligibility, multipliers, outages and attackers.
  * The robust aggregators and ``ThreatModel.corrupt`` on the same
    seeded float64 inputs as the reference's: outputs to rtol 1e-12,
    counters equal (the even-count median among the cases).
  * Off equals today: ``dynamics=None`` and an all-``None``
    ``DynamicsConfig`` leave all four transport drivers' trajectories
    bit-equal to a run without the argument.
  * Parity (``check_dynamics_parity``, run on the dense drivers by
    ``test_torch_dynamics_drivers.py`` and on the population drivers by
    ``test_torch_dynamics_population.py``; the reference's compiles make
    each case seconds long, so the cases are split over two files):
    three scenarios on the four drivers with the reference's draws
    injected (``test_torch_comm.inject_reference_draws``,
    ``test_torch_async.inject_event_draws``) and telemetry on: churn
    with a diurnal channel and regional outages under
    ``comp+sched+ef``, a sign-flip coalition against the trimmed mean
    under the dense codecs, and a noise attack on ``h_sk`` against clip
    and median under identity codecs.
    Losses to rtol 1e-9; deliveries, bytes and versions exactly;
    simulated time to rtol 1e-12; the sessions' robust counters, the
    dynamics counters and gauges and the flight ``retire`` events
    exactly, ``uploads_corrupted`` without the async drivers' probe
    round. The reference's flight recorder refuses its own driver's
    ``retire`` event (its vocabulary lacks it), so the reference runs
    here with the word added.
  * ``bench_robust``'s invariant at the quickstart size: clean, attacked
    and trimmed arms transmit equal bytes, and each arm's final loss is
    the reference's.
  * The new layers follow the session's device: the card by default,
    the CPU when asked, and a forced CUDA kernel without a card raises.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.core as jcore
import repro.core.base as jbase
import repro.dynamics as jdyn
from repro.comm import BoundedMemory as JBoundedMemory
from repro.comm import ChannelModel as JChannelModel
from repro.comm import CommConfig as JCommConfig
from repro.comm.codecs import make_codec as jmake_codec
from repro.comm.scheduler import make_scheduler as jmake_scheduler
from repro.dynamics import churn as jchurn
from repro.dynamics import process as jprocess
from repro.dynamics import threat as jthreat
from repro.obs import TelemetryConfig as JTelemetryConfig
from repro.obs import flight as jflight
from repro_torch import dynamics as tdyn
from repro_torch.comm import (
    BoundedMemory,
    ChannelModel,
    CommConfig,
    CommSession,
    make_codec,
    make_scheduler,
)
from repro_torch.comm import config as tconfig
from repro_torch.core import (
    FLeNS,
    SyntheticPopulation,
    make_optimizer,
    newton_solve,
    run_rounds,
)
from repro_torch.core import base as tbase
from repro_torch.dynamics import (
    ChannelProcess,
    DynamicsConfig,
    make_aggregator,
    make_churn,
    make_threat,
)
from repro_torch.kernels import ops
from repro_torch.obs import TelemetryConfig

from test_torch_async import STRAGGLERS, inject_event_draws, version_basis
from test_torch_comm import (  # noqa: F401
    _ref_stage_draws,
    edge_channel_kwargs,
    inject_reference_draws,
    quickstart,
    reference_basis,
)
from test_torch_population import COMP, EDGE, synthetic  # noqa: F401
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

SEED = 0
COMM_SEED = 1
M = 8
K = 32
# examples/edge_clients.py:291-292: robust aggregation wants dense payloads
DENSE_CODECS = {"h_sk": "sympack+qint8", "sg": "qint8", "grad": "qint8"}


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------

PARSE_ERRORS = [
    ("churn", "stepp:3", "step:"),
    ("churn", "step:frac=x", "step:"),
    ("threat", "gaussian:0.1", "signflip:"),
    ("robust", "trim:0.1", "clip:tau"),
    ("scheduler", "unifrom:0.5", "uniform:<q>"),
    ("codec", "fp8", "qint8"),
    ("modulator", "cos:2,1", "sin:"),
    ("outage", "outage:0.1", "p, dur[, groups]"),
    ("threat", "signflip:2.0", "must be in [0, 1]"),
    ("robust", "trimmed:0.7", "must be in (0, 0.5)"),
    ("threat", "signflip:0.3@", "empty @payload"),
    ("robust", "median:3", "takes no parameters"),
]


def _maker(kind: str, pkg):
    return {
        "churn": pkg.make_churn, "threat": pkg.make_threat,
        "robust": pkg.make_aggregator,
        "scheduler": make_scheduler if pkg is tdyn else jmake_scheduler,
        "codec": make_codec if pkg is tdyn else jmake_codec,
        "modulator": lambda s: pkg.ChannelProcess(uplink_bytes_per_s=s),
        "outage": lambda s: pkg.ChannelProcess(outage=s),
    }[kind]


@pytest.mark.parametrize("kind,bad,fragment", PARSE_ERRORS,
                         ids=[b for _, b, _ in PARSE_ERRORS])
def test_parse_errors_match_reference(kind, bad, fragment):
    """A bad spec is echoed back with the known alternatives, in the
    reference's words."""
    with pytest.raises(ValueError) as mine:
        _maker(kind, tdyn)(bad)
    with pytest.raises(ValueError) as ref:
        _maker(kind, jdyn)(bad)
    assert fragment in str(mine.value)
    if not fragment.startswith(("must be", "empty", "takes no")):
        assert bad.split(":")[0] in str(mine.value)  # an unknown head
    assert str(mine.value) == str(ref.value)


def test_null_dynamics_normalizes_away_and_forces_mask():
    assert CommConfig(dynamics=DynamicsConfig()).dynamics is None
    with pytest.raises(ValueError, match="DynamicsConfig"):
        CommConfig(dynamics="signflip:0.1")
    with pytest.raises(ValueError, match="ChannelProcess"):
        DynamicsConfig(channel="sin:24,0.5")
    assert DynamicsConfig(churn="step:t=1").forces_mask
    assert DynamicsConfig(
        channel=ChannelProcess(outage="outage:0.1,2")).forces_mask
    assert not DynamicsConfig(
        channel=ChannelProcess(uplink_bytes_per_s="sin:8,0.5")).forces_mask
    assert not DynamicsConfig(threat="signflip:0.1",
                              robust="median").forces_mask


@pytest.mark.parametrize("kw", [
    dict(churn="step:4,0.3"),
    dict(churn="lifetime:5,3", threat="scale:0.2,5@h_sk+sg",
         robust="clip:2+trimmed:0.2"),
    dict(channel="process", threat="noise:0.1", robust="median", seed=3),
], ids=["step", "lifetime-scale-chain", "process-noise-median"])
def test_describe_and_parsed_layers_match_reference(kw):
    def build(pkg):
        k = dict(kw)
        if k.get("channel") == "process":
            k["channel"] = pkg.ChannelProcess(latency_s="drift:0.1",
                                              outage="outage:0.2,2", seed=4)
        return pkg.DynamicsConfig(**k)
    mine, ref = build(tdyn), build(jdyn)
    assert mine.describe() == ref.describe()
    assert mine.forces_mask == ref.forces_mask
    if mine.threat is not None:
        assert (mine.threat.kind, mine.threat.fraction, mine.threat.param,
                mine.threat.payloads) == (ref.threat.kind, ref.threat.fraction,
                                          ref.threat.param, ref.threat.payloads)
    if mine.churn is not None:
        assert vars(mine.churn).keys() == vars(ref.churn).keys()
        assert {k: v for k, v in vars(mine.churn).items() if k != "_cache"} \
            == {k: v for k, v in vars(ref.churn).items() if k != "_cache"}


# ---------------------------------------------------------------------------
# the port's own samplers
# ---------------------------------------------------------------------------

def test_step_churn_departs_once_at_t0():
    ch = make_churn("step:t=3,frac=0.4", seed=7)
    m = 200
    assert ch.eligible_mask(2, m).all()
    after = ch.eligible_mask(3, m)
    assert 0.2 < 1.0 - after.mean() < 0.6  # about frac depart
    np.testing.assert_array_equal(after, ch.eligible_mask(9, m))
    np.testing.assert_array_equal(ch.eligible_ids(3, m),
                                  np.nonzero(after)[0])


@pytest.mark.parametrize("spec", ["poisson:0.2", "lifetime:5,3", "step:2"])
def test_churn_pure_per_id_and_deterministic(spec):
    ch1, ch2 = make_churn(spec, seed=5), make_churn(spec, seed=5)
    full = ch1.alive(np.arange(64), 4, 64)
    sub = np.array([3, 17, 42])
    np.testing.assert_array_equal(ch1.alive(sub, 4, 64), full[sub])
    np.testing.assert_array_equal(full, ch2.alive(np.arange(64), 4, 64))
    assert not np.array_equal(
        full, make_churn(spec, seed=6).alive(np.arange(64), 4, 64))


def test_poisson_churn_clients_come_and_go():
    ch = make_churn("poisson:0.2", seed=1)
    alive = np.stack([ch.eligible_mask(t, 50) for t in range(40)])
    assert ((alive[1:] != alive[:-1]).sum(axis=0) > 0).any()
    assert alive.any(axis=1).all()
    assert ((~alive[:-1]) & alive[1:]).any()  # someone returns
    assert 0.3 < alive.mean() < 0.7  # half alive on average


def test_channel_multiplier_deterministic_across_cohorts():
    cp = ChannelProcess(uplink_bytes_per_s="sin:24,0.5", seed=3)
    full = cp.multiplier("uplink_bytes_per_s", np.arange(100), t=7)
    sub = np.array([5, 50, 99])
    np.testing.assert_array_equal(
        cp.multiplier("uplink_bytes_per_s", sub, t=7), full[sub])
    np.testing.assert_array_equal(
        ChannelProcess(uplink_bytes_per_s="sin:24,0.5", seed=3).multiplier(
            "uplink_bytes_per_s", np.arange(100), t=7), full)
    assert not np.array_equal(full, ChannelProcess(
        latency_s="sin:24,0.5", seed=3).multiplier("latency_s",
                                                   np.arange(100), t=7))
    np.testing.assert_array_equal(
        cp.multiplier("latency_s", np.arange(4), t=7), np.ones(4))


def test_channel_multiplier_clipped_and_time_varying():
    cp = ChannelProcess(uplink_bytes_per_s="sin:8,0.9+drift:0.5", seed=0)
    vals = np.stack([cp.multiplier("uplink_bytes_per_s", np.arange(32), t)
                     for t in range(16)])
    assert (vals >= 0.05).all() and (vals <= 20.0).all()
    assert (vals == 0.05).any() and (vals == 20.0).any()  # both clips bite
    assert (np.ptp(vals, axis=0) > 0).all()


def test_outage_groups_are_correlated():
    cp = ChannelProcess(outage="outage:0.5,3,4", seed=2)
    m, groups = 64, 4
    hit_any = False
    for t in range(12):
        dark = cp.outage_mask(np.arange(m), t)
        for g in range(groups):
            region = dark[np.arange(m) % groups == g]
            assert region.all() or not region.any()
        hit_any = hit_any or dark.any()
        np.testing.assert_array_equal(
            dark, cp.outage_mask(np.arange(m), (t // 3) * 3))
    assert hit_any


def test_round_channel_views_and_coins():
    """``RoundChannel`` is the base model at round t with the multipliers
    on its fields and the outages OR-ed into the dropout coins, in the
    dense and the cohort views alike."""
    base = ChannelModel(**edge_channel_kwargs(M))
    cp = ChannelProcess(uplink_bytes_per_s="sin:4,0.5", latency_s="drift:0.1",
                        outage="outage:0.5,1,2", seed=5)
    cfg = CommConfig(channel=base, dynamics=DynamicsConfig(channel=cp))
    assert CommConfig(channel=base).channel_at(3) is base
    # a round in which one of the two regions is dark
    t = next(t for t in range(32)
             if cp.outage_mask(np.arange(2), t).sum() == 1)
    chan = cfg.channel_at(t)
    ids = np.array([1, 4, 6])
    mult = cp.multiplier("uplink_bytes_per_s", np.arange(M), t)
    np.testing.assert_array_equal(chan.uplink_rates(M),
                                  base.uplink_rates(M) * mult)
    np.testing.assert_array_equal(chan.uplink_rates_for(ids, M),
                                  chan.uplink_rates(M)[ids])
    np.testing.assert_array_equal(chan.latencies_for(ids, M),
                                  chan.latencies(M)[ids])
    key = tconfig.round_keys(0, t)[1]
    dense, cohort = chan.draw(key, M), chan.draw_for(key, ids)
    dark = cp.outage_mask(np.arange(M), t)
    np.testing.assert_array_equal(dense.dropout,
                                  base.draw(key, M).dropout | dark)
    np.testing.assert_array_equal(cohort.dropout,
                                  base.draw_for(key, ids).dropout | dark[ids])
    up, down = np.full(M, 100.0), np.full(M, 1000.0)
    np.testing.assert_array_equal(
        chan.client_times_for(ids, M, cohort, up[ids], down[ids]),
        chan.client_times(type(dense)(straggler=np.zeros(M, bool),
                                      dropout=dense.dropout), up, down)[ids]
        * np.where(cohort.straggler, base.straggler_slowdown, 1.0))


def test_attacker_subset_is_pure_per_id():
    th = make_threat("signflip:0.3", seed=4)
    full = th.attacker_mask(np.arange(500))
    sub = np.array([7, 77, 477])
    np.testing.assert_array_equal(th.attacker_mask(sub), full[sub])
    assert 0.15 < full.mean() < 0.45
    assert th.applies("h_sk") and make_threat(
        "signflip:0.3@h_sk+sg").payloads == ("h_sk", "sg")
    assert not make_threat("signflip:0.3@h_sk").applies("w_local")


def test_signflip_corrupts_exactly_the_attacker_rows():
    th = make_threat("signflip:0.5", seed=0)
    x = torch.randn(8, 5, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    att = torch.tensor([1, 0, 1, 0, 0, 0, 1, 0], dtype=torch.float64)
    out = th.corrupt(x, att)
    np.testing.assert_array_equal(out[[0, 2, 6]].numpy(),
                                  -x[[0, 2, 6]].numpy())
    np.testing.assert_array_equal(out[[1, 3, 4, 5, 7]].numpy(),
                                  x[[1, 3, 4, 5, 7]].numpy())


def test_clip_bounds_row_norms_and_counts():
    x = torch.tensor([[3.0, 4.0], [0.3, 0.4], [0.0, 0.0]], dtype=torch.float64)
    stats = {}
    out = make_aggregator("clip:1.0")(x, None, stats)
    assert torch.linalg.vector_norm(out, dim=1).max() <= 1.0 + 1e-12
    np.testing.assert_allclose(out[1].numpy(), x[1].numpy())
    assert float(stats["uploads_clipped"]) == 1.0


def test_trimmed_mean_defeats_sign_flips():
    rng = np.random.default_rng(0)
    honest = rng.normal(1.0, 0.05, size=(10, 6))
    x = honest.copy()
    x[:2] = -x[:2] * 5
    out = make_aggregator("trimmed:0.2")(torch.from_numpy(x), None,
                                         {}).numpy()
    np.testing.assert_allclose(out, out[:1].repeat(10, axis=0))
    np.testing.assert_allclose(out[0], honest[2:].mean(axis=0), atol=0.05)


def test_trimmed_mean_ignores_undelivered_rows():
    x = np.ones((6, 4))
    x[0] = 1e6  # undelivered garbage must not eat the trim budget
    x[1] = -50.0  # the attacker
    stats = {}
    out = make_aggregator("trimmed:0.2")(
        torch.from_numpy(x), torch.tensor([0.0, 1, 1, 1, 1, 1],
                                          dtype=torch.float64), stats)
    np.testing.assert_allclose(out[2].numpy(), np.ones(4), atol=1e-9)
    assert float(stats["uploads_trimmed"]) > 0


def test_median_is_delivered_only():
    x = np.zeros((5, 3))
    x[0] = 1e9  # undelivered
    x[1:] = [[1, 1, 1], [2, 2, 2], [3, 3, 3], [4, 4, 4]]
    out = make_aggregator("median")(
        torch.from_numpy(x), torch.tensor([0.0, 1, 1, 1, 1],
                                          dtype=torch.float64), {})
    np.testing.assert_allclose(out[0].numpy(), [2.5, 2.5, 2.5])


def test_bounded_memory_retire_frees_and_zeroes():
    store = BoundedMemory(capacity=4)
    store.gather([10, 11, 12, 13])
    store.scatter([10, 11, 12, 13],
                  {"g": torch.ones((4, 3), dtype=torch.float64)})
    assert store.retire([11, 13, 99]) == 2  # 99 was never hot
    assert store.retirements == 2
    rows = store.gather([10, 12, 20, 21])  # freed slots, no eviction
    assert store.evictions == 0
    np.testing.assert_array_equal(rows["g"][0].numpy(), np.ones(3))
    np.testing.assert_array_equal(rows["g"][2].numpy(), np.zeros(3))
    assert store.retire([10, 12, 20, 21]) == 4
    # the reference's store retires the same ids from the same slots
    ref = JBoundedMemory({"g": jax.ShapeDtypeStruct((4, 3), jnp.float64)}, 4)
    ref.gather([10, 11, 12, 13])
    assert ref.retire([11, 13, 99]) == 2
    ref.gather([10, 12, 20, 21])
    mine = BoundedMemory(capacity=4)
    mine.gather([10, 11, 12, 13])
    mine.retire([11, 13, 99])
    mine.gather([10, 12, 20, 21])
    assert mine._slot_of == ref._slot_of


# ---------------------------------------------------------------------------
# the seams: the reference's draws give the reference's layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["step:t=3,frac=0.4", "poisson:0.05",
                                  "lifetime:6,4"])
def test_churn_from_reference_uniforms(spec, monkeypatch):
    from repro_torch.dynamics import churn as tchurn

    monkeypatch.setattr(tchurn, "_per_id_uniforms", jchurn._per_id_uniforms)
    mine, ref = make_churn(spec, seed=9), jdyn.make_churn(spec, seed=9)
    for t in (0, 2, 3, 7, 19):
        np.testing.assert_array_equal(mine.eligible_mask(t, 300),
                                      ref.eligible_mask(t, 300))


def test_process_and_threat_from_reference_draws(monkeypatch):
    from repro_torch.dynamics import process as tprocess
    from repro_torch.dynamics import threat as tthreat

    monkeypatch.setattr(tprocess, "_stage_draws", _ref_stage_draws)
    monkeypatch.setattr(tprocess, "_outage_window", jprocess._outage_window)
    monkeypatch.setattr(tthreat, "_attacker_coins", lambda f, s, ids: np.asarray(
        jthreat._attacker_sampler(f, s)(jnp.asarray(ids, jnp.uint32))))
    kw = dict(uplink_bytes_per_s="sin:24,0.5", latency_s="sin:8,0.9+drift:0.3",
              outage="outage:0.3,3,5", seed=2)
    mine, ref = ChannelProcess(**kw), jdyn.ChannelProcess(**kw)
    ids = np.arange(200)
    for t in (0, 1, 5, 11, 30):
        for field in ("uplink_bytes_per_s", "latency_s", "compute_s"):
            np.testing.assert_allclose(mine.multiplier(field, ids, t),
                                       ref.multiplier(field, ids, t),
                                       rtol=1e-12, atol=0)
        np.testing.assert_array_equal(mine.outage_mask(ids, t),
                                      ref.outage_mask(ids, t))
    th, jth = make_threat("signflip:0.2", seed=3), jdyn.make_threat(
        "signflip:0.2", seed=3)
    np.testing.assert_array_equal(th.attacker_mask(ids), jth.attacker_mask(ids))


# ---------------------------------------------------------------------------
# robust aggregators and corruption against the reference
# ---------------------------------------------------------------------------

def _agg_inputs(c: int, mask_kind: "str | None", seed: int = 0):
    rng = np.random.default_rng(seed + c)
    x = rng.normal(size=(c, 3, 4))
    x[: max(1, c // 5)] *= -7.0  # a coalition of outliers
    if mask_kind is None:
        return x, None
    mask = np.ones(c)
    drop = {"even": 2 if c % 2 == 0 else 1,
            "odd": 1 if c % 2 == 0 else 2}[mask_kind]
    mask[rng.choice(c, size=min(drop, c - 1), replace=False)] = 0.0
    return x, mask


AGG_CASES = (
    [("clip:2.5", 40, None), ("clip:2.5", 3, "even")]
    + [("trimmed:0.1", c, m) for c in (2, 3, 5, 40) for m in (None, "even")]
    + [("trimmed:0.3", 5, "odd")]
    + [("median", 5, None), ("median", 6, None)]  # odd and even counts
    + [("median", 6, "even"), ("median", 6, "odd")]  # delivered 4 and 5
    + [("clip:5+trimmed:0.1", 40, "even"), ("clip:5+median", 6, None)])


@pytest.mark.parametrize("spec,c,mask_kind", AGG_CASES,
                         ids=[f"{s}-c{c}-{m}" for s, c, m in AGG_CASES])
def test_aggregator_matches_reference(spec, c, mask_kind):
    x, mask = _agg_inputs(c, mask_kind)
    tstats, jstats = {}, {}
    mine = make_aggregator(spec)(
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
        tstats)
    ref = jdyn.make_aggregator(spec)(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask), jstats)
    assert mine.shape == x.shape
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=0)
    assert tstats.keys() == jstats.keys()
    for name, v in jstats.items():
        assert float(tstats[name]) == float(v), name
    if spec == "median" and mask is None and c % 2 == 0:
        # the even count's two middle values averaged, unlike torch.median
        lower = torch.median(torch.from_numpy(x).reshape(c, -1), dim=0).values
        assert not np.allclose(mine[0].reshape(-1).numpy(), lower.numpy())


@pytest.mark.parametrize("spec", ["signflip:0.4", "scale:0.4,3.5",
                                  "noise:0.4,5"])
def test_corrupt_matches_reference(spec):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(9, 4, 4))
    att = (rng.random(9) < 0.4).astype(np.float64)
    key = jax.random.PRNGKey(11)
    ref = jdyn.make_threat(spec, seed=1).corrupt(key, jnp.asarray(x),
                                                jnp.asarray(att))
    noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape,
                                                        jnp.float64)))
    mine = make_threat(spec, seed=1).corrupt(
        torch.from_numpy(x), torch.from_numpy(att),
        noise if spec.startswith("noise") else None)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=0)
    np.testing.assert_array_equal(mine[att == 0].numpy(), x[att == 0])


def test_threat_noise_stream_is_disjoint_from_codec_noise():
    """The threat's normals come from their own stream: the codec noise
    of every uplink is the same with and without a threat."""
    assert tconfig._THREAT_KEY_STREAM == 1 << 21
    from repro.comm.config import _THREAT_KEY_STREAM as J_THREAT

    assert J_THREAT == tconfig._THREAT_KEY_STREAM
    key = tconfig.round_keys(0, 2)[2]
    cr = tconfig.CommRound(CommConfig(), {}, None, key)
    a = cr.threat_noise(tconfig._THREAT_KEY_STREAM + 1, (3, 2),
                        torch.float64, torch.device("cpu"))
    b = cr.codec_noise(1, (3, 2), torch.float64, torch.device("cpu"))
    assert not torch.equal(a, b) and a.abs().max() > 0
    assert torch.equal(a, cr.threat_noise(tconfig._THREAT_KEY_STREAM + 1,
                                          (3, 2), torch.float64,
                                          torch.device("cpu")))


# ---------------------------------------------------------------------------
# the four transport drivers
# ---------------------------------------------------------------------------

DRIVERS = ("sync", "async", "population-sync", "population-async")


def _driver_settings(driver: str) -> "tuple[dict, dict, int]":
    """(channel kwargs, CommConfig settings, rounds) of each driver."""
    if driver == "sync":
        return edge_channel_kwargs(M), dict(scheduler="bandwidth:0.5"), 3
    if driver == "async":
        return (dict(STRAGGLERS, dropout_prob=0.2),
                dict(async_mode=True, buffer_size=3, staleness="inverse"), 5)
    kw = dict(scheduler="uniform:0.01")
    if driver == "population-async":
        kw.update(async_mode=True, buffer_size=5, staleness="inverse")
    return EDGE, kw, 2


def _scenario(name: str, pkg) -> "tuple[object, dict]":
    """(DynamicsConfig of package ``pkg``, transport settings)."""
    if name == "churn":
        chan = pkg.ChannelProcess(uplink_bytes_per_s="sin:24,0.5",
                                  outage="outage:0.05,3,4", seed=1)
        return (pkg.DynamicsConfig(churn="poisson:0.05", channel=chan, seed=1),
                dict(codecs=COMP, error_feedback=True))
    if name == "signflip":
        return (pkg.DynamicsConfig(threat="signflip:0.2", robust="trimmed:0.1",
                                   seed=1), dict(codecs=DENSE_CODECS))
    return (pkg.DynamicsConfig(threat="noise:0.2,5@h_sk",
                               robust="clip:5+median", seed=1), {})


def _problem(driver, quickstart, synthetic):
    if driver.startswith("population"):
        return synthetic, 8
    return quickstart, K


def _port_run(driver, quickstart, synthetic, dynamics, **extra):
    """The port's own run (no injected draws) of ``driver``, with
    ``dynamics`` passed only when it is not the sentinel ``"absent"``."""
    (_, (tp, tw0, tw_star)), k = _problem(driver, quickstart, synthetic)
    channel, kw, rounds = _driver_settings(driver)
    kw = dict(kw, codecs=COMP, error_feedback=True, **extra)
    if dynamics != "absent":
        kw["dynamics"] = dynamics
    cfg = CommConfig(channel=ChannelModel(**channel), seed=COMM_SEED, **kw)
    return run_rounds(FLeNS(k=k, variant="plus"), tp, tw0, tw_star,
                      rounds=rounds, seed=SEED, comm=cfg)


def _trajectory(hist) -> tuple:
    return (hist.loss.tolist(), hist.grad_norm.tolist(),
            hist.cumulative_bytes.tolist(), hist.sim_time_s.tolist(),
            [t.to_dict() for t in hist.traces],
            None if hist.staleness is None else hist.staleness.tolist(),
            hist.ef_residuals)


@pytest.mark.parametrize("off", ["none", "null-config"])
@pytest.mark.parametrize("driver", DRIVERS)
def test_dynamics_off_equals_today(driver, off, quickstart, synthetic):
    today = _port_run(driver, quickstart, synthetic, "absent")
    dyn = None if off == "none" else DynamicsConfig(seed=7)
    again = _port_run(driver, quickstart, synthetic, dyn)
    assert _trajectory(again) == _trajectory(today)


def _capture_sessions(monkeypatch) -> dict:
    """Record the session each package's run_rounds makes."""
    got = {}
    for name, mod in (("ref", jbase), ("port", tbase)):
        def make(*a, _make=mod.make_session, _name=name, **k):
            got[_name] = _make(*a, **k)
            return got[_name]
        monkeypatch.setattr(mod, "make_session", make)
    return got


def _parity_runs(driver, scenario, quickstart, synthetic, monkeypatch):
    """Both packages' runs of ``scenario`` on ``driver`` under the
    reference's draws, telemetry on; returns (port, reference) histories
    and sessions."""
    ((jp, jw0, jw_star), (tp, tw0, tw_star)), k = _problem(
        driver, quickstart, synthetic)
    channel, kw, rounds = _driver_settings(driver)
    jdc, extra = _scenario(scenario, jdyn)
    tdc, _ = _scenario(scenario, tdyn)
    common = dict(seed=COMM_SEED, **kw, **extra)
    jcfg = JCommConfig(channel=JChannelModel(**channel), dynamics=jdc,
                       **common)
    tcfg = CommConfig(channel=ChannelModel(**channel), dynamics=tdc, **common)
    sessions = _capture_sessions(monkeypatch)
    monkeypatch.setattr(jflight, "EVENT_KINDS",
                        jflight.EVENT_KINDS + ("retire",))
    jh = jcore.run_rounds(jcore.make_optimizer("flens_plus", k=k), jp, jw0,
                          jw_star, rounds=rounds, seed=SEED, comm=jcfg,
                          obs=JTelemetryConfig())
    if driver == "sync":
        inject_reference_draws(monkeypatch, jcfg)
        sketch = reference_basis("srht")
    else:
        inject_event_draws(monkeypatch, jcfg)
        sketch = version_basis("srht", rounds)
    th = run_rounds(FLeNS(k=k, variant="plus", sketch=sketch), tp, tw0,
                    tw_star, rounds=rounds, seed=SEED, comm=tcfg,
                    obs=TelemetryConfig())
    return th, jh, sessions["port"], sessions["ref"]


def assert_dynamics_parity(th, jh) -> None:
    """Losses to rtol 1e-9; traces exactly but for the simulated time,
    which (a product of the channel process's multipliers) agrees to
    rtol 1e-12."""
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(th.cumulative_bytes, jh.cumulative_bytes)
    np.testing.assert_allclose(th.sim_time_s, jh.sim_time_s, rtol=1e-12,
                               atol=0)
    assert len(th.traces) == len(jh.traces) == th.rounds
    for mine, ref in zip(th.traces, jh.traces):
        a, b = mine.to_dict(), ref.to_dict()
        np.testing.assert_allclose(a.pop("sim_time_s"), b.pop("sim_time_s"),
                                   rtol=1e-12, atol=0)
        assert a == b
    assert th.ef_residuals.keys() == jh.ef_residuals.keys()
    for name, norm in jh.ef_residuals.items():
        np.testing.assert_allclose(th.ef_residuals[name], norm, rtol=1e-9)


DYNAMICS_COUNTERS = ("clients_departed", "uploads_corrupted",
                     "uploads_retired", "uploads_clipped", "uploads_trimmed")
PARITY_CASES = [(driver, scenario) for driver in DRIVERS
                for scenario in ("churn", "signflip", "noise")]


def check_dynamics_parity(driver, scenario, quickstart, synthetic,
                          monkeypatch) -> None:
    th, jh, tsess, jsess = _parity_runs(driver, scenario, quickstart,
                                        synthetic, monkeypatch)
    assert_dynamics_parity(th, jh)
    assert tsess.robust_stats == jsess.robust_stats
    tm, jm = th.telemetry["metrics"], jh.telemetry["metrics"]
    for name in DYNAMICS_COUNTERS:
        assert tm["counters"].get(name) == jm["counters"].get(name), name
    assert tm["gauges"].get("active_population") == \
        jm["gauges"].get("active_population")
    retired = [[e for e in sess.obs.flight.events() if e["kind"] == "retire"]
               for sess in (tsess, jsess)]
    assert retired[0] == retired[1]
    if driver == "async" and scenario == "churn":
        assert retired[0]  # an upload landed after its client left
    if scenario == "churn":
        np.testing.assert_array_equal(tsess._elig_prev, jsess._elig_prev)
        assert not tsess._elig_prev.all()  # someone is away
        assert tm["counters"]["clients_departed"] > 0
        assert 0 < tm["gauges"]["active_population"] < tsess.m
        return
    # the counters the threat and the aggregators fed
    assert tsess.robust_stats["uploads_corrupted"] > 0
    expect = {"signflip": {"uploads_corrupted", "uploads_trimmed"},
              "noise": {"uploads_corrupted", "uploads_clipped"}}[scenario]
    assert set(tsess.robust_stats) == expect
    # no probe round in the corrupted count: it is the delivered
    # attackers of the committed traces
    threat = tsess.config.dynamics.threat
    corrupted = sum(
        float((threat.attacker_mask(np.arange(tsess.m) if tr.ids is None
                                    else tr.ids) & tr.delivered).sum())
        for tr in th.traces)
    assert tsess.robust_stats["uploads_corrupted"] == corrupted


def test_population_cohort_padded_when_churn_shrinks_it():
    """Fewer eligible ids than the cohort size: the sync population
    driver pads the cohort with its first id under a zero mask (the
    reference's rule), bills and schedules the real ids only, and keeps
    one cohort width, so EF rows scatter for the real ids alone."""
    pop = SyntheticPopulation(m=24, dim=6, seed=2, device="cpu")
    w0 = torch.zeros(6, dtype=torch.float64)
    w_star = newton_solve(pop.eval_problem(), w0)
    dyn = DynamicsConfig(churn="step:t=1,frac=0.7", seed=3)
    cfg = CommConfig(scheduler="uniform:0.5", codecs=COMP,
                     error_feedback=True, seed=COMM_SEED, dynamics=dyn)
    hist = run_rounds(FLeNS(k=4, variant="plus"), pop, w0, w_star, rounds=3,
                      comm=cfg)
    assert np.isfinite(hist.loss).all()
    alive = dyn.churn.eligible_ids(1, 24)
    assert 0 < len(alive) < 12
    for t, tr in enumerate(hist.traces):
        assert len(tr.ids) == 12  # the cohort size every round
        n_real = 12 if t == 0 else len(alive)
        assert tr.scheduled.sum() == n_real
        assert not tr.delivered[n_real:].any()
        assert not tr.bytes_up[n_real:].any()
        if t:
            np.testing.assert_array_equal(tr.ids[:n_real], alive)
            assert (tr.ids[n_real:] == tr.ids[0]).all()


# ---------------------------------------------------------------------------
# bench_robust's invariant at the quickstart size
# ---------------------------------------------------------------------------

# bench_robust's 10% coalition (of phishing's 40 clients) and 10% trim,
# scaled to the quickstart's 8 clients: at seed 1 a 10% coalition of 8
# is empty, a quarter is one client
ROBUST_ARMS = [("clean", None, None), ("attacked", "signflip:0.25", None),
               ("trimmed", "signflip:0.25", "trimmed:0.25")]


@pytest.mark.parametrize("opt", ["flens", "fedavg"])
def test_bench_robust_invariant_matches_reference(opt, quickstart,
                                                  monkeypatch):
    """benchmarks/run.py bench_robust at the quickstart size: the three
    arms transmit the same bytes, and each arm's final loss is the
    reference's. FedAvg's attack opens a gap; FLeNS's Newton step
    cancels a sign flip of both sketches, so its gap is only held to
    the reference's."""
    (jp, jw0, jw_star), (tp, tw0, tw_star) = quickstart
    rounds = 4
    kw = dict(lr=2.0, local_steps=5) if opt == "fedavg" else dict(k=K)
    finals, ref_finals, bytes_by_arm = {}, {}, []
    for arm, threat, robust in ROBUST_ARMS:
        def comm(pkg, config, channel):
            dyn = (pkg.DynamicsConfig(threat=threat, robust=robust, seed=1)
                   if threat else None)
            return config(channel=channel(**STRAGGLERS), seed=1,
                          dynamics=dyn)
        jcfg = comm(jdyn, JCommConfig, JChannelModel)
        jh = jcore.run_rounds(jcore.make_optimizer(opt, **kw), jp, jw0,
                              jw_star, rounds=rounds, comm=jcfg)
        with monkeypatch.context() as mp:
            inject_reference_draws(mp, jcfg)
            topt = (make_optimizer(opt, **kw) if opt == "fedavg" else
                    FLeNS(k=K, sketch=reference_basis("srht")))
            th = run_rounds(topt, tp, tw0, tw_star, rounds=rounds,
                            comm=comm(tdyn, CommConfig, ChannelModel))
        np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-9, atol=0)
        np.testing.assert_array_equal(th.cumulative_bytes,
                                      jh.cumulative_bytes)
        finals[arm], ref_finals[arm] = float(th.loss[-1]), float(jh.loss[-1])
        bytes_by_arm.append(th.cumulative_bytes.tolist())
    assert bytes_by_arm[0] == bytes_by_arm[1] == bytes_by_arm[2]
    for arm in ("attacked", "trimmed"):
        gap, ref_gap = (finals[arm] - finals["clean"],
                        ref_finals[arm] - ref_finals["clean"])
        assert abs(gap - ref_gap) <= 1e-9 * (abs(finals[arm])
                                             + abs(finals["clean"]))
    if opt == "fedavg":
        assert finals["attacked"] - finals["clean"] > 0


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def test_dynamics_follow_the_session_device(monkeypatch, quickstart):
    """The attacker indicator and the threat's normals live on the
    session's device: the card unless the caller asks for the CPU, which
    raises without one; a forced CUDA kernel on a CPU run raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CommConfig(dynamics=DynamicsConfig(threat="signflip:0.5", seed=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CommSession(cfg, M, keys=None, state0=None)
    session = CommSession(cfg, M, keys=None, state0=None, device="cpu")
    mask, _ = session.begin_round(0)
    assert isinstance(mask, tuple) and mask[0] is None
    assert mask[1].device.type == "cpu" and mask[1].dtype == torch.float64
    np.testing.assert_array_equal(
        mask[1].numpy(), cfg.dynamics.threat.attacker_mask(np.arange(M)))
    cr = session.comm_round({}, mask, tconfig.round_keys(0, 0)[2])
    with pytest.raises(RuntimeError):
        cr.threat_noise(1, (2, 2), torch.float64, torch.device("cuda"))
    _, (tp, tw0, tw_star) = quickstart
    comm = CommConfig(codecs=DENSE_CODECS, dynamics=DynamicsConfig(
        threat="signflip:0.2", robust="trimmed:0.1", seed=1))
    with ops.use_impl("cuda"), pytest.raises(RuntimeError, match="impl='cuda'"):
        run_rounds(FLeNS(k=K, variant="plus"), tp, tw0, tw_star, rounds=1,
                   comm=comm)
    hist = run_rounds(FLeNS(k=K, variant="plus"), tp, tw0, tw_star, rounds=2,
                      comm=comm)
    assert np.isfinite(hist.loss).all()
