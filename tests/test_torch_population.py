"""repro_torch's client populations against repro's, on the CPU.

  * Cohorts: ``Scheduler.sample_ids`` is the dense mask's draw, a
    client's coins (``ChannelModel.draw_for``) do not depend on who else
    rides the cohort, and ``SyntheticPopulation`` shards are a pure
    function of (seed, id).
  * The EF hot set (``BoundedMemory``) assigns, refreshes and evicts
    slots exactly as the reference's on the same id stream.
  * Partitions: the Dirichlet split (``_dirichlet_sizes``,
    ``_redistribute_cap``, ``make_problem(heterogeneity="dirichlet")``)
    equals the reference's given its proportions, and
    ``DatasetPopulation.materialize_all()`` is ``make_problem``.
  * Trajectories: ``PopulationCommSession`` and
    ``PopulationAsyncSession`` against the reference's, with the
    reference's shards (``interop.synthetic_population_from_numpy``,
    ``interop.dataset_population_from_numpy``) and its cohort, coin,
    codec-noise and sketch draws injected as ``test_torch_async.py``
    does: traces (ids, deliveries, staleness, bytes, commit times)
    exactly, losses to rtol 1e-9; the lock-step anchor across the two
    population drivers bit for bit.
  * The m = 100,000 population at q = 1e-3 in a subprocess, its peak
    RSS against a budget.
"""
import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np

import repro.core as jcore
import repro.core.federated as jfederated
from repro.comm import BoundedMemory as JBoundedMemory
from repro.comm import ChannelModel as JChannelModel
from repro.comm import CommConfig as JCommConfig
from repro.data import make_classification as jax_make_classification
from repro_torch import interop
from repro_torch.comm import (
    BoundedMemory,
    ChannelModel,
    CommConfig,
    PopulationAsyncSession,
    PopulationCommSession,
    make_scheduler,
    make_session,
)
from repro_torch.comm import config as tconfig
from repro_torch.core import (
    DatasetPopulation,
    FLeNS,
    SyntheticPopulation,
    logistic,
    make_optimizer,
    make_problem,
    newton_solve,
    run_rounds,
)
from repro_torch.core import federated as tfederated

from test_torch_async import inject_event_draws, version_basis
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

SEED = 0
COMM_SEED = 1
COMP = {"h_sk": "sympack+qint8", "sg": "qint8", "grad": "topk0.1+qint8"}
# examples/edge_clients.py's population channel: per-id links
EDGE = dict(uplink_bytes_per_s="loguniform:3e4,3e6",
            downlink_bytes_per_s="loguniform:3e5,3e7", latency_s=0.08,
            straggler_prob=0.20, straggler_slowdown=10.0, dropout_prob=0.10)


# ---------------------------------------------------------------------------
# cohorts and coins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["full", "uniform:0.1", "uniform:1e-3",
                                  "bandwidth:0.25"])
def test_sample_ids_is_the_dense_mask(spec):
    sched = make_scheduler(spec)
    chan = ChannelModel(uplink_bytes_per_s="loguniform:3e4,3e6")
    m = 2000
    for t in range(3):
        key = tconfig.round_keys(COMM_SEED, t)[0]
        ids = sched.sample_ids(key, t, m, chan)
        mask = sched.participants(key, t, m, chan)
        np.testing.assert_array_equal(np.nonzero(mask)[0], ids)
        assert (np.diff(ids) > 0).all() and len(ids) == sched.cohort_size(m)


def test_coins_independent_of_cohort_composition():
    chan = ChannelModel(straggler_prob=0.4, dropout_prob=0.3)
    key = tconfig.round_keys(COMM_SEED, 5)[1]
    a = chan.draw_for(key, np.array([3, 17, 99, 4000]))
    b = chan.draw_for(key, np.array([4000, 8, 3, 12345, 17]))
    assert a.straggler[0] == b.straggler[2] and a.dropout[0] == b.dropout[2]
    assert a.straggler[1] == b.straggler[4] and a.dropout[1] == b.dropout[4]
    assert a.straggler[3] == b.straggler[0] and a.dropout[3] == b.dropout[0]
    # another key draws other coins; the rates are near their probability
    big = chan.draw_for(key, np.arange(20000))
    other = chan.draw_for(tconfig.round_keys(COMM_SEED, 6)[1], np.arange(20000))
    assert not np.array_equal(big.dropout, other.dropout)
    assert abs(big.straggler.mean() - 0.4) < 0.02
    assert abs(big.dropout.mean() - 0.3) < 0.02


def test_cohort_views_match_the_dense_views():
    rates = np.logspace(4, 6, 50)
    chan = ChannelModel(uplink_bytes_per_s=rates, downlink_bytes_per_s="uniform:1e5,2e5",
                        latency_s=0.05, compute_s="const:0.01")
    ids = np.array([4, 9, 31])
    np.testing.assert_array_equal(chan.uplink_rates_for(ids, 50), rates[ids])
    np.testing.assert_array_equal(chan.downlink_rates_for(ids, 50),
                                  chan.downlink_rates(50)[ids])
    np.testing.assert_array_equal(chan.latencies_for(ids, 50), [0.05] * 3)
    np.testing.assert_array_equal(chan.compute_times_for(ids, 50), [0.01] * 3)
    draw = chan.draw_for(tconfig.round_keys(0, 0)[1], ids)
    up, down = np.full(3, 100.0), np.full(3, 1000.0)
    dense = chan.client_times(
        type(draw)(straggler=np.zeros(50, bool), dropout=np.zeros(50, bool)),
        np.full(50, 100.0), np.full(50, 1000.0))
    np.testing.assert_array_equal(chan.client_times_for(ids, 50, draw, up, down),
                                  dense[ids])
    assert chan.round_time_for(ids, 50, draw, np.array([True, False, True]),
                               up, down) == max(dense[4], dense[31])
    with pytest.raises(ValueError, match="uplink_bytes_per_s"):
        chan.uplink_rates_for(ids, 60)


def test_synthetic_shards_deterministic_per_id():
    pop = SyntheticPopulation(m=5000, dim=6, seed=3, heterogeneity=0.5,
                              device="cpu")
    a = pop.materialize([7, 4999, 12])
    b = pop.materialize([12, 0, 7, 33])
    for i, j in ((0, 2), (2, 0)):
        torch.testing.assert_close(a.X[i], b.X[j], rtol=0, atol=0)
        torch.testing.assert_close(a.y[i], b.y[j], rtol=0, atol=0)
        torch.testing.assert_close(a.mask[i], b.mask[j], rtol=0, atol=0)
    again = SyntheticPopulation(m=5000, dim=6, seed=3, heterogeneity=0.5,
                                device="cpu").materialize([7, 4999, 12])
    assert torch.equal(a.X, again.X) and torch.equal(a.y, again.y)
    assert not torch.equal(a.X[0], a.X[2])
    assert set(np.unique(a.y.numpy())) <= {-1.0, 0.0, 1.0}
    np.testing.assert_array_equal(a.mask.sum(1).numpy(), pop.sizes[[7, 4999, 12]])
    assert a.X.shape == (3, pop.n_shard, 6)
    assert ((pop.sizes >= 1) & (pop.sizes <= pop.n_shard)).all()
    # the eval cohort: 64 evenly spaced ids
    assert pop.eval_problem().m == 64


def test_counter_draws_match_the_channel_hash():
    """The population's torch counter hash is splitmix64, bit for bit the
    numpy one the channel's per-id fields use."""
    ids = torch.tensor([-1, 0, 1, 2**40, 99999], dtype=torch.int64)
    u = tfederated.counter_uniform(12345, ids, 5)
    from repro_torch.comm.channel import _mix

    with np.errstate(over="ignore"):
        base = _mix(_mix(np.full(5, 12345, np.uint64))
                    ^ ids.numpy().astype(np.uint64))
        z = _mix(base[:, None] ^ np.arange(5, dtype=np.uint64)[None, :])
    ref = (z >> np.uint64(11)).astype(np.float64) * 2.0 ** -53
    np.testing.assert_array_equal(u.numpy(), ref)


# ---------------------------------------------------------------------------
# the bounded EF store
# ---------------------------------------------------------------------------

def test_bounded_memory_roundtrip_and_reset():
    store = BoundedMemory(capacity=4)
    ids = [7, 2, 9]
    assert store.gather(ids) == {}  # no rows yet: the round reads zeros
    store.scatter(ids, {"g": torch.arange(12, dtype=torch.float64)
                        .reshape(3, 4)})
    back = store.gather([9, 7])
    np.testing.assert_array_equal(back["g"][0].numpy(), [8.0, 9.0, 10.0, 11.0])
    np.testing.assert_array_equal(back["g"][1].numpy(), [0.0, 1.0, 2.0, 3.0])
    assert store.nbytes == 4 * 4 * 8


def test_bounded_memory_lru_eviction_resets_cold_rows():
    store = BoundedMemory(capacity=3)
    store.gather([1, 2, 3])
    store.scatter([1, 2, 3], {"g": torch.ones((3, 4), dtype=torch.float64)})
    store.gather([1])  # refresh 1: now 2 is the LRU
    store.gather([4])  # a fresh slot, evicting 2
    store.scatter([4], {"g": 2 * torch.ones((1, 4), dtype=torch.float64)})
    assert store.evictions == 1
    np.testing.assert_array_equal(store.gather([2])["g"].numpy(), 0.0)
    np.testing.assert_array_equal(store.gather([1])["g"].numpy(), 1.0)


def test_bounded_memory_capacity_and_duplicates():
    store = BoundedMemory(capacity=2)
    with pytest.raises(ValueError, match="ef_capacity"):
        store.gather([1, 2, 3])
    with pytest.raises(ValueError):
        BoundedMemory(capacity=0)
    store = BoundedMemory(capacity=4)
    store.gather([5])
    store.scatter([5], {"g": torch.ones((1, 4), dtype=torch.float64)})
    np.testing.assert_array_equal(store.gather([5, 5, 5])["g"].numpy(),
                                  np.ones((3, 4)))
    assert store.evictions == 0


def test_bounded_memory_slots_match_reference():
    """On one id stream (cohorts padded with duplicates, as the drivers
    pad them) both stores assign the same slots, evict the same ids and
    hold the same rows."""
    rng = np.random.default_rng(0)
    spec = {"g": jax.ShapeDtypeStruct((1, 3), jnp.float64),
            "h": jax.ShapeDtypeStruct((1, 2, 2), jnp.float64)}
    ref, mine = JBoundedMemory(spec, capacity=12), BoundedMemory(capacity=12)
    for _ in range(40):
        members = list(rng.choice(40, size=rng.integers(1, 7), replace=False))
        padded = members + [members[0]] * (6 - len(members))
        jrows, trows = ref.gather(padded), mine.gather(padded)
        assert ref._slot_of == mine._slot_of
        assert ref.evictions == mine.evictions
        if trows:
            for name in spec:
                np.testing.assert_array_equal(trows[name].numpy(),
                                              np.asarray(jrows[name]))
        new = {"g": rng.normal(size=(6, 3)), "h": rng.normal(size=(6, 2, 2))}
        ref.scatter(members, {k: jnp.asarray(v) for k, v in new.items()})
        mine.scatter(members, {k: torch.tensor(v) for k, v in new.items()})
    assert ref.evictions > 0
    assert mine.nbytes == ref.nbytes
    for name, norm in ref.residual_norms().items():
        np.testing.assert_allclose(mine.residual_norms()[name], norm,
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# partitions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def class_data():
    X, y = jax_make_classification(jax.random.PRNGKey(4), 600, 16)
    return np.asarray(X), np.asarray(y)


def _ref_props(key, m, alpha):
    return np.asarray(jax.random.dirichlet(key, jnp.full((m,), alpha)),
                      dtype=np.float64)


@pytest.mark.parametrize("m,alpha,cap", [(8, 0.3, None), (8, 0.3, 1.5),
                                         (50, 0.1, 2.0), (50, 5.0, None),
                                         (600, 0.05, 3.0)])
def test_dirichlet_sizes_match_reference(m, alpha, cap):
    key = jax.random.PRNGKey(m)
    n = 600
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jfederated._dirichlet_sizes(key, n, m, alpha,
                                          max_pad_factor=cap)
        mine = tfederated._dirichlet_sizes(_ref_props(key, m, alpha), n,
                                           max_pad_factor=cap)
    np.testing.assert_array_equal(mine, ref)
    assert mine.sum() == n and mine.min() >= 1


@pytest.mark.parametrize("cap", [14, 20, 40])
def test_redistribute_cap_matches_reference(cap):
    sizes = np.random.default_rng(cap).integers(1, 10, size=30)
    sizes[3] = 120  # the total fits under 30 shards of the cap
    np.testing.assert_array_equal(tfederated._redistribute_cap(sizes, cap),
                                  jfederated._redistribute_cap(sizes, cap))


@pytest.mark.parametrize("cap", [None, 1.5])
def test_make_problem_dirichlet_matches_reference(class_data, monkeypatch, cap):
    X, y = class_data
    key = jax.random.PRNGKey(11)
    jp = jcore.make_problem(jnp.asarray(X), jnp.asarray(y), m=8, lam=1e-3,
                            objective=jcore.logistic, key=key,
                            heterogeneity="dirichlet", max_pad_factor=cap)
    monkeypatch.setattr(tfederated, "dirichlet_proportions",
                        lambda seed, m, alpha: _ref_props(key, m, alpha))
    tp = make_problem(torch.tensor(X), torch.tensor(y), m=8, lam=1e-3,
                      objective=logistic, heterogeneity="dirichlet",
                      max_pad_factor=cap, device="cpu")
    for a, b in ((tp.X, jp.X), (tp.y, jp.y), (tp.mask, jp.mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tp.client_weights.numpy(),
                               np.asarray(jp.client_weights), rtol=1e-15)
    assert len(set(tp.mask.sum(1).tolist())) > 1  # sizes really vary


def test_dirichlet_pad_blowup_warns_and_caps(class_data):
    X, y = (torch.tensor(a) for a in class_data)
    with pytest.warns(UserWarning, match="max_pad_factor"):
        make_problem(X, y, m=40, lam=1e-3, objective=logistic,
                     heterogeneity="dirichlet", dirichlet_alpha=0.05,
                     device="cpu")
    capped = make_problem(X, y, m=40, lam=1e-3, objective=logistic,
                          heterogeneity="dirichlet", dirichlet_alpha=0.05,
                          max_pad_factor=2.0, device="cpu")
    assert capped.X.shape[1] <= 2 * 15
    assert int(capped.mask.sum()) == 600


@pytest.mark.parametrize("het", ["iid", "label", "dirichlet"])
def test_materialize_all_is_make_problem(class_data, het):
    X, y = (torch.tensor(a) for a in class_data)
    kw = dict(m=7, lam=1e-3, objective=logistic, seed=3, heterogeneity=het,
              device="cpu")
    pop = DatasetPopulation(X, y, **kw)
    dense, prob = pop.materialize_all(), make_problem(X, y, **kw)
    for a, b in ((dense.X, prob.X), (dense.y, prob.y), (dense.mask, prob.mask)):
        assert torch.equal(a, b)
    # a cohort is the rows of the dense problem
    sub = pop.materialize([5, 0, 5])
    for a, b in ((sub.X, prob.X), (sub.y, prob.y), (sub.mask, prob.mask)):
        assert torch.equal(a, b[[5, 0, 5]])
    np.testing.assert_allclose(pop.client_weights,
                               prob.client_weights.numpy(), rtol=1e-15)


def test_dataset_population_from_reference_rows(class_data):
    X, y = class_data
    ref = jcore.DatasetPopulation(jnp.asarray(X), jnp.asarray(y), m=9,
                                  lam=1e-3, objective=jcore.logistic,
                                  key=jax.random.PRNGKey(2),
                                  heterogeneity="dirichlet")
    mine = interop.dataset_population_from_numpy(
        ref._rows_X, ref._rows_y, ref.sizes, ref.n_shard, 1e-3, "logistic",
        device="cpu")
    ids = np.array([8, 1, 1, 4])
    jc, tc = ref.materialize(ids), mine.materialize(ids)
    for a, b in ((tc.X, jc.X), (tc.y, jc.y), (tc.mask, jc.mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(mine.client_weights, ref.client_weights)


# ---------------------------------------------------------------------------
# trajectories against the reference
# ---------------------------------------------------------------------------

def _shards(ref_pop):
    def shards(ids):
        c = ref_pop.materialize(np.asarray(ids))
        return np.asarray(c.X), np.asarray(c.y), np.asarray(c.mask)
    return shards


@pytest.fixture(scope="module")
def synthetic():
    """A 1000-client synthetic population in both packages, the port's
    handed the reference's shards."""
    ref = jcore.SyntheticPopulation(m=1000, dim=16, seed=1,
                                    dirichlet_alpha=0.3)
    mine = interop.synthetic_population_from_numpy(
        _shards(ref), ref.sizes, ref.dim, ref.n_shard, ref.lam, "logistic",
        device="cpu")
    jw0 = jnp.zeros(16, jnp.float64)
    jw_star = jcore.newton_solve(ref.eval_problem(), jw0)
    tw0 = torch.zeros(16, dtype=torch.float64)
    tw_star = torch.tensor(np.asarray(jw_star))
    return (ref, jw0, jw_star), (mine, tw0, tw_star)


# name -> (rounds, CommConfig settings)
POPULATION_CASES = {
    "sync-edge-ef": (8, dict(scheduler="uniform:0.01", codecs=COMP,
                             error_feedback=True, channel=EDGE)),
    "sync-bandwidth-evicting": (8, dict(scheduler="bandwidth:0.01",
                                        codecs=COMP, error_feedback=True,
                                        ef_capacity=12, channel=EDGE)),
    "async-buffer-ef": (12, dict(scheduler="uniform:0.01", codecs=COMP,
                                 error_feedback=True, async_mode=True,
                                 buffer_size=5, staleness="inverse",
                                 channel=EDGE)),
    "async-q50-heavy-dropout": (10, dict(scheduler="uniform:0.01",
                                         async_mode=True, async_quantile=0.5,
                                         staleness="poly:1", server_lr=0.8,
                                         channel=dict(EDGE, dropout_prob=0.6))),
}


@pytest.mark.parametrize("case", sorted(POPULATION_CASES))
def test_population_trajectory_matches_reference(synthetic, case,
                                                 monkeypatch):
    (ref, jw0, jw_star), (mine, tw0, tw_star) = synthetic
    rounds, kw = POPULATION_CASES[case]
    kw = dict(kw)
    channel = kw.pop("channel")
    jcfg = JCommConfig(channel=JChannelModel(**channel), seed=COMM_SEED, **kw)
    tcfg = CommConfig(channel=ChannelModel(**channel), seed=COMM_SEED, **kw)
    jh = jcore.run_rounds(jcore.make_optimizer("flens_plus", k=8), ref, jw0,
                          jw_star, rounds=rounds, seed=SEED, comm=jcfg)
    inject_event_draws(monkeypatch, jcfg)
    th = run_rounds(FLeNS(k=8, variant="plus",
                          sketch=version_basis("srht", rounds)),
                    mine, tw0, tw_star, rounds=rounds, seed=SEED, comm=tcfg)
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(th.cumulative_bytes, jh.cumulative_bytes)
    np.testing.assert_array_equal(th.sim_time_s, jh.sim_time_s)
    assert len(th.traces) == len(jh.traces) == rounds
    for a, b in zip(th.traces, jh.traces):
        assert a.to_dict() == b.to_dict()
        assert a.population == 1000 and a.ids is not None
    assert th.ef_residuals.keys() == jh.ef_residuals.keys()
    for payload, norm in jh.ef_residuals.items():
        np.testing.assert_allclose(th.ef_residuals[payload], norm, rtol=1e-9)
    assert th.clients == 1000


@pytest.mark.parametrize("opt,kw", [("flens_plus", dict(k=8)),
                                    ("fedavg", dict(lr=1.0, local_steps=2))])
def test_population_lockstep_bit_equal_across_drivers(opt, kw):
    """Full scheduler, no dropout, full quorum: the population async
    driver reproduces the population sync one bit for bit. A commit's
    cohort lists its members in arrival order (as the reference's does),
    so the anchor needs a channel on which every client's cycle takes
    the same time: arrivals then come in id order."""
    pop = SyntheticPopulation(m=24, dim=6, seed=2, device="cpu")
    w0 = torch.zeros(6, dtype=torch.float64)
    w_star = newton_solve(pop.eval_problem(), w0)
    base = dict(channel=ChannelModel(), seed=COMM_SEED, codecs=COMP,
                error_feedback=True)
    sync = run_rounds(make_optimizer(opt, **kw), pop, w0, w_star, rounds=4,
                      comm=CommConfig(**base))
    asy = run_rounds(make_optimizer(opt, **kw), pop, w0, w_star, rounds=4,
                     comm=CommConfig(async_mode=True, **base))
    np.testing.assert_array_equal(sync.loss, asy.loss)
    np.testing.assert_array_equal(sync.cumulative_bytes, asy.cumulative_bytes)
    assert sync.ef_residuals == asy.ef_residuals


def test_population_sessions_and_footprint():
    """make_session picks the population drivers; EF rows scale with the
    hot set (8 x cohort by default), not the population."""
    pop = SyntheticPopulation(m=256, dim=6, seed=2, device="cpu")
    keys = torch.zeros((3, 2), dtype=torch.int32)
    state = {"w": torch.zeros(6, dtype=torch.float64)}
    cfg = CommConfig(scheduler="uniform:0.125", codecs="topk0.5",
                     error_feedback=True)
    s = make_session(cfg, m=256, keys=keys, state0=state, device="cpu",
                     population=pop)
    assert isinstance(s, PopulationCommSession) and s.cohort_size == 32
    assert s.ef_store.capacity == 8 * 32
    a = make_session(CommConfig(async_mode=True, buffer_size=4), m=256,
                     keys=keys, state0=state, device="cpu", population=pop)
    assert isinstance(a, PopulationAsyncSession) and a.quorum == 4
    w0 = torch.zeros(6, dtype=torch.float64)
    h = run_rounds(make_optimizer("fedavg", lr=1.0, local_steps=2), pop, w0,
                   newton_solve(pop.eval_problem(), w0), rounds=3, comm=cfg)
    assert h.ef_residuals and np.isfinite(h.loss).all()
    assert all(len(tr.ids) == 32 for tr in h.traces)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_pop():
    pop = SyntheticPopulation(m=40, dim=6, seed=0, device="cpu")
    w0 = torch.zeros(6, dtype=torch.float64)
    return pop, w0, newton_solve(pop.eval_problem(), w0)


def test_population_refuses_per_client_state(small_pop):
    pop, w0, w_star = small_pop
    with pytest.raises(NotImplementedError, match="per_client_state"):
        run_rounds(make_optimizer("fednew"), pop, w0, w_star, rounds=2,
                   comm=CommConfig(scheduler="uniform:0.5"))


def test_population_requires_comm(small_pop):
    pop, w0, w_star = small_pop
    with pytest.raises(ValueError, match="CommConfig"):
        run_rounds(make_optimizer("fedavg"), pop, w0, w_star, rounds=2)


def test_population_async_refuses_adaptive_k(small_pop):
    pop, w0, w_star = small_pop
    with pytest.raises(NotImplementedError, match="adaptive-k"):
        run_rounds(FLeNS(k=4, sketch="srht:adaptive"), pop, w0, w_star,
                   rounds=2, comm=CommConfig(scheduler="uniform:0.5",
                                             async_mode=True, buffer_size=4))


def test_population_obs_still_raises(small_pop):
    """Telemetry is ported: a TelemetryConfig runs over a population and
    anything else is still refused."""
    from repro_torch.obs import TelemetryConfig
    pop, w0, w_star = small_pop
    with pytest.raises(TypeError, match="obs"):
        run_rounds(make_optimizer("fedavg"), pop, w0, w_star, rounds=1,
                   comm=CommConfig(scheduler="uniform:0.5"), obs=object())
    hist = run_rounds(make_optimizer("fedavg"), pop, w0, w_star, rounds=1,
                      comm=CommConfig(scheduler="uniform:0.5"),
                      obs=TelemetryConfig())
    assert hist.telemetry["metrics"]["counters"]["scheduled_client_rounds"] \
        == 20


# ---------------------------------------------------------------------------
# m = 100,000 in bounded memory
# ---------------------------------------------------------------------------

_SMOKE_100K = """
import dataclasses

import torch
from repro_torch.comm import ChannelModel, CommConfig
from repro_torch.core import SyntheticPopulation, make_optimizer, newton_solve, run_rounds

pop = SyntheticPopulation(m=100_000, dim=16, seed=1, dirichlet_alpha=0.3,
                          device="cpu")
w0 = torch.zeros(16, dtype=torch.float64)
w_star = newton_solve(pop.eval_problem(), w0)
comm = CommConfig(scheduler="uniform:1e-3", codecs={CODECS}, seed=1,
                  error_feedback=True, channel=ChannelModel(**{EDGE}))
for mode in ({{}}, {{"async_mode": True, "buffer_size": 50,
                    "staleness": "inverse"}}):
    cfg = dataclasses.replace(comm, **mode)
    h = run_rounds(make_optimizer("flens_plus", k=8), pop, w0, w_star,
                   rounds=5, comm=cfg)
    assert h.traces[0].population == 100_000
    assert max(len(tr.ids) for tr in h.traces) <= 2 * 100, h.traces[0].ids
    assert h.loss[-1] < h.loss[0], list(h.loss)
hwm_kib = next(line for line in open("/proc/self/status")
               if line.startswith("VmHWM")).split()[1]
print(f"OK {{int(hwm_kib) / 1024:.0f}}")
"""

# the (100,000, 64, 16) float64 features alone are ~780 MiB; the
# population run holds a cohort of 100 clients on top of the
# interpreter and torch (~350 MiB)
RSS_BUDGET_MIB = 700


def test_population_100k_memory_bounded():
    """m = 100,000 at q = 1e-3 under the edge codecs with EF, sync then
    async, in a subprocess so its RSS high-water mark is its own."""
    code = _SMOKE_100K.format(CODECS=repr(COMP), EDGE=repr(EDGE))
    env = dict(os.environ, OMP_NUM_THREADS=str(worker_threads()))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout
    rss_mib = float(proc.stdout.split()[1])
    assert rss_mib < RSS_BUDGET_MIB, f"peak RSS {rss_mib:.0f} MiB"
