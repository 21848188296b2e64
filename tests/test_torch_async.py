"""repro_torch's asynchronous driver against repro's, on the CPU.

The event-driven ``AsyncSession`` runs FLeNS+ and FedAvg on the
quickstart problem (n=4000, dim=64, m=8, float64) on the straggler
channel of ``benchmarks/paper_common.py`` (log-spaced uplinks, 10x
downlinks, 50 ms latency, 30% stragglers at 10x), under FedBuff buffers,
a 50% quorum, ``inverse`` and ``poly:1`` staleness, dropout with
retries, EF21 under lossy codecs, a half cohort and ``server_lr`` != 1.

JAX's threefry draws cannot be made with torch generators, so the port
gets the reference's, as ``test_torch_comm.py`` injects them, extended
to the event clock: every host key the port derives
(``config.round_keys(seed, version)`` and the retry keys
``keys.fold_in(k_chan, retry)``) is looked up in a table of the
reference's keys for the same (version, retry), and the cohort
(``participants``, ``sample_ids``, under churn's eligible ids on the
version's channel), the coins (``draw``, ``draw_for``), the codec noise
and the dynamics layers' draws come from the reference's functions under
them. The sketch basis of a group round is the reference policy's under
the version's round key.

Commit times, versions, staleness, delivered sets and bytes must equal
the reference's exactly (``RoundTrace.to_dict``), the losses to rtol
1e-9 (float64; the packages sum in different orders). Full-quorum async
must equal the port's own sync bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import repro.core as jcore
from repro.comm import ChannelModel as JChannelModel
from repro.comm import CommConfig as JCommConfig
from repro.comm import make_staleness as jmake_staleness
from repro.core import sketch as jsketch
from repro.core import sketch_policy as jpolicy
from repro.core.base import root_key as jax_root_key
from repro_torch import interop
from repro_torch.comm import (
    MAX_RETRIES,
    AsyncSession,
    ChannelDraw,
    ChannelModel,
    CommConfig,
    make_session,
    make_staleness,
)
from repro_torch.comm import channel as tchannel
from repro_torch.comm import config as tconfig
from repro_torch.comm import scheduler as tscheduler
from repro_torch.core import FLeNS, make_optimizer, run_rounds
from repro_torch.core.base import root_key, split
from repro_torch.core.sketch_policy import SketchPolicy
from repro_torch.keys import fold_in, key_bits

from test_torch_comm import (  # noqa: F401
    _ref_round_keys,
    _ref_uniform,
    inject_dynamics_draws,
    quickstart,
)
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

SEED = 0
COMM_SEED = 1
M = 8
K = 32
# enough versions and retries for every key a trajectory here derives
VERSIONS = 64


def straggler_channel_kwargs(m: int) -> dict:
    """``benchmarks/paper_common.straggler_edge_channel``: log-spaced
    uplinks 3e4-3e6 B/s, 10x downlinks, 50 ms latency, 30% stragglers
    at 10x, no dropout."""
    rates = np.logspace(np.log10(3e4), np.log10(3e6), m)
    return dict(uplink_bytes_per_s=rates, downlink_bytes_per_s=10.0 * rates,
                latency_s=0.05, straggler_prob=0.30, straggler_slowdown=10.0)


def key_table(seed: int, versions: int = VERSIONS) -> dict:
    """The port's host keys (by their bits) -> the reference's keys for
    the same (version, stream) and (version, retry)."""
    table = {}
    for v in range(versions):
        port, ref = tconfig.round_keys(seed, v), _ref_round_keys(seed, v)
        for pk, jk in zip(port, ref):
            table[key_bits(pk)] = jk
        for r in range(1, MAX_RETRIES + 2):
            table[key_bits(fold_in(port[1], r))] = jax.random.fold_in(ref[1], r)
    return table


def inject_event_draws(monkeypatch, jcfg) -> None:
    """Replace every draw of the port's drivers (dense and population,
    sync and async) with the reference's under the matching key: the
    cohort, the coins (a retry's too), the codec noise, the per-id
    values of distribution-spec channel fields, and the dynamics
    layers' draws."""
    from repro.comm import channel as jchannel

    table = key_table(jcfg.seed)

    def participants(self, key, round_idx, m, channel, eligible=None):
        return np.asarray(jcfg.scheduler.participants(
            table[key_bits(key)], round_idx, m, jcfg.channel_at(round_idx),
            eligible=eligible))

    def sample_ids(self, key, round_idx, m, channel, eligible=None):
        return np.asarray(jcfg.scheduler.sample_ids(
            table[key_bits(key)], round_idx, m, jcfg.channel_at(round_idx),
            eligible=eligible))

    def draw(self, key, m):
        d = jcfg.channel.draw(table[key_bits(key)], m)
        return ChannelDraw(straggler=np.asarray(d.straggler),
                           dropout=np.asarray(d.dropout))

    def draw_for(self, key, ids):
        d = jcfg.channel.draw_for(table[key_bits(key)], ids)
        return ChannelDraw(straggler=np.asarray(d.straggler),
                           dropout=np.asarray(d.dropout))

    def codec_noise(self, stream, shape, dtype, device):
        k_codec = _ref_round_keys(jcfg.seed, self.round_idx)[2]
        return _ref_uniform(k_codec, stream, shape, dtype).to(device)

    monkeypatch.setattr(tscheduler.Scheduler, "participants", participants)
    for cls in (tscheduler.UniformSampler, tscheduler.BandwidthAware):
        monkeypatch.setattr(cls, "sample_ids", sample_ids)
    monkeypatch.setattr(tchannel.ChannelModel, "draw", draw)
    monkeypatch.setattr(tchannel.ChannelModel, "draw_for", draw_for)
    monkeypatch.setattr(tchannel, "_draw_spec", jchannel._draw_spec)
    monkeypatch.setattr(tconfig.CommRound, "codec_noise", codec_noise)
    inject_dynamics_draws(monkeypatch, jcfg)


@dataclasses.dataclass(frozen=True)
class VersionBasis(SketchPolicy):
    """Test-only policy: a round's operator is the reference policy's
    under the same trajectory key. The port's key (one of
    ``split(root_key(SEED), rounds)``) is found by its bits; the basis
    key carries its index and the state's round counter."""

    jax_keys: object = dataclasses.field(default=None, compare=False)
    index: object = dataclasses.field(default=None, compare=False)

    def basis_key(self, key, round_idx):
        return torch.tensor([self.index[key_bits(key)], int(round_idx)],
                            dtype=torch.int32)

    def materialize(self, key, dim, dtype=torch.float32, device="cuda"):
        i, t = int(key[0]), int(key[1])
        ref = jpolicy.SketchPolicy.parse(self.spec())
        bkey = ref.basis_key(jnp.asarray(self.jax_keys[i]), t)
        s = jsketch.make_sketch(bkey, self.kind, self.k, dim,
                                dtype=jnp.float64)
        return interop.sketch_from_numpy(np.asarray(s.signs),
                                         np.asarray(s.rows), self.k, dim,
                                         device=device)


def version_basis(spec: str, rounds: int, seed: int = SEED) -> VersionBasis:
    jax_keys = np.asarray(jax.random.split(jax_root_key(seed), rounds))
    port = split(root_key(seed, device="cpu"), rounds)
    index = {key_bits(port[i]): i for i in range(rounds)}
    return VersionBasis(**dataclasses.asdict(SketchPolicy.parse(spec)),
                        jax_keys=jax_keys, index=index)


def config_pair(channel: dict, **kw):
    common = dict(seed=COMM_SEED, **kw)
    return (JCommConfig(channel=JChannelModel(**channel), **common),
            CommConfig(channel=ChannelModel(**channel), **common))


def assert_same_run(th, jh) -> None:
    """Traces exactly, losses to rtol 1e-9."""
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(th.cumulative_bytes, jh.cumulative_bytes)
    np.testing.assert_array_equal(th.sim_time_s, jh.sim_time_s)
    np.testing.assert_array_equal(th.staleness, jh.staleness)
    assert len(th.traces) == len(jh.traces) == th.rounds
    for mine, ref in zip(th.traces, jh.traces):
        assert mine.to_dict() == ref.to_dict()


STRAGGLERS = straggler_channel_kwargs(M)
DROPOUT = dict(straggler_prob=0.2, dropout_prob=0.3)
COMP = {"h_sk": "sympack+qint8", "sg": "qint8", "grad": "topk0.1+qint8"}

# name -> (optimizer, channel, commits, CommConfig settings)
CASES = {
    "buffer-inverse": ("flens_plus", STRAGGLERS, 12,
                       dict(buffer_size=3, staleness="inverse")),
    "q50-inverse": ("flens_plus", STRAGGLERS, 10,
                    dict(async_quantile=0.5, staleness="inverse")),
    "buffer-poly": ("fedavg", STRAGGLERS, 12,
                    dict(buffer_size=4, staleness="poly:1")),
    "dropout-retries": ("fedavg", DROPOUT, 14,
                        dict(buffer_size=4, staleness="inverse")),
    "ef21-codecs": ("flens_plus", STRAGGLERS, 10,
                    dict(buffer_size=3, staleness="inverse", codecs=COMP,
                         error_feedback=True)),
    "server-lr": ("fedavg", STRAGGLERS, 10,
                  dict(buffer_size=4, staleness="inverse", server_lr=0.7)),
    "half-cohort": ("flens_plus", STRAGGLERS, 10,
                    dict(scheduler="uniform:0.5", buffer_size=3)),
}


def _opt_pair(name: str, rounds: int):
    if name == "fedavg":
        kw = dict(lr=2.0, local_steps=5)
        return jcore.make_optimizer(name, **kw), make_optimizer(name, **kw)
    return (jcore.make_optimizer(name, k=K),
            FLeNS(k=K, variant="plus", sketch=version_basis("srht", rounds)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_trajectory_matches_reference(quickstart, case, monkeypatch):
    (jp, jw0, jw_star), (tp, tw0, tw_star) = quickstart
    name, channel, rounds, kw = CASES[case]
    jcfg, tcfg = config_pair(channel, async_mode=True, **kw)
    jopt, topt = _opt_pair(name, rounds)
    jh = jcore.run_rounds(jopt, jp, jw0, jw_star, rounds=rounds, seed=SEED,
                          comm=jcfg)
    inject_event_draws(monkeypatch, jcfg)
    th = run_rounds(topt, tp, tw0, tw_star, rounds=rounds, seed=SEED,
                    comm=tcfg)
    assert_same_run(th, jh)
    assert th.ef_residuals.keys() == jh.ef_residuals.keys()
    for payload, norm in jh.ef_residuals.items():
        np.testing.assert_allclose(th.ef_residuals[payload], norm, rtol=1e-9)
    # the clock really ran asynchronously: someone committed stale
    assert np.nanmax(th.staleness) > 0
    if case == "dropout-retries":
        assert any((tr.scheduled & ~tr.delivered).any() for tr in th.traces)


@pytest.mark.parametrize("name,kw", [("flens", dict(k=K)),
                                     ("flens_plus", dict(k=K)),
                                     ("fedavg", {}), ("fednl", {})])
def test_full_quorum_async_bit_equal_to_sync(quickstart, name, kw):
    """Full scheduler, no dropout, full quorum: the port's async driver
    takes the lock-step branch every commit and reproduces its own sync
    trajectory bit for bit, stragglers drawn or not."""
    _, (tp, tw0, tw_star) = quickstart
    chan = ChannelModel(**STRAGGLERS)
    sync = run_rounds(make_optimizer(name, **kw), tp, tw0, tw_star, rounds=4,
                      comm=CommConfig(channel=chan, seed=COMM_SEED))
    asy = run_rounds(make_optimizer(name, **kw), tp, tw0, tw_star, rounds=4,
                     comm=CommConfig(channel=chan, seed=COMM_SEED,
                                     async_mode=True))
    np.testing.assert_array_equal(sync.loss, asy.loss)
    np.testing.assert_array_equal(sync.cumulative_bytes, asy.cumulative_bytes)
    assert all(tr.version == t + 1 for t, tr in enumerate(asy.traces))
    assert (asy.staleness == 0).all()


def test_lossy_full_quorum_matches_sync(quickstart):
    """Under lossy codecs with EF the lock-step async run still equals
    the sync one, bytes included (both bill the same plan)."""
    _, (tp, tw0, tw_star) = quickstart
    chan = ChannelModel(**STRAGGLERS)
    kw = dict(channel=chan, seed=COMM_SEED, codecs=COMP, error_feedback=True)
    sync = run_rounds(make_optimizer("flens_plus", k=K), tp, tw0, tw_star,
                      rounds=3, comm=CommConfig(**kw))
    asy = run_rounds(make_optimizer("flens_plus", k=K), tp, tw0, tw_star,
                     rounds=3, comm=CommConfig(async_mode=True, **kw))
    np.testing.assert_array_equal(sync.loss, asy.loss)
    np.testing.assert_array_equal(sync.cumulative_bytes, asy.cumulative_bytes)
    assert sync.ef_residuals == asy.ef_residuals


def test_server_lr_scales_committed_delta(quickstart):
    """A full-quorum fresh commit at server_lr 0.5 moves the model by
    half the round's delta."""
    _, (tp, tw0, tw_star) = quickstart
    opt = make_optimizer("fedavg", lr=2.0, local_steps=5)
    key = split(root_key(SEED, device="cpu"), 1)[0]
    w1 = opt.round(tp, opt.init(tp, tw0), key)["w"]
    expect = float(tp.global_value(tw0 + 0.5 * (w1 - tw0)))
    asy = run_rounds(make_optimizer("fedavg", lr=2.0, local_steps=5), tp, tw0,
                     tw_star, rounds=1,
                     comm=CommConfig(channel=ChannelModel(**STRAGGLERS),
                                     seed=COMM_SEED, async_mode=True,
                                     server_lr=0.5))
    np.testing.assert_allclose(asy.loss[-1], expect, rtol=1e-12)


def test_async_zero_rounds(quickstart):
    _, (tp, tw0, tw_star) = quickstart
    hist = run_rounds(make_optimizer("fedavg"), tp, tw0, tw_star, rounds=0,
                      comm=CommConfig(async_mode=True, buffer_size=2))
    assert len(hist.loss) == 1 and np.isfinite(hist.loss).all()
    assert hist.staleness is not None and hist.staleness.shape == (0,)


def test_snapshots_are_collected(quickstart):
    """Only versions an upload in flight or buffered refers to keep a
    snapshot, and each stays on the problem's device."""
    _, (tp, tw0, tw_star) = quickstart
    cfg = CommConfig(channel=ChannelModel(**STRAGGLERS), seed=COMM_SEED,
                     async_mode=True, buffer_size=2, staleness="inverse")
    opt = make_optimizer("fedavg")
    state = opt.init(tp, tw0)
    keys = split(root_key(SEED, device="cpu"), 12)
    session = make_session(cfg, m=M, keys=keys, state0=state, device="cpu",
                           client_weights=tp.client_weights.numpy())
    assert isinstance(session, AsyncSession)
    from repro_torch.core.base import build_round

    fn = build_round(opt, tp, session)
    session.prepare(fn)
    for _ in range(12):
        session.step(fn)
        live = ({session.version}
                | {f.version for _, _, f in session._heap if not f.dropped}
                | {v for _, v, _, _ in session._buffer})
        assert set(session._snapshots) == live
    assert len(session.traces) == 12


# ---------------------------------------------------------------------------
# staleness rules and configuration, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["constant", "inverse", "poly:1", "poly:2",
                                  "poly", "polynomial:0.25"])
def test_make_staleness_matches_reference(spec):
    mine, ref = make_staleness(spec), jmake_staleness(spec)
    for tau in (0.0, 1.0, 3.0, 17.0):
        assert mine(tau) == ref(tau)
    fn = make_staleness(lambda tau: 42.0)
    assert fn(1.0) == 42.0


BAD_CONFIGS = [dict(async_mode=True, buffer_size=0),
               dict(async_mode=True, async_quantile=0.0),
               dict(async_mode=True, async_quantile=1.5),
               dict(async_mode=True, staleness="exponential!"),
               dict(async_mode=True, server_lr=0.0),
               dict(async_mode=True, server_lr=-0.5),
               dict(server_lr=0.5),
               dict(ef_capacity=0)]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=str)
def test_config_validation_matches_reference(kw):
    with pytest.raises(Exception) as ref:
        JCommConfig(**kw)
    with pytest.raises(type(ref.value)) as mine:
        CommConfig(**kw)
    assert str(mine.value) == str(ref.value)


def test_config_accepts_the_async_settings():
    cfg = CommConfig(async_mode=True, buffer_size=10**6, async_quantile=0.5,
                     staleness="poly:2", server_lr=0.7, ef_capacity=64)
    assert cfg.buffer_size == 10**6  # the session clamps to m
    assert CommConfig(server_lr=1.0).server_lr == 1.0


def test_dynamics_config_checked_and_sample_ids_eligible():
    """dynamics= wants a DynamicsConfig, as the reference's does; under
    churn's eligible= the cohort is drawn among the eligible ids, at
    most the cohort size, all of them when fewer are alive."""
    with pytest.raises(ValueError, match="DynamicsConfig"):
        CommConfig(dynamics=object())
    key = tconfig.round_keys(0, 0)[0]
    for spec in (tscheduler.UniformSampler(0.5),
                 tscheduler.BandwidthAware(0.5)):
        eligible = np.array([1, 3, 4, 6, 7])
        ids = spec.sample_ids(key, 0, 8, ChannelModel(), eligible=eligible)
        assert len(ids) == 4 and set(ids) <= set(eligible)
        assert (np.diff(ids) > 0).all()
        np.testing.assert_array_equal(
            spec.sample_ids(key, 0, 8, ChannelModel(),
                            eligible=np.array([2, 5])), [2, 5])


def test_async_refuses_adaptive_k(quickstart):
    _, (tp, tw0, tw_star) = quickstart
    with pytest.raises(NotImplementedError, match="adaptive-k"):
        run_rounds(FLeNS(k=8, sketch="srht:adaptive"), tp, tw0, tw_star,
                   rounds=2, comm=CommConfig(async_mode=True, buffer_size=2))


def test_async_rotating_basis_with_ef_warns(quickstart):
    _, (tp, tw0, tw_star) = quickstart
    with pytest.warns(RuntimeWarning, match="rotating sketch policy"):
        run_rounds(FLeNS(k=8, variant="plus", sketch="srht:rotate=3"), tp,
                   tw0, tw_star, rounds=2,
                   comm=CommConfig(async_mode=True, buffer_size=4,
                                   codecs=COMP, error_feedback=True))
