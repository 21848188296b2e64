"""repro_torch's synchronous transport against repro's, on the CPU.

The codecs, error feedback, channel, schedulers and the whole sync
driver are held against ``repro.comm`` on the same numpy inputs.
JAX's threefry draws cannot be made with torch generators, so every draw
of the port is replaced by the reference's numbers through the one
method that makes it:

  * the cohort: ``Scheduler.participants`` gets the reference
    scheduler's draw from ``split(fold_in(PRNGKey(seed), t), 3)[0]``;
  * the straggler and dropout coins: ``ChannelModel.draw`` gets the
    reference channel's draw from key ``[1]`` of that split;
  * the codec noise: ``CommRound.codec_noise`` gets the reference's
    uniforms, ``uniform(split(fold_in(k_codec, n), m)[j], shape)`` for
    the n-th uplink and ``uniform(fold_in(k_codec, 2^20 + i), shape)``
    for the i-th downlink (``k_codec`` is key ``[2]``);
  * the sketch: a test-only policy rebuilds round t's basis from the
    reference policy's ``basis_key(split(root_key(seed), rounds)[t], t)``;
  * scenario dynamics (``tests/test_torch_dynamics.py``): the churn
    uniforms (``_per_id_uniforms``), the channel process's per-id phases
    and signs (``_stage_draws``) and outage coins (``_outage_window``),
    the attacker coins (``_attacker_coins``) and a ``noise`` threat's
    normals (``CommRound.threat_noise``, ``normal(fold_in(k_codec,
    2^21 + n), shape)``); the cohort then comes from the reference's
    scheduler under churn's eligible ids, on its channel of round t.

Trajectories run FLeNS and FLeNS+ on the quickstart problem (n=4000,
dim=64, m=8, k=32, float64) under two transports of
``examples/edge_clients.py`` on its edge channel. The loss must agree to
rtol 1e-9 (float64; the packages sum in different orders), the byte and
simulated-time axes and every ``RoundTrace`` exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

import repro.core as jcore
import repro.core.base as jbase
import repro.core.flens as jflens
from repro.comm import ChannelModel as JChannelModel
from repro.comm import CommConfig as JCommConfig
from repro.comm import codecs as jcodecs
from repro.comm import feedback as jfeedback
from repro.comm import session as jsession
from repro.comm.channel import ChannelDraw as JChannelDraw
from repro.comm.config import _DOWNLINK_KEY_STREAM as J_DOWN_STREAM
from repro.dynamics import churn as jchurn
from repro.dynamics import process as jprocess
from repro.dynamics import threat as jthreat
from repro.core import sketch as jsketch
from repro.core import sketch_policy as jpolicy
from repro.core.base import History as JHistory
from repro.core.base import root_key as jax_root_key
from repro.data import make_classification as jax_make_classification
from repro_torch import interop
from repro_torch.comm import (
    CODEC_SPECS,
    NULL_COMM,
    BandwidthAware,
    ChannelDraw,
    ChannelModel,
    CommConfig,
    CommSession,
    FullParticipation,
    RoundTrace,
    UniformSampler,
    make_codec,
    make_scheduler,
    make_session,
    summarize,
)
from repro_torch.comm import channel as tchannel
from repro_torch.comm import config as tconfig
from repro_torch.comm import feedback as tfeedback
from repro_torch.comm import scheduler as tscheduler
from repro_torch.comm.config import _DOWNLINK_KEY_STREAM
from repro_torch.core import FLeNS, History, newton_solve, run_rounds
from repro_torch.core.base import build_round, root_key, split
from repro_torch.core.sketch_policy import SketchPolicy
from repro_torch.dynamics import churn as tchurn
from repro_torch.dynamics import process as tprocess
from repro_torch.dynamics import threat as tthreat
from repro_torch.keys import key_from_ints

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

ROUNDS = 8
SEED = 0
COMM_SEED = 1
M = 8
K = 32

TRANSPORTS = {  # examples/edge_clients.py: name -> (sketch, codecs)
    "comp+sched+ef": ("srht", {"h_sk": "sympack+qint8", "sg": "qint8",
                               "grad": "topk0.1+qint8"}),
    "crush+rot+ef": ("srht:rotate=6", {"h_sk": "topk0.25", "sg": "topk0.5",
                                       "grad": "topk0.1+qint8"}),
}


def _jdt(dtype):
    return jnp.float64 if dtype == torch.float64 else jnp.float32


def _ref_round_keys(seed: int, t: int):
    """The reference session's (sched, chan, codec) keys of round t."""
    return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), t), 3)


def _ref_uniform(k_codec, stream: int, shape: tuple, dtype) -> torch.Tensor:
    """The reference's codec noise for one payload occurrence, stacked
    like the port's: uplinks split the payload key over the rows, a
    downlink draws one payload's worth."""
    jdt = _jdt(dtype)
    if stream < J_DOWN_STREAM:
        keys = jax.random.split(jax.random.fold_in(k_codec, stream), shape[0])
        u = jax.vmap(lambda k: jax.random.uniform(k, shape[1:], jdt))(keys)
    else:
        u = jax.random.uniform(jax.random.fold_in(k_codec, stream),
                               shape[1:], jdt)[None]
    return torch.from_numpy(np.array(u))


@functools.lru_cache(maxsize=None)
def _ref_per_id(kind: str, spec, salt: int, n: int) -> np.ndarray:
    """A reference per-id draw for ids 0..n-1, keyed as the reference
    keys it: ``"stages"`` the (n, stages) draws of ``_mod_sampler`` (a
    sin stage's phase, a drift stage's sign), ``"attacker"`` the (n,)
    coins of ``_attacker_sampler`` (``spec`` the fraction)."""
    ids = jnp.arange(n, dtype=jnp.uint32)
    if kind == "attacker":
        return np.asarray(jthreat._attacker_sampler(spec, salt)(ids))
    stages = jprocess._parse_modulator(spec)
    key0 = jax.random.PRNGKey(np.uint32(salt))

    def one(cid):
        out = []
        for i, (kind, params) in enumerate(stages):
            k = jax.random.fold_in(jax.random.fold_in(key0, i), cid)
            out.append(jax.random.uniform(k) * params[0] if kind == "sin"
                       else jnp.where(jax.random.bernoulli(k), 1.0, -1.0))
        return jnp.stack(out)

    return np.asarray(jax.vmap(one)(ids), dtype=np.float64)


def _ref_rows(kind: str, spec, salt: int, ids) -> np.ndarray:
    """``_ref_per_id``'s rows of ``ids``, drawn over a power-of-two span
    of ids so that few spans are ever drawn."""
    ids = np.asarray(ids, dtype=np.int64)
    n = 1 << max(3, int(ids.max(initial=0)) + 1).bit_length()
    return _ref_per_id(kind, spec, salt, n)[ids]


def _ref_stage_draws(spec: str, salt: int, ids) -> list:
    return list(_ref_rows("stages", spec, salt, ids).T)


def inject_dynamics_draws(monkeypatch, jcfg) -> None:
    """The dynamics layers' draws: the reference's (module docstring)."""
    def attacker_coins(fraction, salt, ids):
        return _ref_rows("attacker", fraction, salt, ids)

    def threat_noise(self, stream, shape, dtype, device):
        k_codec = _ref_round_keys(jcfg.seed, self.round_idx)[2]
        z = jax.random.normal(jax.random.fold_in(k_codec, stream), shape,
                              _jdt(dtype))
        return torch.from_numpy(np.array(z)).to(device)

    monkeypatch.setattr(tchurn, "_per_id_uniforms", jchurn._per_id_uniforms)
    monkeypatch.setattr(tprocess, "_stage_draws", _ref_stage_draws)
    monkeypatch.setattr(tprocess, "_outage_window", jprocess._outage_window)
    monkeypatch.setattr(tthreat, "_attacker_coins", attacker_coins)
    monkeypatch.setattr(tconfig.CommRound, "threat_noise", threat_noise)


def inject_reference_draws(monkeypatch, jcfg) -> None:
    """Replace the port's cohort, coin, codec-noise and dynamics draws
    with the reference session's (see the module docstring)."""
    now = {}
    begin_round = tconfig.CommSession.begin_round

    def begin_round_at(self, t):
        now["t"] = t
        return begin_round(self, t)

    def participants(self, key, round_idx, m, channel, eligible=None):
        k_sched = _ref_round_keys(jcfg.seed, round_idx)[0]
        return np.asarray(jcfg.scheduler.participants(
            k_sched, round_idx, m, jcfg.channel_at(round_idx),
            eligible=eligible))

    def draw(self, key, m):
        d = jcfg.channel.draw(_ref_round_keys(jcfg.seed, now["t"])[1], m)
        return ChannelDraw(straggler=np.asarray(d.straggler),
                           dropout=np.asarray(d.dropout))

    def codec_noise(self, stream, shape, dtype, device):
        k_codec = _ref_round_keys(jcfg.seed, self.round_idx)[2]
        return _ref_uniform(k_codec, stream, shape, dtype).to(device)

    monkeypatch.setattr(tconfig.CommSession, "begin_round", begin_round_at)
    monkeypatch.setattr(tscheduler.Scheduler, "participants", participants)
    monkeypatch.setattr(tchannel.ChannelModel, "draw", draw)
    monkeypatch.setattr(tconfig.CommRound, "codec_noise", codec_noise)
    inject_dynamics_draws(monkeypatch, jcfg)


@dataclasses.dataclass(frozen=True)
class ReferenceBasis(SketchPolicy):
    """Test-only policy: round t's operator is the reference policy's
    draw. Its basis key carries t through the ``seed`` broadcast (an
    int32 pair, the 8 bytes of a key)."""

    jax_keys: object = dataclasses.field(default=None, compare=False)

    def basis_key(self, key, round_idx):
        return torch.tensor([round_idx, 0], dtype=torch.int32)

    def materialize(self, key, dim, dtype=torch.float32, device="cuda"):
        t = int(key[0])
        ref = jpolicy.SketchPolicy.parse(self.spec())
        bkey = ref.basis_key(jnp.asarray(self.jax_keys[t]), t)
        s = jsketch.make_sketch(bkey, self.kind, self.k, dim,
                                dtype=jnp.float64)
        return interop.sketch_from_numpy(np.asarray(s.signs),
                                         np.asarray(s.rows), self.k, dim,
                                         device=device)


def reference_basis(spec: str) -> ReferenceBasis:
    keys = np.asarray(jax.random.split(jax_root_key(SEED), ROUNDS))
    base = SketchPolicy.parse(spec)
    return ReferenceBasis(**dataclasses.asdict(base), jax_keys=keys)


def edge_channel_kwargs(m: int) -> dict:
    """``examples/edge_clients.py``'s channel: log-spaced uplinks, 10x
    downlinks, 80 ms latency, 20% stragglers x10, 10% dropout."""
    rates = np.logspace(np.log10(3e4), np.log10(3e6), m)
    return dict(uplink_bytes_per_s=rates, downlink_bytes_per_s=10.0 * rates,
                latency_s=0.08, straggler_prob=0.20, straggler_slowdown=10.0,
                dropout_prob=0.10)


def config_pair(codecs, **kw):
    chan = edge_channel_kwargs(M)
    common = dict(codecs=codecs, seed=COMM_SEED, **kw)
    return (JCommConfig(channel=JChannelModel(**chan), **common),
            CommConfig(channel=ChannelModel(**chan), **common))


@pytest.fixture(scope="module")
def quickstart():
    X, y = jax_make_classification(jax.random.PRNGKey(0), n=4000, dim=64)
    jp = jcore.make_problem(X, y, m=M, lam=1e-3, objective=jcore.logistic)
    jw0 = jnp.zeros((64,), jnp.float64)
    jw_star = jcore.newton_solve(jp, jw0)
    tp = interop.problem_from_numpy(np.asarray(jp.X), np.asarray(jp.y),
                                    np.asarray(jp.mask), jp.lam, "logistic",
                                    device="cpu")
    tw0 = torch.zeros(64, dtype=torch.float64)
    tw_star = newton_solve(tp, tw0)
    return (jp, jw0, jw_star), (tp, tw0, tw_star)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["paper", "plus"])
@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
def test_transport_trajectory_matches_reference(quickstart, transport,
                                                variant, monkeypatch,
                                                tmp_path):
    (jp, jw0, jw_star), (tp, tw0, tw_star) = quickstart
    sketch, codecs = TRANSPORTS[transport]
    jcfg, tcfg = config_pair(codecs, scheduler="bandwidth:0.5",
                             error_feedback=True)
    jname = "flens_plus" if variant == "plus" else "flens"
    jh = jcore.run_rounds(jcore.make_optimizer(jname, k=K, sketch=sketch),
                          jp, jw0, jw_star, rounds=ROUNDS, seed=SEED,
                          comm=jcfg)
    inject_reference_draws(monkeypatch, jcfg)
    th = run_rounds(FLeNS(k=K, variant=variant,
                          sketch=reference_basis(sketch)),
                    tp, tw0, tw_star, rounds=ROUNDS, seed=SEED, comm=tcfg)
    assert th.name == jh.name
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-9, atol=0)
    live = jh.gap > 1e-10
    np.testing.assert_allclose(th.gap[live], jh.gap[live], rtol=1e-9)
    np.testing.assert_allclose(th.grad_norm, jh.grad_norm, rtol=1e-7)
    # the byte and time axes and every trace, exactly
    np.testing.assert_array_equal(th.cumulative_bytes, jh.cumulative_bytes)
    np.testing.assert_array_equal(th.sim_time_s, jh.sim_time_s)
    assert len(th.traces) == len(jh.traces) == ROUNDS
    for mine, ref in zip(th.traces, jh.traces):
        assert mine.to_dict() == ref.to_dict()
    assert summarize(th.traces) == summarize(jh.traces)
    # some client dropped or straggled, and half the clients were asked
    assert any((~tr.delivered & tr.scheduled).any() or tr.straggler.any()
               for tr in th.traces)
    assert all(tr.scheduled.sum() == M // 2 for tr in th.traces)
    assert th.ef_residuals.keys() == jh.ef_residuals.keys()
    # EF covers FLeNS+'s gradient, and h_sk, sg under the rotating basis
    assert bool(th.ef_residuals) == (variant == "plus"
                                     or transport == "crush+rot+ef")
    for name, norm in jh.ef_residuals.items():
        np.testing.assert_allclose(th.ef_residuals[name], norm, rtol=1e-9)
    # both JSONL readers take the other package's file, traces included
    back = JHistory.from_jsonl(th.to_jsonl(tmp_path / "t.jsonl"))
    assert [tr.to_dict() for tr in back.traces] == [
        tr.to_dict() for tr in th.traces]
    np.testing.assert_array_equal(back.sim_time_s, th.sim_time_s)
    mine = History.from_jsonl(jh.to_jsonl(tmp_path / "j.jsonl"))
    assert [tr.to_dict() for tr in mine.traces] == [
        tr.to_dict() for tr in jh.traces]
    assert mine.ef_residuals == jh.ef_residuals


def test_uplink_bytes_per_delivering_client(quickstart):
    """The per-client plan of both transports, against the reference's
    codecs: (k=32, M=64) here; the chip check reads the SUSY size."""
    (_, _, _), (tp, tw0, tw_star) = quickstart
    for transport, want in (("comp+sched+ef", 532 + 36 + 39 + 8),
                            ("crush+rot+ef", 256 * 12 + 16 * 12 + 39 + 8)):
        sketch, codecs = TRANSPORTS[transport]
        _, tcfg = config_pair(codecs, scheduler="bandwidth:0.5",
                              error_feedback=True)
        th = run_rounds(FLeNS(k=K, variant="plus", sketch=sketch), tp, tw0,
                        tw_star, rounds=2, comm=tcfg)
        got = {float(v) for tr in th.traces for v in tr.bytes_up if v}
        assert got == {float(want)}, transport
        jc = {n: jcodecs.make_codec(s) for n, s in codecs.items()}
        assert want == (jc["h_sk"].nbytes((K, K), jnp.float64)
                        + jc["sg"].nbytes((K,), jnp.float64)
                        + jc["grad"].nbytes((64,), jnp.float64) + 8)


def test_one_round_from_a_reference_mid_trajectory_state(quickstart,
                                                         monkeypatch):
    """The reference session's state and EF memory after 3 rounds, handed
    over as numpy, advance through one port round to the reference's
    next state, memory and trace."""
    (jp, jw0, _), (tp, _, _) = quickstart
    sketch, codecs = TRANSPORTS["crush+rot+ef"]
    jcfg, tcfg = config_pair(codecs, scheduler="bandwidth:0.5",
                             error_feedback=True)
    jopt = jflens.FLeNS(k=K, variant="plus", sketch=sketch)
    js = jopt.init(jp, jw0)
    jkeys = jax.random.split(jax_root_key(SEED), ROUNDS)
    jsess = jsession.make_session(
        jcfg, m=M, mask_dtype=jnp.float64,
        client_weights=np.asarray(jp.client_weights), keys=jkeys, state0=js,
        formula_bytes_per_round=0.0)
    _round, trace_with = jbase.build_round(jopt, jp, jsess, jkeys[0])
    jsess.prepare(trace_with(js))
    jsess.begin_variant(None, trace_with(js))
    fn = jax.jit(_round)
    for _ in range(3):
        jsess.step(fn)
    mid_state = {n: np.asarray(v) for n, v in jsess._state.items()}
    mid_memory = {n: np.asarray(v) for n, v in jsess.ef_memory.items()}
    jsess.step(fn)

    inject_reference_draws(monkeypatch, jcfg)
    state, memory = interop.transport_state_from_numpy(mid_state, mid_memory,
                                                       device="cpu")
    assert state["t"] == 3 and set(memory) == {"h_sk", "sg", "grad"}
    topt = FLeNS(k=K, variant="plus", sketch=reference_basis(sketch))
    topt.init(tp, torch.zeros(64, dtype=torch.float64))
    session = CommSession(tcfg, M, keys=split(root_key(SEED, device="cpu"),
                                              ROUNDS),
                          state0=state, mask_dtype=torch.float64,
                          device="cpu")
    session.ef_memory = memory
    session._t = 3
    session.begin_variant(None)
    out = session.step(build_round(topt, tp, session))
    for name in ("w", "w_prev", "loss", "scale"):
        np.testing.assert_allclose(out[name].numpy(),
                                   np.asarray(jsess._state[name]),
                                   rtol=1e-10, atol=1e-14, err_msg=name)
    for name, mem in jsess.ef_memory.items():
        np.testing.assert_allclose(session.ef_memory[name].numpy(),
                                   np.asarray(mem), rtol=1e-9, atol=1e-13,
                                   err_msg=name)
    assert session.traces[-1].to_dict() == jsess.traces[-1].to_dict()


@pytest.mark.parametrize("variant", ["paper", "plus"])
def test_identity_full_participation_is_bit_identical_to_no_transport(
        quickstart, variant):
    (_, _, _), (tp, tw0, tw_star) = quickstart
    bare = run_rounds(FLeNS(k=K, variant=variant), tp, tw0, tw_star,
                      rounds=4)
    for comm in (CommConfig(),
                 CommConfig(codecs={"h_sk": "identity", "default": "raw"},
                            channel=ChannelModel(straggler_prob=0.5))):
        th = run_rounds(FLeNS(k=K, variant=variant), tp, tw0, tw_star,
                        rounds=4, comm=comm)
        np.testing.assert_array_equal(th.loss, bare.loss)
        np.testing.assert_array_equal(th.grad_norm, bare.grad_norm)
        np.testing.assert_array_equal(th.cumulative_bytes,
                                      bare.cumulative_bytes)
        assert th.ef_residuals == {} and len(th.traces) == 4
        assert (th.sim_time_s[1:] > 0).all() and bare.traces is None


def test_identity_round_returns_the_same_objects(quickstart):
    """CommRound with identity codecs and no mask hands every payload and
    the weights back untouched."""
    (_, _, _), (tp, _, _) = quickstart
    session = make_session(CommConfig(), m=M, keys=torch.zeros(1, 2),
                           state0=None, device="cpu")
    session.begin_variant(None)
    cr = session.comm_round({}, None, key_from_ints(0))
    x = torch.ones(M, 3, dtype=torch.float64)
    w = torch.ones(5, dtype=torch.float64)
    p = tp.client_weights
    assert cr.uplink("h_sk", x) is x and cr.downlink("w", w) is w
    assert cr.weights(p) is p and cr.memory_out == {}
    assert session.plan == {"h_sk": 24, "down:w": 40}
    assert NULL_COMM.where_delivered(x, None) is x and NULL_COMM.mask is None


# ---------------------------------------------------------------------------
# codecs and error feedback
# ---------------------------------------------------------------------------

CODECS = ["identity", "fp16", "bf16", "qint8", "topk0.1", "topk@5",
          "topk1.0", "topk0.25+qint8", "topk@3+fp16", "sympack",
          "sympack+qint8", "sympack+bf16", "sympack+topk0.5+qint8"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("spec", CODECS)
def test_codec_matches_reference(spec, dtype):
    """Names, flags and nbytes equal; the round trip of 4 stacked
    payloads with the reference's per-client noise is bit-equal."""
    jc, tc = jcodecs.make_codec(spec), make_codec(spec)
    assert (tc.name, tc.deterministic, tc.lossless) == (
        jc.name, jc.deterministic, jc.lossless)
    shapes = ([(10, 10), (1, 1), (32, 32)] if "sympack" in spec
              else [(18,), (10, 10), (), (1000,)])
    for shape in shapes:
        assert tc.nbytes(shape, dtype) == jc.nbytes(shape, _jdt(dtype))
    shape = shapes[0]
    rng = np.random.default_rng(len(spec))
    x = (rng.standard_normal((4,) + shape) * 3).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    want = np.asarray(jax.vmap(jc.roundtrip)(keys, jnp.asarray(x)))
    u = None
    if not tc.deterministic:
        noise = tc.noise_shape(shape)
        u = torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.uniform(k, noise, _jdt(dtype)))(keys)))
    got = tc.roundtrip(torch.from_numpy(x), u)
    assert got.dtype == dtype and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_codec_spec_errors_match_reference():
    assert CODEC_SPECS == jcodecs.CODEC_SPECS
    for bad in ("zstd", "topk0.1+sympack", "qint8+fp16", "topk1.5"):
        with pytest.raises(ValueError) as mine:
            make_codec(bad)
        with pytest.raises(ValueError) as ref:
            jcodecs.make_codec(bad)
        assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="square"):
        make_codec("sympack").nbytes((3, 4), torch.float64)


@pytest.mark.parametrize("variant", ["ef21", "ef14"])
@pytest.mark.parametrize("spec", ["topk0.25+qint8", "qint8", "topk@2"])
def test_compensate_matches_reference(spec, variant):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 12))
    mem = rng.standard_normal((5, 12)) * 0.1
    jc, tc = jcodecs.make_codec(spec), make_codec(spec)
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    want = jfeedback.compensate(jc, keys, jnp.asarray(x), jnp.asarray(mem),
                                variant=variant)
    u = None if tc.deterministic else torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.uniform(k, (12,), jnp.float64))(keys)))
    got = tfeedback.compensate(tc, u, torch.from_numpy(x),
                               torch.from_numpy(mem), variant=variant)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="variant"):
        tfeedback.compensate(tc, u, torch.from_numpy(x),
                             torch.from_numpy(mem), variant="ef99")


def test_error_feedback_gates_match_reference():
    specs = [True, False, "grad", ("h_sk", "grad"), {"grad": True},
             {"default": True, "sg": False}, frozenset()]
    for spec in specs:
        for name in ("h_sk", "sg", "grad", "loss"):
            assert tfeedback.ef_requested(spec, name) == \
                jfeedback.ef_requested(spec, name), (spec, name)
        assert tfeedback.any_ef_requested(spec) == \
            jfeedback.any_ef_requested(spec)
    memory = {"g": torch.from_numpy(np.arange(12.0).reshape(3, 4))}
    assert tfeedback.residual_norms(memory)["g"] == pytest.approx(
        jfeedback.residual_norms({"g": jnp.arange(12.0).reshape(3, 4)})["g"],
        rel=1e-15)
    assert tfeedback.init_memory(memory)["g"].abs().sum() == 0


def test_codec_and_ef_resolution_match_reference():
    kw = dict(codecs={"h_sk": "sympack+qint8", "default": "topk0.1",
                      "down:w_next": "fp16"},
              downlink_codecs={"w": "bf16", "w_next": "qint8"},
              error_feedback={"default": True, "sg": False})
    jcfg, tcfg = JCommConfig(**kw), CommConfig(**kw)
    for name in ("h_sk", "sg", "grad", "loss", "down:w", "down:w_next",
                 "down:seed", "down:other"):
        assert tcfg.codec_for(name).name == jcfg.codec_for(name).name, name
        assert tcfg.ef_for(name) == jcfg.ef_for(name), name
    assert tcfg.codecs == jcfg.codecs and tcfg.has_error_feedback
    assert _DOWNLINK_KEY_STREAM == J_DOWN_STREAM


def test_sessions_default_to_the_card(monkeypatch):
    """CommSession and make_session take device="cuda" unless told
    otherwise, and raise without a card, as every entry point of the port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CommSession(CommConfig(), 2, keys=None, state0=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_session(CommConfig(), m=2, keys=None, state0=None)
    assert make_session(None, m=2, keys=None, state0=None) is not None


def test_later_slices_raise():
    # the asynchronous driver is ported (tests/test_torch_async.py);
    # server_lr without it is a configuration error, as in the reference
    assert CommConfig(async_mode=True, server_lr=0.5).async_mode
    with pytest.raises(ValueError, match="DynamicsConfig"):
        CommConfig(dynamics=object())
    with pytest.raises(ValueError, match="async_mode=True"):
        CommConfig(server_lr=0.5)
    with pytest.raises(ValueError, match="server_lr"):
        CommConfig(server_lr=0.0)
    with pytest.raises(ValueError, match="ef_variant"):
        CommConfig(ef_variant="ef99")
    # churn's restriction: the cohort is drawn among the eligible ids
    mask = make_scheduler("uniform:0.5").participants(
        key_from_ints(0), 0, 4, ChannelModel(), eligible=np.arange(2))
    assert mask.shape == (4,) and mask.any() and not mask[2:].any()
    with pytest.raises(ValueError, match="population runs need a CommConfig"):
        make_session(None, m=2, keys=None, state0=None, population=object())
    with pytest.raises(TypeError, match="CommConfig"):
        make_session(JCommConfig(), m=2, keys=None, state0=None)


# ---------------------------------------------------------------------------
# scheduler and channel
# ---------------------------------------------------------------------------

def test_scheduler_cohorts():
    chan = ChannelModel(**edge_channel_kwargs(40))
    for spec, count in (("full", 40), ("uniform:0.25", 10),
                        ("bandwidth:0.5", 20), ("uniform:0.01", 1)):
        sched = make_scheduler(spec)
        assert sched.name == spec
        masks = [sched.participants(key_from_ints(3, t), t, 40, chan)
                 for t in range(30)]
        assert all(mk.dtype == bool and mk.sum() == count for mk in masks)
        again = sched.participants(key_from_ints(3, 0), 0, 40, chan)
        np.testing.assert_array_equal(again, masks[0])  # seeded
    # bandwidth-aware sampling prefers the fast links
    picks = np.mean([make_scheduler("bandwidth:0.25").participants(
        key_from_ints(5, t), t, 40, chan) for t in range(200)], axis=0)
    assert picks[30:].mean() > 2 * picks[:10].mean()
    assert isinstance(make_scheduler("full"), FullParticipation)
    assert isinstance(make_scheduler("uniform:0.5"), UniformSampler)
    assert isinstance(make_scheduler("bandwidth:0.5"), BandwidthAware)
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_scheduler("round_robin")
    with pytest.raises(ValueError, match="bad parameter"):
        make_scheduler("uniform:half")


def test_channel_coins_and_times_match_reference():
    kw = edge_channel_kwargs(1000)
    kw["compute_s"] = 0.01
    jchan, tchan = JChannelModel(**kw), ChannelModel(**kw)
    draw = tchan.draw(key_from_ints(9), 1000)
    assert 150 < draw.straggler.sum() < 250 and 60 < draw.dropout.sum() < 140
    np.testing.assert_array_equal(
        draw.straggler, tchan.draw(key_from_ints(9), 1000).straggler)
    jdraw = JChannelDraw(straggler=draw.straggler, dropout=draw.dropout)
    rng = np.random.default_rng(0)
    up = rng.integers(0, 500, 1000).astype(np.float64)
    down = np.full(1000, 296.0)
    delivered = ~draw.dropout
    np.testing.assert_array_equal(tchan.client_times(draw, up, down),
                                  jchan.client_times(jdraw, up, down))
    assert tchan.round_time(draw, delivered, up, down) == \
        jchan.round_time(jdraw, delivered, up, down)
    nobody = np.zeros(1000, bool)
    assert tchan.round_time(draw, nobody, up, down) == \
        jchan.round_time(jdraw, nobody, up, down)
    for field in ("uplink_rates", "downlink_rates", "latencies",
                  "compute_times"):
        np.testing.assert_array_equal(getattr(tchan, field)(1000),
                                      getattr(jchan, field)(1000))


def test_channel_spec_fields():
    """Distribution specs draw per client id: pure in (spec, field, id),
    inside their support, with the stated centre."""
    chan = ChannelModel(uplink_bytes_per_s="loguniform:3e4,3e6",
                        downlink_bytes_per_s="lognormal:1e6,0.5",
                        latency_s="uniform:0.01,0.1", compute_s="const:0.2")
    up = chan.uplink_rates(4000)
    assert (up >= 3e4).all() and (up <= 3e6).all()
    np.testing.assert_array_equal(chan.uplink_rates(10), up[:10])
    assert abs(np.median(np.log10(up)) - np.log10(3e5)) < 0.05
    assert abs(np.median(chan.downlink_rates(4000)) / 1e6 - 1) < 0.1
    lat = chan.latencies(4000)
    assert (lat >= 0.01).all() and (lat < 0.1).all()
    np.testing.assert_array_equal(chan.compute_times(3), [0.2] * 3)
    assert not np.array_equal(up, ChannelModel(
        uplink_bytes_per_s="loguniform:3e4,3e6", attr_seed=1).uplink_rates(4000))
    np.testing.assert_array_equal(
        JChannelModel(compute_s="const:0.2").compute_times(3),
        chan.compute_times(3))
    with pytest.raises(ValueError, match="unknown channel distribution"):
        ChannelModel(latency_s="gamma:1,2").latencies(3)
    with pytest.raises(ValueError, match="want \\(3,\\)"):
        ChannelModel(latency_s=np.ones(4)).latencies(3)


def test_all_dropped_round_repolls_the_lowest_scheduled_client():
    cfg = CommConfig(scheduler="uniform:0.5",
                     channel=ChannelModel(dropout_prob=1.0))
    session = CommSession(cfg, 6, keys=None, state0=None, device="cpu")
    session.begin_variant(None)
    for t in range(4):
        mask, _ = session.begin_round(t)
        _, scheduled, delivered, _ = session._pending
        assert delivered.sum() == 1
        assert np.argmax(delivered) == np.argmax(scheduled)
        np.testing.assert_array_equal(mask.numpy(), delivered.astype(float))
        trace = session.end_round()
        assert trace.sim_time_s > 0 and isinstance(trace, RoundTrace)
