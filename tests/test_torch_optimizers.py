"""The nine Table-I baselines of repro_torch against repro, on the CPU.

FedAvg, FedProx, FedNewton, DistributedNewton, LocalNewton, FedNew,
FedNL, FedNS and FedNDES run on the quickstart problem (n=4000, dim=64,
m=8, float64) for 8 rounds in both packages, with no transport and under
one synchronous ``CommConfig`` (lossy codecs on every payload, error
feedback, a bandwidth-aware half cohort on the edge channel of
``examples/edge_clients.py``). JAX's threefry draws cannot be made with
torch generators, so the port gets the reference's:

  * FedNS/FedNDES's per-client operators through a test-only
    ``SketchPolicy`` whose ``materialize_batch`` rebuilds round t's m
    operators from ``jax.random.split(policy.basis_key(key_t, t), m)``,
    as ``repro.core.sketched.FedNS.round`` draws them;
  * FedNL's power-iteration start vectors from ``jax.random.split(key_t,
    m)`` (``FedNL.power_init`` replaced);
  * the transport's cohorts, coins and codec noise as
    ``test_torch_comm.py`` injects them.

Losses agree to rtol 1e-9 (the packages sum in different orders), the
gap to rtol 1e-9 while it is above 1e-6 and to 1e-14 absolute below
(some 100 ulps of the loss: Newton methods reach the float64 floor in a
few rounds), and the byte axes, traces, Table-I float counts and
FedNDES's k exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

import repro.core as jcore
from repro.core import sketch as jsketch
from repro.core import sketch_policy as jpolicy
from repro.core.base import root_key as jax_root_key
from repro.data import make_classification as jax_make_classification
from repro_torch import interop
from repro_torch.core import (
    ALGORITHMS,
    FedNDES,
    FedNL,
    FedNS,
    make_optimizer,
    newton_solve,
    run_rounds,
)
from repro_torch.core.sketch import BatchedDenseSketch
from repro_torch.core.sketch_policy import SketchPolicy
from repro_torch.kernels import ops

from test_torch_comm import config_pair, inject_reference_draws
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

ROUNDS = 8
SEED = 0
M = 8
DIM = 64


@functools.cache
def _jax_keys():
    return np.asarray(jax.random.split(jax_root_key(SEED), ROUNDS))


@dataclasses.dataclass(frozen=True)
class ReferenceClientBases(SketchPolicy):
    """Test-only policy: round t's m per-client operators are the
    reference's draws. Its basis key carries t."""

    def basis_key(self, key, round_idx):
        return torch.tensor([round_idx, 0], dtype=torch.int32)

    def materialize_batch(self, key, m, dim, dtype=torch.float32,
                          device="cuda"):
        t = int(key[0])
        ref = jpolicy.SketchPolicy.parse(self.spec())
        keys = jax.random.split(ref.basis_key(jnp.asarray(_jax_keys()[t]), t), m)
        drawn = [jsketch.make_sketch(kj, self.kind, self.k, dim,
                                     dtype=jnp.float64) for kj in keys]
        if self.kind == "srht":
            return interop.sketches_from_numpy(
                np.stack([np.asarray(s.signs) for s in drawn]),
                np.stack([np.asarray(s.rows) for s in drawn]), self.k, dim,
                device=device)
        mats = np.stack([np.asarray(s.mat) for s in drawn])
        return BatchedDenseSketch(self.k, dim, torch.tensor(mats, device=device),
                                  self.kind)


def reference_bases(spec: str) -> ReferenceClientBases:
    return ReferenceClientBases(**dataclasses.asdict(SketchPolicy.parse(spec)))


def inject_power_init(monkeypatch):
    """FedNL's v0 of round t: standard normals from split(key_t, m)."""
    cursor = [0]

    def power_init(self, key, m, dim, like):
        t = cursor[0]
        cursor[0] += 1
        keys = jax.random.split(jnp.asarray(_jax_keys()[t]), m)
        v = jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float64))(keys)
        return torch.tensor(np.asarray(v), device=like.device)

    monkeypatch.setattr(FedNL, "power_init", power_init)


@pytest.fixture(scope="module")
def quickstart():
    X, y = jax_make_classification(jax.random.PRNGKey(0), n=4000, dim=DIM)
    jp = jcore.make_problem(X, y, m=M, lam=1e-3, objective=jcore.logistic)
    jw0 = jnp.zeros((DIM,), jnp.float64)
    jw_star = jcore.newton_solve(jp, jw0)
    tp = interop.problem_from_numpy(np.asarray(jp.X), np.asarray(jp.y),
                                    np.asarray(jp.mask), jp.lam, "logistic",
                                    device="cpu")
    tw0 = torch.zeros(DIM, dtype=torch.float64)
    return (jp, jw0, jw_star), (tp, tw0, newton_solve(tp, tw0))


# case -> (optimizer, kwargs; "sketch" is a spec both packages parse)
CASES = {
    "fedavg": ("fedavg", dict(lr=2.0, local_steps=5)),
    "fedprox": ("fedprox", dict(lr=2.0, local_steps=5, mu_prox=0.01)),
    "fednewton": ("fednewton", {}),
    "distributed_newton": ("distributed_newton", {}),
    "local_newton": ("local_newton", {}),
    "fednew": ("fednew", {}),
    "fednl": ("fednl", {}),
    "fedns": ("fedns", dict(k=32, sketch="srht")),
    # a basis held across rounds needs k = M here to converge at mu = 1
    "fedns_fixed": ("fedns", dict(k=64, sketch="srht:fixed")),
    "fedns_rotate": ("fedns", dict(k=64, sketch="srht:rotate=3")),
    "fedns_gaussian": ("fedns", dict(k=32, sketch="gaussian")),
    "fedndes": ("fedndes", dict(sketch="srht")),
}
# a transport on every payload of every optimizer: int8 by default, the
# gradient top-k + int8, the broadcasts bf16, error feedback where eligible
CODECS = {"default": "qint8", "grad": "topk0.5+qint8", "down:w": "bf16"}


def _run_pair(quickstart, case, monkeypatch, comm: bool):
    (jp, jw0, jw_star), (tp, tw0, tw_star) = quickstart
    name, kw = CASES[case]
    jcfg = tcfg = None
    if comm:
        jcfg, tcfg = config_pair(CODECS, scheduler="bandwidth:0.5",
                                 error_feedback=True)
    jopt = jcore.make_optimizer(name, **kw)
    jh = jcore.run_rounds(jopt, jp, jw0, jw_star, rounds=ROUNDS, seed=SEED,
                          comm=jcfg)
    if comm:
        inject_reference_draws(monkeypatch, jcfg)
    inject_power_init(monkeypatch)
    tkw = dict(kw)
    if "sketch" in tkw:
        tkw["sketch"] = reference_bases(tkw["sketch"])
    topt = make_optimizer(name, **tkw)
    th = run_rounds(topt, tp, tw0, tw_star, rounds=ROUNDS, seed=SEED,
                    comm=tcfg)
    return jopt, jh, topt, th


def _assert_same_trajectory(jh, th):
    assert th.name == jh.name
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-9, atol=0)
    # the gap is the loss less loss(w*): relative agreement where it
    # stands well above the loss's own rounding (1e-6), and within 1e-14
    # (some 100 ulps of a loss near 0.1) where Newton methods drive it to
    # the float64 floor
    live = jh.gap > 1e-6
    assert live.sum() >= 2
    np.testing.assert_allclose(th.gap, jh.gap, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(th.grad_norm[live], jh.grad_norm[live],
                               rtol=1e-7)
    assert (th.uplink_floats, th.downlink_floats) == (jh.uplink_floats,
                                                      jh.downlink_floats)
    np.testing.assert_array_equal(th.cumulative_bytes, jh.cumulative_bytes)
    np.testing.assert_array_equal(th.sim_time_s, jh.sim_time_s)
    assert (th.clients, th.itemsize, th.rounds) == (jh.clients, jh.itemsize,
                                                    jh.rounds)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_reference(quickstart, case, monkeypatch):
    jopt, jh, topt, th = _run_pair(quickstart, case, monkeypatch, comm=False)
    _assert_same_trajectory(jh, th)
    assert th.gap[-1] < th.gap[0]  # it optimizes
    assert th.traces is None
    if isinstance(topt, FedNS):
        assert topt.k == jopt.k


@pytest.mark.parametrize("case", sorted(CASES))
def test_transport_trajectory_matches_reference(quickstart, case,
                                                monkeypatch):
    jopt, jh, topt, th = _run_pair(quickstart, case, monkeypatch, comm=True)
    _assert_same_trajectory(jh, th)
    assert len(th.traces) == len(jh.traces) == ROUNDS
    for mine, ref in zip(th.traces, jh.traces):
        assert mine.to_dict() == ref.to_dict()
    assert th.ef_residuals.keys() == jh.ef_residuals.keys()
    for name, norm in jh.ef_residuals.items():
        np.testing.assert_allclose(th.ef_residuals[name], norm, rtol=1e-9)
    # FedNS's sa payload takes EF only under a basis that persists
    if case.startswith("fedns"):
        assert ("sa" in th.ef_residuals) == (case in ("fedns_fixed",
                                                      "fedns_rotate"))


def test_registry_and_table_one_match_reference(quickstart):
    """All 11 names in the reference's order; every optimizer's uplink
    and downlink floats (Table I) equal the reference's, FedNDES's k too
    (it is resolved in init)."""
    (jp, jw0, _), (tp, tw0, _) = quickstart
    assert ALGORITHMS == jcore.ALGORITHMS
    for name in ALGORITHMS:
        kw = {"k": 32} if name in ("fedns", "flens", "flens_plus") else {}
        jopt, topt = jcore.make_optimizer(name, **kw), make_optimizer(name, **kw)
        jopt.init(jp, jw0)
        topt.init(tp, tw0)
        assert topt.name == jopt.name == name
        assert topt.uplink_floats(tp) == jopt.uplink_floats(jp), name
        assert topt.downlink_floats(tp) == jopt.downlink_floats(jp), name
        if name == "fedndes":
            assert topt.k == jopt.k and 8 <= topt.k <= tp.X.shape[1]
    # FedNL bills its rank-1 wire format, not the (M, M) difference
    assert make_optimizer("fednl").uplink_floats(tp) == 2 * DIM + 1


@pytest.mark.parametrize("name,kw", [("fednl", {}), ("fednew", {}),
                                     ("fedns", dict(k=32, sketch="srht:rotate=2"))])
def test_one_round_from_a_reference_mid_trajectory_state(quickstart, name, kw,
                                                         monkeypatch):
    """The reference's state after 3 rounds (FedNL's B, FedNew's d_bar
    and duals, FedNS's round counter t), handed over as numpy, advances
    through one port round to the reference's next state."""
    (jp, jw0, _), (tp, _, _) = quickstart
    jopt = jcore.make_optimizer(name, **kw)
    js = jopt.init(jp, jw0)
    keys = _jax_keys()
    step = jax.jit(lambda s, k: jopt.round(jp, s, k))
    for t in range(3):
        js = step(js, keys[t])
    js4 = step(js, keys[3])
    ts = interop.state_from_numpy({n: np.asarray(v) for n, v in js.items()},
                                  device="cpu")
    assert set(ts) == set(js)
    tkw = dict(kw)
    if "sketch" in tkw:
        tkw["sketch"] = reference_bases(tkw["sketch"])
        assert ts["t"] == 3
    topt = make_optimizer(name, **tkw)

    def power_init(self, key, m, dim, like):
        v = jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float64))(
            jax.random.split(jnp.asarray(keys[3]), m))
        return torch.tensor(np.asarray(v))

    monkeypatch.setattr(FedNL, "power_init", power_init)
    ts4 = topt.round(tp, ts, key=None)
    assert set(ts4) == set(js4)
    for n, v in js4.items():
        if n == "t":
            assert ts4[n] == int(v) == 4
            continue
        np.testing.assert_allclose(ts4[n].numpy(), np.asarray(v), rtol=1e-9,
                                   atol=1e-13, err_msg=n)


def test_fedns_sketches_all_clients_in_one_batched_call(quickstart,
                                                        monkeypatch):
    """A FedNS round makes one srht_apply call (one launch on the card)
    with the m operators, on the contiguous transpose of A (m, M,
    n_shard), and no srht_apply_t; FedNDES the same."""
    (_, _, _), (tp, tw0, tw_star) = quickstart
    calls = []
    from repro_torch.kernels import ref

    def counting(op, fn):
        def run(x, *a, **kw):
            calls.append((op, tuple(x.shape), x.is_contiguous(),
                          tuple(a[0].shape)))
            return fn(x, *a, **kw)
        return run

    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    for op in ("srht_apply", "srht_apply_t"):
        monkeypatch.setattr(ref, op, counting(op, getattr(ref, op)))
    for opt in (FedNS(k=32), FedNDES()):
        calls.clear()
        run_rounds(opt, tp, tw0, tw_star, rounds=3)
        assert calls == [("srht_apply", (M, DIM, 500), True, (M, 512))] * 3


def test_port_samplers_drive_every_optimizer_on_their_own(quickstart):
    """Without injected draws, each optimizer runs on the port's own
    seeded draws, repeats itself exactly and lowers the gap."""
    (_, _, _), (tp, tw0, tw_star) = quickstart
    for name in ("fednl", "fedns", "fedndes"):
        kw = {"k": 64} if name == "fedns" else {}
        a = run_rounds(make_optimizer(name, **kw), tp, tw0, tw_star, rounds=5)
        b = run_rounds(make_optimizer(name, **kw), tp, tw0, tw_star, rounds=5)
        np.testing.assert_array_equal(a.loss, b.loss)
        assert a.gap[-1] < 1e-2 * a.gap[0], name
    sjlt = run_rounds(FedNS(k=64, sketch="sjlt"), tp, tw0, tw_star, rounds=5)
    assert sjlt.gap[-1] < 1e-2 * sjlt.gap[0]
    with pytest.raises(ValueError, match="adaptive"):
        FedNS(k=8, sketch="srht:adaptive")
