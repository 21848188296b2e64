"""repro_torch FLeNS end to end against repro, on the quickstart problem
(n=4000, dim=64, m=8, k=32, float64, 12 rounds), and on reduced problems
of covtype's shape (dim 54, padded to n = 64, k = 20) and phishing's
(dim 68, padded to n = 128, k = 17), whose sketches pad (n=2000, m=8).

JAX's threefry draws cannot be made with torch generators, so the port
gets the reference's per-round sketch draws through a test-only
``SketchPolicy`` whose ``materialize`` rebuilds round t's SRHT from
``jax.random.split(root_key(seed), rounds)[t]`` exactly as
``repro.core.sketch_policy.SketchPolicy.materialize`` does. Everything
else (problem, optimum, momentum, guard, byte plan) runs in the port.

The adaptive-k case holds the port against the reference with its
round re-traced at each k change: the reference's ``run_rounds`` wraps one
round closure in a new ``jax.jit`` per variant, and JAX's trace cache,
keyed on that closure, hands back the first variant's trace, so its
rounds keep computing at the starting k while billing the ramped one
(pinned by ``test_reference_adaptive_rounds_keep_the_first_trace``).

Loss trajectories must agree to rtol 1e-9 (float64; the packages sum in
different orders); the gap is compared while it is above 1e-10, since
near the float64 floor the guard's ``loss_next <= loss`` test can tie
and break differently. Byte axes must be exactly equal.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

import repro.core as jcore
import repro.core.flens as jflens
import repro.core.sketch_policy as jpolicy
from repro.core import sketch as jsketch
from repro.core.base import History as JHistory
from repro.core.base import root_key as jax_root_key
from repro.data import make_classification as jax_make_classification
from repro_torch import interop
from repro_torch.core import FLeNS, History, newton_solve, run_rounds
from repro_torch.core.sketch_policy import SketchPolicy
from repro_torch.kernels import ops

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

ROUNDS = 12
SEED = 0


@dataclasses.dataclass(frozen=True)
class InjectedSrht(SketchPolicy):
    """Test-only policy: round t's operator is the reference's draw."""

    jax_keys: object = dataclasses.field(default=None, compare=False)
    cursor: object = dataclasses.field(default=None, compare=False)

    def materialize(self, key, dim, dtype=torch.float32, device="cuda"):
        t = self.cursor[0]
        self.cursor[0] += 1
        s = jsketch.make_sketch(jnp.asarray(self.jax_keys[t]), self.kind,
                                self.k, dim, dtype=jnp.float64)
        return interop.sketch_from_numpy(np.asarray(s.signs),
                                         np.asarray(s.rows), self.k, dim,
                                         device=device)


def injected(spec: str) -> InjectedSrht:
    keys = np.asarray(jax.random.split(jax_root_key(SEED), ROUNDS))
    base = SketchPolicy.parse(spec)
    return InjectedSrht(**dataclasses.asdict(base), jax_keys=keys, cursor=[0])


# name -> (rows, dim, spectrum_decay, m): the quickstart, and reduced
# covtype- and phishing-shaped problems (paper Table II: M = 54, k = 20;
# M = 68, k = 17; spectrum decays of repro's twins)
PROBLEMS = {"quickstart": (4000, 64, 1.0, 8), "covtype": (2000, 54, 1.8, 8),
            "phishing": (2000, 68, 2.0, 8)}


@functools.cache
def _problem_pair(name):
    n, dim, decay, m = PROBLEMS[name]
    X, y = jax_make_classification(jax.random.PRNGKey(0), n=n, dim=dim,
                                   spectrum_decay=decay)
    jp = jcore.make_problem(X, y, m=m, lam=1e-3, objective=jcore.logistic)
    jw0 = jnp.zeros((dim,), jnp.float64)
    jw_star = jcore.newton_solve(jp, jw0)
    tp = interop.problem_from_numpy(np.asarray(jp.X), np.asarray(jp.y),
                                    np.asarray(jp.mask), jp.lam, "logistic",
                                    device="cpu")
    tw0 = torch.zeros(dim, dtype=torch.float64)
    tw_star = newton_solve(tp, tw0)
    np.testing.assert_allclose(tw_star.numpy(), np.asarray(jw_star),
                               rtol=0, atol=1e-10)
    return (jp, jw0, jw_star), (tp, tw0, tw_star)


@pytest.fixture(scope="module")
def quickstart():
    return _problem_pair("quickstart")


# case -> (problem, reference kwargs, port kwargs)
CASES = {
    "flens": ("quickstart", dict(k=32), dict(k=32, sketch="srht")),
    "flens_plus": ("quickstart", dict(k=32),
                   dict(k=32, variant="plus", sketch="srht")),
    "adaptive": ("quickstart", dict(k=4, sketch="srht:adaptive=4..16,c=0.1"),
                 dict(k=4, sketch="srht:adaptive=4..16,c=0.1")),
    "covtype_flens": ("covtype", dict(k=20), dict(k=20, sketch="srht")),
    "covtype_flens_plus": ("covtype", dict(k=20),
                           dict(k=20, variant="plus", sketch="srht")),
    "phishing_flens": ("phishing", dict(k=17), dict(k=17, sketch="srht")),
    "phishing_flens_plus": ("phishing", dict(k=17),
                            dict(k=17, variant="plus", sketch="srht")),
}


def _retrace_on_k_change(monkeypatch):
    """Make the reference's adaptive rounds compute at the ramped k."""
    orig = jflens.FLeNS.round_signature

    def round_signature(self, round_idx, state):
        k0 = self.policy.k
        sig = orig(self, round_idx, state)
        if self.policy.k != k0:
            jax.clear_caches()
        return sig

    monkeypatch.setattr(jflens.FLeNS, "round_signature", round_signature)


def _run_pair(case, monkeypatch):
    problem, jkw, tkw = CASES[case]
    (jp, jw0, jw_star), (tp, tw0, tw_star) = _problem_pair(problem)
    if case == "adaptive":
        _retrace_on_k_change(monkeypatch)
    jname = "flens_plus" if case.endswith("flens_plus") else "flens"
    jopt = jcore.make_optimizer(jname, **jkw)
    jh = jcore.run_rounds(jopt, jp, jw0, jw_star, rounds=ROUNDS, seed=SEED)
    tkw = dict(tkw, sketch=injected(tkw["sketch"]))
    topt = FLeNS(**tkw)
    th = run_rounds(topt, tp, tw0, tw_star, rounds=ROUNDS, seed=SEED)
    return jopt, jh, topt, th


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_reference(case, tmp_path, monkeypatch):
    jopt, jh, topt, th = _run_pair(case, monkeypatch)
    assert th.name == jh.name
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-9, atol=0)
    live = jh.gap > 1e-10
    assert live.sum() >= 6
    np.testing.assert_allclose(th.gap[live], jh.gap[live], rtol=1e-9)
    np.testing.assert_allclose(th.grad_norm, jh.grad_norm, rtol=1e-7)
    assert th.gap[-1] < th.gap[0]  # it optimizes
    # the byte axes: formulas and the identity-codec plan, exactly
    assert (th.uplink_floats, th.downlink_floats) == (jh.uplink_floats,
                                                      jh.downlink_floats)
    np.testing.assert_array_equal(th.cumulative_bytes, jh.cumulative_bytes)
    np.testing.assert_array_equal(th.sim_time_s, jh.sim_time_s)
    assert (th.clients, th.itemsize, th.rounds) == (jh.clients, jh.itemsize,
                                                    jh.rounds)
    assert topt.k == jopt.k
    if case == "adaptive":
        assert topt.k > 4  # the guard rejected and k ramped
        assert len(set(np.diff(th.cumulative_bytes))) > 1  # re-billed
    # the port's JSONL reads back through the reference's reader
    back = JHistory.from_jsonl(th.to_jsonl(tmp_path / "h.jsonl"))
    np.testing.assert_array_equal(back.loss, th.loss)
    np.testing.assert_array_equal(back.cumulative_bytes, th.cumulative_bytes)
    assert back.name == th.name and back.traces is None
    # and the reference's reads back through the port's
    mine = History.from_jsonl(jh.to_jsonl(tmp_path / "j.jsonl"))
    np.testing.assert_array_equal(mine.gap, jh.gap)


@pytest.mark.parametrize("variant", ["paper", "plus"])
def test_one_round_from_the_reference_state(quickstart, variant):
    """The reference's optimizer state, handed over as numpy, advances
    through one port round to the reference's next state."""
    (jp, jw0, _), (tp, _, _) = quickstart
    jopt = jflens.FLeNS(k=32, variant=variant)
    js = jopt.init(jp, jw0)
    key = jax.random.split(jax_root_key(SEED), ROUNDS)[0]
    js1 = jax.jit(lambda s, k: jopt.round(jp, s, k))(js, key)
    ts = interop.state_from_numpy({n: np.asarray(v) for n, v in js.items()},
                                  device="cpu")
    assert ts["t"] == 0 and ts["w"].dtype == torch.float64
    topt = FLeNS(k=32, variant=variant, sketch=injected("srht"))
    ts1 = topt.round(tp, ts, key=None)  # the injected policy draws keys[0]
    assert set(ts1) == set(js1) and ts1["t"] == 1
    for name in ("w", "w_prev", "loss", "scale", "beta"):
        np.testing.assert_allclose(ts1[name].numpy(), np.asarray(js1[name]),
                                   rtol=1e-10, atol=1e-14, err_msg=name)


def test_reference_adaptive_rounds_keep_the_first_trace(quickstart,
                                                       monkeypatch):
    """A fault of the reference, found by the port: after the guard ramps
    k, repro's jitted round still draws its sketch at the starting k
    (the re-jitted closure hits JAX's trace cache), while the port draws
    at the ramped k."""
    (jp, jw0, jw_star), (tp, tw0, tw_star) = quickstart
    drawn = []
    orig = jpolicy.SketchPolicy.materialize

    def materialize(self, key, dim, dtype=jnp.float32):
        s = orig(self, key, dim, dtype=dtype)
        # runs with each executed round (never in shape-only probes)
        jax.debug.callback(lambda rows: drawn.append(rows.shape[0]), s.rows)
        return s

    monkeypatch.setattr(jpolicy.SketchPolicy, "materialize", materialize)
    _, jkw, tkw = CASES["adaptive"]
    jopt = jcore.make_optimizer("flens", **jkw)
    jax.clear_caches()
    jcore.run_rounds(jopt, jp, jw0, jw_star, rounds=ROUNDS, seed=SEED)
    assert len(drawn) == ROUNDS
    assert jopt.k > drawn[0]  # the policy ramped ...
    assert set(drawn) == {drawn[0]}  # ... but every round drew at k0
    topt = FLeNS(**dict(tkw, sketch=injected(tkw["sketch"])))
    run_rounds(topt, tp, tw0, tw_star, rounds=ROUNDS, seed=SEED)
    assert topt.k == jopt.k


def test_round_goes_through_one_batched_launch_per_call_site(quickstart,
                                                             monkeypatch):
    """Per FLeNS round: 3 srht_apply + 2 srht_apply_t (paper variant),
    4 + 3 with the FLeNS+ projection, whatever the number of clients.
    The kernel wrappers are swapped for counting plain versions, the
    stand-in the card's counters are read against."""
    (_, _, _), (tp, tw0, tw_star) = quickstart
    calls = []

    def counting(op, fn):
        def run(x, *a, **kw):
            calls.append((op, tuple(x.shape)))
            return fn(x, *a, **kw)
        return run

    from repro_torch.kernels import ref
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    for op in ("srht_apply", "srht_apply_t"):
        monkeypatch.setattr(ref, op, counting(op, getattr(ref, op)))
    for variant, (n_fwd, n_t) in (("paper", (3, 2)), ("plus", (4, 3))):
        calls.clear()
        run_rounds(FLeNS(k=32, variant=variant, sketch=injected("srht")),
                   tp, tw0, tw_star, rounds=2)
        fwd = [c for c in calls if c[0] == "srht_apply"]
        assert len(fwd) == 2 * n_fwd
        assert len(calls) - len(fwd) == 2 * n_t
        # the Hessian square roots of all 8 clients go in one call
        assert ("srht_apply", (8, 500, 64)) in fwd


def test_obs_and_comm_are_not_ported_yet(quickstart):
    (_, _, _), (tp, tw0, tw_star) = quickstart
    # telemetry is ported: a TelemetryConfig runs, anything else is refused
    from repro_torch.obs import TelemetryConfig
    with pytest.raises(TypeError, match="TelemetryConfig"):
        run_rounds(FLeNS(k=8), tp, tw0, tw_star, rounds=1, obs=object())
    hist = run_rounds(FLeNS(k=8), tp, tw0, tw_star, rounds=1,
                      obs=TelemetryConfig())
    assert hist.telemetry["rounds"] == 1
    # both transport drivers are ported, and scenario dynamics take a
    # DynamicsConfig
    from repro_torch.comm import CommConfig
    hist = run_rounds(FLeNS(k=8), tp, tw0, tw_star, rounds=1,
                      comm=CommConfig(async_mode=True))
    assert hist.staleness is not None and hist.traces[0].version == 1
    with pytest.raises(ValueError, match="DynamicsConfig"):
        CommConfig(dynamics=object())
    with pytest.raises(TypeError, match="CommConfig"):
        run_rounds(FLeNS(k=8), tp, tw0, tw_star, rounds=1, comm=object())


def test_port_samplers_drive_flens_on_their_own(quickstart):
    """Without injected draws the port's own seeded sketches converge
    like the reference (not the same numbers: other random bits)."""
    (jp, jw0, jw_star), (tp, tw0, tw_star) = quickstart
    th = run_rounds(FLeNS(k=32), tp, tw0, tw_star, rounds=ROUNDS)
    again = run_rounds(FLeNS(k=32), tp, tw0, tw_star, rounds=ROUNDS)
    np.testing.assert_array_equal(th.loss, again.loss)  # seeded
    assert np.all(np.diff(th.loss) <= 0)  # the guard never accepts a rise
    assert th.gap[-1] < 1e-2 * th.gap[0]
