"""repro_torch convex core against repro: objectives, problems, the
reference solver, sketches and sketch policies, on the CPU.

Inputs are made with numpy from a seed (or built once by repro and
handed over as numpy) and go through both packages. Closed forms are
compared at rtol 1e-12 (float64; the two packages sum in different
orders), the Newton optimum at 1e-10.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import federated as jfed
from repro.core import losses as jlosses
from repro.core import sketch as jsketch
from repro.core import sketch_policy as jpol
from repro.data import libsvm_like as jdata
from repro_torch import interop
from repro_torch.core import base as tbase
from repro_torch.core import federated as tfed
from repro_torch.core import losses as tlosses
from repro_torch.core import make_optimizer
from repro_torch.core import sketch as tsketch
from repro_torch.core import sketch_policy as tpol
from repro_torch.data import libsvm_like as tdata

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

RTOL = 1e-12


def _glm_data(seed, n=40, dim=6, wscale=1.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, dim))
    y = rng.choice([-1.0, 1.0], n)
    w = wscale * rng.standard_normal(dim)
    v = rng.standard_normal(dim)
    return X, y, w, v


@pytest.mark.parametrize("name", ["logistic", "least_squares"])
@pytest.mark.parametrize("wscale", [1.0, 30.0])  # 30: margins far above 20
def test_objectives_match_reference(name, wscale):
    X, y, w, v = _glm_data(3, wscale=wscale)
    if name == "logistic" and wscale > 1:
        assert np.abs(y * (X @ w)).max() > 20  # the softplus trap is live
    jo, to = jlosses.OBJECTIVES[name], tlosses.OBJECTIVES[name]
    J = [jnp.asarray(a) for a in (X, y, w, v)]
    T = [torch.from_numpy(a) for a in (X, y, w, v)]
    lam = 1e-3
    for fn in ("value", "grad", "hessian", "hess_sqrt"):
        want = np.asarray(getattr(jo, fn)(*J[:3], lam))
        got = getattr(to, fn)(*T[:3], lam).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300,
                                   err_msg=fn)
    np.testing.assert_allclose(to.hvp(*T, lam).numpy(),
                               np.asarray(jo.hvp(*J, lam)), rtol=RTOL)


def test_softplus_keeps_the_tail():
    t = torch.tensor([25.0, 40.0, -800.0, 0.0], dtype=torch.float64)
    want = np.asarray(jax.nn.softplus(jnp.asarray(t.numpy())))
    np.testing.assert_array_equal(tlosses.softplus(t).numpy(), want)
    assert float(tlosses.softplus(t)[0]) != 25.0  # nn.functional would say 25


@pytest.fixture(scope="module")
def small_pair():
    """A repro problem (m=4, dim=12, with padding) and its port twin."""
    X, y = jdata.make_classification(jax.random.PRNGKey(1), n=230, dim=12)
    jp = jfed.make_problem(X, y, m=4, lam=1e-3, objective=jlosses.logistic)
    tp = interop.problem_from_numpy(np.asarray(jp.X), np.asarray(jp.y),
                                    np.asarray(jp.mask), jp.lam, "logistic",
                                    device="cpu")
    return jp, tp


@pytest.mark.parametrize("objective", ["logistic", "least_squares"])
def test_problem_quantities_match_reference(small_pair, objective):
    jp, tp = small_pair
    jp = dataclasses.replace(jp, objective=jlosses.OBJECTIVES[objective])
    tp = dataclasses.replace(tp, objective=tlosses.OBJECTIVES[objective])
    w = np.random.default_rng(5).standard_normal(12) * 3.0
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    for fn in ("local_value", "local_grad", "local_hessian",
               "local_hess_sqrt", "global_value", "global_grad",
               "global_hessian"):
        np.testing.assert_allclose(getattr(tp, fn)(tw).numpy(),
                                   np.asarray(getattr(jp, fn)(jw)),
                                   rtol=RTOL, atol=1e-15, err_msg=fn)
    np.testing.assert_allclose(tp.client_weights.numpy(),
                               np.asarray(jp.client_weights), rtol=RTOL)
    assert (tp.m, tp.dim) == (jp.m, jp.dim)


def test_newton_solve_matches_reference(small_pair):
    jp, tp = small_pair
    jw = jfed.newton_solve(jp, jnp.zeros(12))
    tw = tfed.newton_solve(tp, torch.zeros(12, dtype=torch.float64))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-10)
    assert float(torch.linalg.vector_norm(tp.global_grad(tw))) < 1e-10


def test_make_problem_label_partition_matches_reference():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((103, 5))
    y = rng.choice([-1.0, 1.0], 103)
    jp = jfed.make_problem(jnp.asarray(X), jnp.asarray(y), m=6, lam=1e-2,
                           objective=jlosses.logistic, heterogeneity="label")
    tp = tfed.make_problem(torch.from_numpy(X), torch.from_numpy(y), m=6,
                           lam=1e-2, objective=tlosses.logistic,
                           heterogeneity="label", device="cpu")
    for f in ("X", "y", "mask"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))


def test_make_problem_iid_partition_invariants():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((103, 5))
    y = rng.choice([-1.0, 1.0], 103)
    tp = tfed.make_problem(torch.from_numpy(X), torch.from_numpy(y), m=6,
                           lam=1e-2, objective=tlosses.logistic, device="cpu")
    assert tuple(tp.X.shape) == (6, 18, 5)
    assert tp.mask.sum(dim=1).tolist() == [18.0] * 5 + [13.0]
    # a permutation of the rows, padding rows zero
    rows = tp.X.reshape(-1, 5)[tp.mask.reshape(-1) > 0].numpy()
    np.testing.assert_array_equal(np.sort(rows, axis=0), np.sort(X, axis=0))
    assert not tp.X.reshape(-1, 5)[tp.mask.reshape(-1) == 0].any()
    again = tfed.make_problem(torch.from_numpy(X), torch.from_numpy(y), m=6,
                              lam=1e-2, objective=tlosses.logistic,
                              device="cpu")
    assert torch.equal(tp.X, again.X)  # seeded
    # the Dirichlet split is ported (tests/test_torch_population.py);
    # an unknown partition names the three it knows
    with pytest.raises(ValueError, match="dirichlet"):
        tfed.make_problem(torch.from_numpy(X), torch.from_numpy(y), m=6,
                          lam=1e-2, objective=tlosses.logistic,
                          heterogeneity="pathological", device="cpu")


def test_make_classification_statistics_and_seed():
    X, y = tdata.make_classification(0, n=2000, dim=8, device="cpu")
    X2, _ = tdata.make_classification(0, n=2000, dim=8, device="cpu")
    assert torch.equal(X, X2)
    assert X.dtype == torch.float64 and set(y.unique().tolist()) == {-1.0, 1.0}
    var = X.var(dim=0).numpy()
    np.testing.assert_allclose(var, np.arange(1, 9) ** -1.0, rtol=0.15)
    spec, Xs, _ = tdata.load("phishing", device="cpu")
    assert tuple(Xs.shape) == (spec.n, spec.dim)
    for name, spec in jdata.PAPER_DATASETS.items():
        assert dataclasses.asdict(tdata.PAPER_DATASETS[name]) == \
            dataclasses.asdict(spec)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults run there")
    with pytest.raises(RuntimeError, match="cuda"):
        tdata.make_classification(0, n=10, dim=4)
    with pytest.raises(RuntimeError, match="cuda"):
        tbase.root_key(0)
    with pytest.raises(RuntimeError, match="cuda"):
        tfed.make_problem(torch.zeros(8, 2), torch.ones(8), m=2, lam=1.0,
                          objective=tlosses.logistic)
    with pytest.raises(RuntimeError, match="cuda"):
        tsketch.make_sketch(tbase.key_from_ints(0), "srht", 4, 8)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def test_keys_are_deterministic_and_eight_bytes():
    keys = tbase.split(tbase.root_key(3, device="cpu"), 5)
    again = tbase.split(tbase.root_key(3, device="cpu"), 5)
    assert keys.dtype == torch.int32 and tuple(keys.shape) == (5, 2)
    assert keys[0].numel() * keys.element_size() == 8  # a JAX uint32[2]
    assert torch.equal(keys, again)
    assert len({tuple(k.tolist()) for k in keys}) == 5
    assert not torch.equal(tbase.split(tbase.root_key(3, 1, device="cpu"), 5),
                           keys)
    a, b = tbase.key_from_ints(4, 1), tbase.key_from_ints(4, 2)
    assert torch.equal(a, tbase.key_from_ints(4, 1)) and not torch.equal(a, b)


# ---------------------------------------------------------------------------
# sketches
# ---------------------------------------------------------------------------

def _jax_srht(seed, k, dim):
    return jsketch.make_sketch(jax.random.PRNGKey(seed), "srht", k, dim,
                               dtype=jnp.float64)


@pytest.mark.parametrize("k,dim", [(8, 16), (10, 18), (32, 64)])
def test_srht_from_reference_draws_matches(k, dim):
    js = _jax_srht(k, k, dim)
    ts = interop.sketch_from_numpy(np.asarray(js.signs), np.asarray(js.rows),
                                   k, dim, device="cpu")
    x = np.random.default_rng(k).standard_normal((3, dim))
    np.testing.assert_array_equal(ts.apply(torch.from_numpy(x)).numpy(),
                                  np.asarray(js.apply(jnp.asarray(x))))
    np.testing.assert_array_equal(ts.dense().numpy(), np.asarray(js.dense()))
    h = np.random.default_rng(1).standard_normal((dim, dim))
    h = h @ h.T
    np.testing.assert_allclose(
        tsketch.sketch_psd(ts, torch.from_numpy(h)).numpy(),
        np.asarray(jsketch.sketch_psd(js, jnp.asarray(h))), rtol=RTOL)
    np.testing.assert_allclose(
        float(tsketch.effective_dimension(torch.from_numpy(h), 0.5)),
        float(jsketch.effective_dimension(jnp.asarray(h), 0.5)), rtol=RTOL)


def test_sketch_from_numpy_rejects_bad_draws():
    with pytest.raises(ValueError, match="distinct"):
        interop.sketch_from_numpy(np.ones(8), np.array([1, 1]), 2, 8,
                                  device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        interop.sketch_from_numpy(np.ones(6), np.array([1, 2]), 2, 6,
                                  device="cpu")


@pytest.mark.parametrize("k,dim", [(4, 16), (16, 64), (7, 32)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_port_srht_sampler_rows_orthogonal(k, dim, dtype):
    """For dim = n a power of two, S S^T = (dim/k) I: exactly in float64
    up to the rounding of the sqrt(n/k) and 1/sqrt(n) scales."""
    s = tsketch.make_sketch(tbase.key_from_ints(k, dim), "srht", k, dim,
                            dtype=dtype, device="cpu")
    assert len(set(s.rows.tolist())) == k and s.rows.dtype == torch.int64
    assert set(s.signs.tolist()) <= {-1.0, 1.0}
    mat = s.dense().double()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose((mat @ mat.T).numpy(), (dim / k) * np.eye(k),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["gaussian", "sjlt"])
def test_port_dense_samplers(kind):
    key = tbase.key_from_ints(7)
    s = tsketch.make_sketch(key, kind, 6, 20, dtype=torch.float64,
                            device="cpu")
    assert tuple(s.mat.shape) == (6, 20) and s.kind == kind
    again = tsketch.make_sketch(key, kind, 6, 20, dtype=torch.float64,
                                device="cpu")
    assert torch.equal(s.mat, again.mat)
    x = torch.randn(3, 20, dtype=torch.float64)
    np.testing.assert_allclose(s.apply(x).numpy(), (x @ s.dense().T).numpy(),
                               rtol=RTOL)
    if kind == "sjlt":  # every column carries min(4, k) entries of 1/2
        assert ((s.mat != 0).sum(dim=0) <= 4).all()


# ---------------------------------------------------------------------------
# sketch policies
# ---------------------------------------------------------------------------

SPECS = ["srht", "srht:fixed", "srht:rotate=8", "gaussian:adaptive",
         "sjlt:rotate=4,seed=3", "srht:adaptive=8..64", "srht:adaptive,c=1.5",
         "srht:k=12"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_round_trips_like_reference(spec):
    tp, jp = tpol.SketchPolicy.parse(spec), jpol.SketchPolicy.parse(spec)
    assert tp.spec() == jp.spec()
    assert tpol.SketchPolicy.parse(tp.spec()) == tp
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for t in range(10):
        assert tp.basis_persistent(t) == jp.basis_persistent(t)
        assert tp.epoch(t) == int(jp.epoch(t))
        jr, tr = jp.ef_reset(t), tp.ef_reset(t)
        assert (jr is None) == (tr is None) and (jr is None or bool(jr) == tr)
    assert tp.basis_persistent() == jp.basis_persistent()


@pytest.mark.parametrize("bad", ["zstd", "srht:rotate", "srht:rotate=0",
                                 "srht:warp=2", "srht:adaptive=8",
                                 "srht:adaptive=64..8"])
def test_bad_specs_raise_like_reference(bad):
    with pytest.raises(ValueError):
        jpol.SketchPolicy.parse(bad)
    with pytest.raises(ValueError):
        tpol.SketchPolicy.parse(bad)


def test_adaptive_resolution_and_ramp_match_reference(small_pair):
    jp, tp = small_pair
    w = np.zeros(12)
    d_j = jpol.loss_effective_dimension(jp, jnp.asarray(w))
    d_t = tpol.loss_effective_dimension(tp, torch.from_numpy(w))
    np.testing.assert_allclose(d_t, d_j, rtol=RTOL)
    for spec in ("srht:adaptive=2..8,c=0.5", "srht:adaptive", "srht:k=3"):
        j = jpol.as_policy(spec, k=2).resolved(d_j, cap=12)
        t = tpol.as_policy(spec, k=2).resolved(d_t, cap=12)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for _ in range(4):
            j, t = j.ramped(), t.ramped()
            assert t.k == j.k


def test_fixed_and_rotating_bases_persist_within_an_epoch():
    pol = tpol.SketchPolicy.parse("srht:rotate=3,seed=5").with_k(4)
    keys = tbase.split(tbase.root_key(0, device="cpu"), 6)
    bases = [pol.basis_key(keys[t], t) for t in range(6)]
    assert torch.equal(bases[0], bases[2]) and not torch.equal(bases[2], bases[3])
    s0 = pol.sample(keys[0], 0, 16, device="cpu")
    s1 = pol.sample(keys[1], 1, 16, device="cpu")
    assert torch.equal(s0.rows, s1.rows) and torch.equal(s0.signs, s1.signs)
    fresh = tpol.SketchPolicy.parse("srht").with_k(4)
    assert torch.equal(fresh.basis_key(keys[2], 2), keys[2])
    with pytest.raises(ValueError, match="no k bound"):
        tpol.SketchPolicy.parse("srht").materialize(keys[0], 16, device="cpu")


def test_make_optimizer_names_what_is_ported():
    assert make_optimizer("flens", k=4).name == "flens"
    assert make_optimizer("flens_plus", k=4).name == "flens_plus"
    assert make_optimizer("fedavg").name == "fedavg"
    with pytest.raises(KeyError, match="newton_cg"):
        make_optimizer("newton_cg")
    with pytest.raises(ValueError, match="adaptive"):
        make_optimizer("flens", k=4, sketch="srht:adaptive", restart=False)
