"""The port's DistributedFLeNS (``repro_torch.core.distributed``) against
``repro.core.distributed`` and the reference's simulator FLeNS, on the
CPU over gloo.

* One rank (in this process) against the reference's 1-slice mesh, with
  the reference's operator of each round injected (torch generators
  cannot make JAX's draws; ``_torch_dist_child.InjectedPolicy``): beta 0
  and 0.5, logistic and least squares, fresh, fixed and rotating
  schedules, 3 rounds in float64, to 1e-12 relative.
* Four ranks (processes started once for the file, joined with a
  timeout) at the reference test's sizes (m 4, dim 32, k 16, 400 rows;
  ``tests/test_distributed_flens.py``) against the reference's simulator
  ``FLeNS(k, beta=0, restart=False)``, to the reference's 1e-8; a (2
  data, 2 model) mesh with client axes ("pod", "data") against the
  simulator at m 2; every rank's iterate bit-equal to the others'.
* The raises: adaptive-k policies, rows that do not divide.
"""
import functools
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.sketch_policy as jpolicy
from repro.core.distributed import DistributedFLeNS as JDistributedFLeNS
from repro.core.flens import FLeNS as JFLeNS
from repro.data import make_classification as jax_make_classification
from repro_torch.core import OBJECTIVES
from repro_torch.core.distributed import DistributedFLeNS, run_distributed
from repro_torch.launch.mesh import make_mesh, process_group, spawn

from _torch_dist_child import InjectedPolicy
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(__file__).resolve().parent / "_torch_dist_child.py"
ROUNDS = 3
TIMEOUT_S = 90


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _reference_draws(spec: str, k: int, dim: int, rounds: int):
    """The reference's operator of every round seed: (signs (R, n), rows
    (R, k)), as its DistributedFLeNS draws them."""
    pol = jpolicy.as_policy(spec, k=k)
    draws = [pol.sample(jax.random.PRNGKey(t), t, dim, dtype=jnp.float64)
             for t in range(rounds)]
    return (np.stack([np.asarray(s.signs) for s in draws]),
            np.stack([np.asarray(s.rows) for s in draws]))


# -- one rank against the reference's 1-slice mesh ----------------------------

@functools.cache
def _one_slice_data():
    X, y = jax_make_classification(jax.random.PRNGKey(1), 200, 16)
    return np.array(X, np.float64), np.array(y, np.float64)


def _reference_one_slice(objective, beta, spec):
    X, y = _one_slice_data()
    mesh = jax.make_mesh((1,), ("data",))
    flens = JDistributedFLeNS(mesh=mesh, objective=objective, dim=16, k=8,
                              lam=1e-3, beta=beta, client_axes=("data",),
                              sketch=spec)
    step = flens.round_fn()
    Xd, yd = flens.shard_data(jnp.asarray(X), jnp.asarray(y))
    w = w_prev = jnp.zeros((16,), jnp.float64)
    ws = []
    for t in range(ROUNDS):
        w, w_prev = step(Xd, yd, w, w_prev, t)
        ws.append(np.asarray(w))
    return np.stack(ws)


@pytest.mark.parametrize("spec", ["srht", "srht:fixed", "srht:rotate=2"])
@pytest.mark.parametrize("objective", ["logistic", "least_squares"])
@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_one_rank_matches_the_reference_one_slice_mesh(tmp_path, spec,
                                                       objective, beta):
    want = _reference_one_slice(getattr(jcore, objective), beta, spec)
    X, y = (torch.from_numpy(a) for a in _one_slice_data())
    signs, rows = _reference_draws(spec, 8, 16, ROUNDS)
    with process_group(0, 1, tmp_path / "store", timeout_s=TIMEOUT_S):
        mesh = make_mesh((1,), ("data",), "cpu")
        flens = DistributedFLeNS(
            mesh=mesh, objective=OBJECTIVES[objective], dim=16, k=8,
            lam=1e-3, beta=beta, client_axes=("data",),
            sketch=InjectedPolicy.of(spec, 8, signs, rows))
        _, ws = run_distributed(flens, X, y,
                                torch.zeros(16, dtype=torch.float64), ROUNDS)
    got = torch.stack(ws[1:]).numpy()
    for t in range(ROUNDS):
        assert _rel(got[t], want[t]) <= 1e-12, (t, _rel(got[t], want[t]))


def test_adaptive_k_raises(tmp_path):
    with process_group(0, 1, tmp_path / "store", timeout_s=TIMEOUT_S):
        mesh = make_mesh((1,), ("data",), "cpu")
        flens = DistributedFLeNS(mesh=mesh, objective=OBJECTIVES["logistic"],
                                 dim=16, k=8, lam=1e-3, client_axes=("data",),
                                 sketch="srht:adaptive=4..16")
        with pytest.raises(ValueError, match="adaptive-k"):
            flens.round_fn()


# -- four ranks against the reference's simulator -------------------------------

def _simulator(prob, k, rounds):
    """The reference's simulator FLeNS with beta 0, no restart, round t
    keyed by PRNGKey(t) (``tests/test_distributed_flens.py``)."""
    opt = JFLeNS(k=k, beta=0.0, restart=False)
    state = opt.init(prob, jnp.zeros((prob.dim,), jnp.float64))
    ws = [np.asarray(state["w"])]
    for t in range(rounds):
        state = opt.round(prob, state, jax.random.PRNGKey(t))
        ws.append(np.asarray(state["w"]))
    return np.stack(ws)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference's simulator runs and the port's four ranks'
    iterates (one spawn for the file)."""
    m, dim, k = 4, 32, 16
    X, y = jax_make_classification(jax.random.PRNGKey(0), 400, dim)
    probs = {mm: jcore.make_problem(X, y, m=mm, lam=1e-3,
                                    objective=jcore.logistic)
             for mm in (m, 2)}
    want = {mm: _simulator(p, k, ROUNDS) for mm, p in probs.items()}
    signs, rows = _reference_draws("srht", k, dim, ROUNDS)
    d = tmp_path_factory.mktemp("four_ranks")
    np.savez(d / "data.npz", k=k, dim=dim, rounds=ROUNDS, signs=signs,
             rows=rows,
             **{f"X_m{mm}": np.asarray(p.X, np.float64).reshape(-1, dim)
                for mm, p in probs.items()},
             **{f"y_m{mm}": np.asarray(p.y, np.float64).reshape(-1)
                for mm, p in probs.items()})
    job = {"kind": "flens", "world": 4, "store": str(d / "store"),
           "data": str(d / "data.npz"), "out": str(d),
           "timeout_s": TIMEOUT_S}
    (d / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    spawn(lambda r: [sys.executable, str(CHILD), str(d / "job.json"), str(r)],
          4, timeout_s=TIMEOUT_S, env=env)
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return want, got


def test_four_ranks_match_the_reference_simulator(four_ranks):
    want, got = four_ranks
    for r in range(4):
        for t in range(1, ROUNDS + 1):
            err = float(np.abs(got[r]["w_m4"][t] - want[4][t]).max())
            assert err < 1e-8, (r, t, err)


@pytest.mark.parametrize("case", ["w_m4", "w_m2"])
def test_every_rank_holds_the_same_iterate(four_ranks, case):
    _, got = four_ranks
    for r in range(1, 4):
        np.testing.assert_array_equal(got[r][case], got[0][case])


def test_client_axes_with_a_model_axis_match_the_simulator_at_m2(four_ranks):
    """(2 data, 2 model), client axes ("pod", "data"): two clients, the
    model axis holding copies of each client's rows."""
    want, got = four_ranks
    for r in range(4):
        for t in range(1, ROUNDS + 1):
            err = float(np.abs(got[r]["w_m2"][t] - want[2][t]).max())
            assert err < 1e-8, (r, t, err)


def test_rows_that_do_not_divide_raise(four_ranks):
    _, got = four_ranks
    for r in range(4):
        msg = str(got[r]["indivisible"])
        assert "398 rows do not divide over 4 clients" in msg, msg
