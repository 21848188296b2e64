"""Cohorts split over ranks: ``run_rounds(..., client_mesh=)`` and the
two population drivers of the port on 4 gloo ranks, on the CPU.

The reference puts a cohort's client axis on its mesh
(``repro.sharding.rules.shard_cohort``) and GSPMD partitions the round.
The port gives each rank its block of the cohort
(``repro_torch.sharding.rules.cohort_block``): the rank materializes and
runs its block, the transport gathers the decoded payloads before the
robust aggregator and the server sums, and every rank takes the server
step. The ranks (``_torch_dist_child.py``, job ``client_mesh``) are
started once for the file and joined with a timeout; the no-mesh runs
are made here meanwhile.

  * ``shard_cohort`` blocks against the reference's placements of
    ``shard_cohort`` on a forced 4-device mesh (one JAX subprocess),
    the replicated fallback included.
  * Every Table-I optimizer a population admits (and FLeNS without its
    guard), m 40, 3 rounds in float64, under the identity transport,
    the edge codecs with EF (10% dropout), 25% dropout with a median and
    a noise threat, and churn that pads the cohort: the iterates of the
    4 ranks are bit-equal, and within ``RTOL`` of the run with no mesh
    (bit-equal where the cohort is replicated, and in most runs: the
    rest differ in the last bits of the per-client batched products at
    2 rows against 8); bytes equal. ``PopulationAsyncSession`` on a
    straggler channel, 3 commits. FedNew raises as without a mesh.
  * FLeNS on the reference's rows with its cohorts and operators
    injected, split over the 4 ranks, against the reference's own
    ``run_rounds(..., client_mesh=)`` on its 4-device mesh (and without
    one): losses to 1e-9 relative, bytes and cohorts equal.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.sketch as jsketch
import repro.core.sketch_policy as jpolicy
from repro.comm import CommConfig as JCommConfig
from repro_torch.core import (
    DatasetPopulation,
    logistic,
    make_optimizer,
    make_problem,
    newton_solve,
    run_rounds,
)
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.sharding import rules

import _torch_dist_child as child
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(__file__).resolve().parent / "_torch_dist_child.py"
TIMEOUT_S = 150
RTOL = 1e-14
REF_ROUNDS = 4
# (mesh shape, axes, cohort width) of the placement cases
PLACEMENTS = [((4,), ("data",), 8), ((4,), ("data",), 6),
              ((2, 2), ("data", "model"), 8), ((2, 2), ("model", "data"), 6),
              ((2, 2), ("clients", "data"), 20), ((4,), ("model",), 8)]

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
    jax.config.update("jax_enable_x64", True)
    import repro.core as jcore
    from repro.comm import CommConfig
    from repro.sharding.rules import shard_cohort

    job = json.load(open(sys.argv[1]))
    d = np.load(job["data"])
    out = {}
    auto = jax.sharding.AxisType.Auto
    for i, (shape, axes, width) in enumerate(job["placements"]):
        mesh = jax.make_mesh(tuple(shape), tuple(axes),
                             axis_types=(auto,) * len(axes))
        x = jnp.zeros((width, 3))
        placed = shard_cohort(mesh, {"x": x})["x"]
        where = {s.device: s.index[0] for s in placed.addressable_shards}
        out[f"placement{i}"] = np.asarray(
            [[where[dev].start or 0,
              (where[dev].stop or width) - (where[dev].start or 0)]
             for dev in mesh.devices.flat])
    pop = jcore.DatasetPopulation(jnp.asarray(d["X"]), jnp.asarray(d["y"]),
                                  m=int(d["m"]), lam=1e-3,
                                  objective=jcore.logistic,
                                  key=jax.random.PRNGKey(2))
    mesh = jax.make_mesh((4,), ("data",), axis_types=(auto,))
    h = jcore.run_rounds(jcore.make_optimizer("flens", k=4), pop,
                         jnp.zeros(d["X"].shape[1], jnp.float64),
                         jnp.asarray(d["w_star"]), rounds=int(d["rounds"]),
                         seed=0, comm=CommConfig(scheduler="uniform:0.2",
                                                 seed=1),
                         client_mesh=mesh)
    out["loss"] = np.asarray(h.loss)
    out["bytes"] = np.asarray(h.cumulative_bytes)
    np.savez(job["out"] + "/reference.npz", **out)
""")


def _reference_inputs():
    """The reference's population, its no-mesh FLeNS run and the draws
    the port's ranks take: its rows, cohorts and operators."""
    X, y = child.client_mesh_data()
    pop = jcore.DatasetPopulation(jnp.asarray(X), jnp.asarray(y),
                                  m=child.CM_M, lam=1e-3,
                                  objective=jcore.logistic,
                                  key=jax.random.PRNGKey(2))
    w0 = jnp.zeros(child.CM_DIM, jnp.float64)
    w_star = jcore.newton_solve(pop.eval_problem(), w0)
    h = jcore.run_rounds(jcore.make_optimizer("flens", k=4), pop, w0, w_star,
                         rounds=REF_ROUNDS, seed=0,
                         comm=JCommConfig(scheduler="uniform:0.2", seed=1))
    keys = jax.random.split(jcore.root_key(0), REF_ROUNDS)
    pol = jpolicy.as_policy("srht", k=4)
    ops = [jsketch.make_sketch(pol.basis_key(keys[t], t), "srht", 4,
                               child.CM_DIM, dtype=jnp.float64)
           for t in range(REF_ROUNDS)]
    arrays = {"X": X, "y": y, "m": child.CM_M, "rounds": REF_ROUNDS,
              "rows_X": np.asarray(pop._rows_X),
              "rows_y": np.asarray(pop._rows_y), "sizes": pop.sizes,
              "n_shard": pop.n_shard, "w_star": np.asarray(w_star),
              "ids": np.stack([tr.ids for tr in h.traces]),
              "signs": np.stack([np.asarray(s.signs) for s in ops]),
              "rows": np.stack([np.asarray(s.rows) for s in ops])}
    return arrays, h


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's placements and runs, [each rank's runs], the
    no-mesh runs): the ranks and the JAX subprocess side by side with
    the no-mesh runs here."""
    d = tmp_path_factory.mktemp("client_mesh")
    arrays, ref_plain = _reference_inputs()
    np.savez(d / "data.npz", **arrays)
    job = {"kind": "client_mesh", "world": 4, "store": str(d / "store"),
           "data": str(d / "data.npz"), "out": str(d),
           "placements": PLACEMENTS, "timeout_s": TIMEOUT_S}
    (d / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    argv = lambda r: [sys.executable, str(CHILD), str(d / "job.json"), str(r)]
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE,
                               str(d / "job.json")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    ranks = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, json; from repro_torch.launch.mesh import spawn; "
         "argv = json.loads(sys.argv[1]); "
         "spawn(lambda r: argv[r], 4, timeout_s=float(sys.argv[2]))",
         json.dumps([argv(r) for r in range(4)]), str(TIMEOUT_S)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs.append(ranks)
    try:
        plain = {run["name"]: child.population_run(run, None)
                 for run in child.client_mesh_runs()}
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    want = dict(np.load(d / "reference.npz"))
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return want, got, plain, ref_plain


@pytest.mark.parametrize("case", range(len(PLACEMENTS)))
def test_shard_cohort_blocks_are_the_reference_placements(runs, case):
    want = runs[0][f"placement{case}"]
    shape, axes, width = PLACEMENTS[case]
    mesh = MeshShape(axes, shape)
    cohort = make_problem(torch.randn(width * 3, 4, dtype=torch.float64),
                          torch.ones(width * 3, dtype=torch.float64), width,
                          1e-3, logistic, device="cpu")
    for r in range(4):
        block, offset, w = rules.shard_cohort(mesh, cohort, rank=r)
        assert (offset, block.m) == tuple(want[r]), (r, offset, block.m)
        assert w == width
        assert torch.equal(block.X, cohort.X[offset:offset + block.m])
        # the server step keeps the whole cohort's weights
        assert torch.equal(block.client_weights, cohort.client_weights)


def test_a_block_materializes_only_its_ids():
    X, y = child.client_mesh_data()
    pop = DatasetPopulation(X, y, child.CM_M, 1e-3, logistic, device="cpu")
    ids = np.array([3, 17, 5, 5, 30, 2, 11, 39])
    whole = pop.materialize(ids)
    block = rules.cohort_block(MeshShape(("data",), (4,)), 8, rank=2)
    seen = []
    inner = pop.materialize
    pop.materialize = lambda i: seen.append(np.asarray(i)) or inner(i)
    part = pop.materialize_block(ids, block)
    np.testing.assert_array_equal(np.concatenate(seen), ids[4:6])
    assert torch.equal(part.X, whole.X[4:6])
    assert torch.equal(part.client_weights, whole.client_weights)
    assert part.cohort_width == 8 and part.block_span == (4, 2)


@pytest.mark.parametrize("run", child.client_mesh_runs(),
                         ids=lambda r: r["name"])
def test_split_cohort_runs_match_the_one_process_run(runs, run):
    _, got, plain, _ = runs
    name = run["name"]
    want = plain[name]
    for r in range(4):
        for key in ("w", "loss", "bytes"):
            np.testing.assert_array_equal(got[r][f"{name}/{key}"],
                                          got[0][f"{name}/{key}"])
    w = got[0][f"{name}/w"]
    assert w.shape == want["w"].shape
    np.testing.assert_array_equal(got[0][f"{name}/bytes"], want["bytes"])
    np.testing.assert_allclose(w, want["w"], rtol=0,
                               atol=RTOL * np.abs(want["w"]).max())
    np.testing.assert_allclose(got[0][f"{name}/loss"], want["loss"],
                               rtol=RTOL, atol=0)
    if run["config"] == "replicated":
        np.testing.assert_array_equal(w, want["w"])


def test_split_runs_match_the_reference_client_mesh_run(runs):
    want, got, _, ref_plain = runs
    for r in range(4):
        np.testing.assert_allclose(got[r]["reference/loss"], want["loss"],
                                   rtol=1e-9, atol=0)
        np.testing.assert_array_equal(got[r]["reference/bytes"],
                                      want["bytes"])
        np.testing.assert_array_equal(
            got[r]["reference/ids"], np.stack([t.ids for t in ref_plain.traces]))
    # the reference's mesh run is its one-device run
    np.testing.assert_allclose(want["loss"], np.asarray(ref_plain.loss),
                               rtol=1e-12, atol=0)


def test_fednew_with_a_client_mesh_raises_as_without():
    X, y = child.client_mesh_data()
    pop = DatasetPopulation(X, y, child.CM_M, 1e-3, logistic, device="cpu")
    w0 = torch.zeros(child.CM_DIM, dtype=torch.float64)
    for mesh in (None, MeshShape(("data",), (4,))):
        with pytest.raises(NotImplementedError, match="per_client_state"):
            run_rounds(make_optimizer("fednew"), pop, w0, w0, 2,
                       comm=child.client_mesh_config("identity"),
                       client_mesh=mesh)


def test_a_dense_problem_is_not_split():
    X, y = child.client_mesh_data()
    prob = make_problem(torch.from_numpy(X), torch.from_numpy(y), 8, 1e-3,
                        logistic, device="cpu")
    w0 = torch.zeros(child.CM_DIM, dtype=torch.float64)
    w_star = newton_solve(prob, w0)
    cfg = child.client_mesh_config("edge_ef")
    a = run_rounds(make_optimizer("flens_plus", k=4), prob, w0, w_star, 3,
                   comm=cfg)
    b = run_rounds(make_optimizer("flens_plus", k=4), prob, w0, w_star, 3,
                   comm=child.client_mesh_config("edge_ef"),
                   client_mesh=MeshShape(("data",), (4,)))
    np.testing.assert_array_equal(a.loss, b.loss)
