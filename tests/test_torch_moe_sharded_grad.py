"""The backward of the port's ``moe_apply`` on a mesh against
``jax.grad`` of ``repro.models.moe.moe_apply`` on a forced 4-device
mesh, on the CPU.

The loss is sum(out * g) + aux for a random g, on the global output:
each port rank takes its rows of out and g. The cases are those of
``tests/test_torch_moe_sharded.py`` (the decode branch on (2 data, 2
model), the expert-parallel one there at b t = 4608, and a 4-way
``model``-only mesh) on ``arctic-480b`` and ``kimi-k2-1t-a32b``
``.reduced()`` in float32 (kimi with a shared expert). The reference
runs in one JAX subprocess (its mesh's axes Auto), the port in 4 gloo
ranks (``_torch_dist_child.py``), both started once for the file and
joined with a timeout.

Each rank's gradients of x (its rows), the router (whole), its slice of
every expert weight and the shared expert (whole) lie within 1e-5 of
the reference's largest |gradient| of that leaf. P1's own case: on a
("model",) mesh of 2 gloo ranks each rank's x gradient equals the
no-mesh backward's (the in-place collectives gave 0.71 off against a
max |dx| of 1.0). A 1 x 1 mesh's gradients are the no-mesh path's bit
for bit.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch.mesh import MeshShape, make_mesh, process_group, spawn
from repro_torch.models import moe as tmoe
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import use_mesh

from _torch_dist_child import (KEY_SEP, _grads_of, _leaves_requiring_grad,
                               flatten)
from _torch_threads import worker_threads
from test_torch_moe_sharded import ARCHS, CASES, _flatten, _params, _x

torch.set_num_threads(worker_threads())

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(__file__).resolve().parent / "_torch_dist_child.py"
GRAD_TOL = 1e-5
AUX_COEF = 1.0
TIMEOUT_S = 150
P1_ARCH = "arctic-480b"

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import functools, json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.models import moe
    from repro.sharding.ctx import use_mesh

    job = json.load(open(sys.argv[1]))
    d = np.load(job["data"])
    coef = float(job["aux_coef"])
    out = {}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, prefix + "/" + k)
        else:
            out[prefix] = np.asarray(tree)

    for case in job["cases"]:
        name, arch = case["name"], case["arch"]
        cfg = get_config(arch).reduced()
        params = {}
        for p in d.files:
            if p.startswith(arch + "/"):
                node = params
                *head, last = p[len(arch) + 1:].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = d[p]
        auto = (jax.sharding.AxisType.Auto,) * len(case["axes"])
        mesh = jax.make_mesh(tuple(case["shape"]), tuple(case["axes"]),
                             axis_types=auto)

        def loss(params, x, g):
            o, aux, _ = moe.moe_apply(params, x, cfg)
            return jnp.sum(o * g) + coef * aux

        with use_mesh(mesh):
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                params, d["x/" + name], d["g/" + name])
        flat(gp, name)
        out[name + "/x"] = np.asarray(gx)
    np.savez(job["out"] + "/reference.npz", **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's gradients, [each rank's gradients], the inputs):
    the reference's subprocess and the port's 4 ranks, side by side."""
    d = tmp_path_factory.mktemp("moe_sharded_grad")
    cases = [{"name": f"{case}-{arch}", "arch": arch, "shape": shape,
              "axes": axes}
             for case, (shape, axes, _, _, _) in CASES.items()
             for arch in ARCHS]
    arrays = {}
    for arch in ARCHS:
        arrays.update({f"{arch}{KEY_SEP}{p}": a
                       for p, a in _flatten(_params(arch)).items()})
    for i, (case, (_, _, b, t, _)) in enumerate(CASES.items()):
        for arch in ARCHS:
            arrays[f"x/{case}-{arch}"] = _x(b, t, i)
            arrays[f"g/{case}-{arch}"] = _x(b, t, 100 + i)
    arrays["x/p1"], arrays["g/p1"] = _x(2, 8, 7), _x(2, 8, 8)
    np.savez(d / "data.npz", **arrays)
    job = {"kind": "moe_grad", "world": 4, "store": str(d / "store"),
           "data": str(d / "data.npz"), "out": str(d), "cases": cases,
           "aux_coef": AUX_COEF, "p1": {"arch": P1_ARCH},
           "timeout_s": TIMEOUT_S}
    (d / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                            str(d / "job.json")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        spawn(lambda r: [sys.executable, str(CHILD), str(d / "job.json"),
                         str(r)], 4, timeout_s=TIMEOUT_S, env=env)
        log, _ = ref.communicate(timeout=TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    want = dict(np.load(d / "reference.npz"))
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return want, got, arrays


def _leaves(arch):
    return sorted(_flatten(_params(arch)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_moe_gradients_match_jax_grad(runs, case, arch):
    want, got, arrays = runs
    shape, axes, b, t, branch = CASES[case]
    name = f"{case}-{arch}"
    mesh = MeshShape(axes, shape)
    x = arrays[f"x/{name}"]
    for r in range(4):
        g = got[r]
        # x: the rank's batch rows
        mine = rules.local_shard(mesh, torch.from_numpy(want[f"{name}/x"]),
                                 rules.batch_spec(mesh, (), x), rank=r)
        top = float(np.abs(want[f"{name}/x"]).max())
        err = float(np.abs(g[f"{name}/x"] - mine.numpy()).max()) / top
        assert err <= GRAD_TOL, (r, "x", err)
        for leaf in _leaves(arch):
            path = tuple(leaf.split(KEY_SEP))
            ref = torch.from_numpy(want[f"{name}/{leaf}"])
            spec = tmoe.moe_param_spec(mesh, ("moe",) + path, ref,
                                       branch=branch)
            mine = rules.local_shard(mesh, ref, spec, rank=r).numpy()
            top = float(np.abs(ref.numpy()).max())
            err = float(np.abs(g[f"{name}/{leaf}"] - mine).max()) / top
            assert err <= GRAD_TOL, (r, leaf, err)


def test_every_leaf_has_a_gradient(runs):
    """The router, each expert weight and (kimi) the shared expert's
    three matrices each carry a nonzero gradient on every rank."""
    _, got, _ = runs
    for arch in ARCHS:
        leaves = _leaves(arch)
        assert ("shared" + KEY_SEP + "w_up" in leaves) == (arch != ARCHS[0])
        for case in CASES:
            for r in range(4):
                for leaf in leaves + ["x"]:
                    assert np.abs(got[r][f"{case}-{arch}/{leaf}"]).max() > 0


def test_p1_model_mesh_x_gradient_is_the_no_mesh_one(runs):
    """ROADMAP P1: each rank of a ("model",) mesh of 2 gloo ranks (the
    expert branch) gets the no-mesh x gradient."""
    _, got, _ = runs
    for r in range(2):
        want = got[r]["p1/none/x"]
        err = float(np.abs(got[r]["p1/mesh/x"] - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), (r, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_one_by_one_mesh_backward_is_the_no_mesh_one_bit_for_bit(
        tmp_path, arch):
    cfg = get_config(arch).reduced()
    params = lm_params_from_numpy(_params(arch), cfg, device="cpu")
    x = torch.from_numpy(_x(2, 16, 5))
    g = torch.from_numpy(_x(2, 16, 6))

    def backward(params, mesh):
        params = _leaves_requiring_grad(params)
        xi = x.clone().requires_grad_()
        with use_mesh(mesh):
            o, aux, _ = tmoe.moe_apply(params, xi, cfg)
        (torch.sum(o * g) + AUX_COEF * aux).backward()
        return {"x": xi.grad, **flatten(_grads_of(params))}

    want = backward(params, None)
    with process_group(0, 1, tmp_path / "store", timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        got = backward(tmoe.moe_local_params(mesh, params, "one"), mesh)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
