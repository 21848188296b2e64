"""The port's ``moe_apply`` on a mesh against ``repro.models.moe`` on a
forced 4-device mesh, on the CPU.

Configs: ``arctic-480b`` and ``kimi-k2-1t-a32b`` ``.reduced()`` in
float32 (4 experts, top-2, d_ff 256; kimi with a shared expert), the
reference's parameters carried across by ``interop.lm_params_from_numpy``.
The reference runs in one JAX subprocess with
``--xla_force_host_platform_device_count=4`` (as
``tests/test_distributed_flens.py``; its mesh's axes Auto, which the
reference's sharding constraints need), the port in 4 gloo ranks
(``_torch_dist_child.py``), both started once for the file and joined
with a timeout. Cases:

  * (2 data, 2 model) at B 4, T 8: the decode branch (b t <= 4096);
  * the same mesh at B 2, T 2304 (b t = 4608): the expert-parallel one;
  * a 4-way ``model``-only mesh at B 2, T 8: expert-parallel, no data
    axis.

Each rank's output rows within 1e-5 of the reference's largest |out|,
aux and drop within 1e-6, the routing ids and kept assignments equal to
the reference's placement on the rank's tokens and experts (its lines
copied below). A 1 x 1 mesh equals the no-mesh path bit for bit.
"""
import functools
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

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch.mesh import MeshShape, make_mesh, process_group, spawn
from repro_torch.models import moe as tmoe
from repro_torch.sharding.ctx import use_mesh

from _torch_dist_child import KEY_SEP
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(__file__).resolve().parent / "_torch_dist_child.py"
ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
# name -> (mesh shape, axes, B, T, the branch it takes)
CASES = {"decode": ((2, 2), ("data", "model"), 4, 8, "decode"),
         "expert": ((2, 2), ("data", "model"), 2, 2304, "expert"),
         "model_only": ((4,), ("model",), 2, 8, "expert")}
OUT_TOL = 1e-5
STAT_TOL = 1e-6
TIMEOUT_S = 150

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import functools, json
    import jax
    import numpy as np
    from repro.configs import get_config
    from repro.models import moe
    from repro.sharding.ctx import use_mesh

    job = json.load(open(sys.argv[1]))
    d = np.load(job["data"])
    out = {}
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
        with use_mesh(mesh):
            o, aux, drop = jax.jit(functools.partial(moe.moe_apply, cfg=cfg))(
                params, d["x/" + name])
        out[name + "/out"] = np.asarray(o)
        out[name + "/aux"] = np.asarray(aux)
        out[name + "/drop"] = np.asarray(drop)
    np.savez(job["out"] + "/reference.npz", **out)
""")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for name, sub in tree.items():
            out.update(_flatten(sub, f"{prefix}{name}{KEY_SEP}"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@functools.cache
def _params(arch):
    """The reference's MoE parameters (numpy) of the reduced config."""
    jcfg = jget_config(arch).reduced()
    return jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(0),
                                                  jcfg))


def _x(b, t, seed):
    d = get_config(ARCHS[0]).reduced().d_model
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case/arch: (reference outputs, [each rank's outputs])}: the
    reference's subprocess and the port's 4 ranks, run side by side."""
    d = tmp_path_factory.mktemp("moe_sharded")
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
    np.savez(d / "data.npz", **arrays)
    job = {"kind": "moe", "world": 4, "store": str(d / "store"),
           "data": str(d / "data.npz"), "out": str(d), "cases": cases,
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


def _reference_placement(ids, e, n_exp, shard_idx, capacity):
    """``repro.models.moe._moe_shard_body``'s lines that place the
    assignments of one expert shard: (is_local, keep)."""
    e_loc = e // n_exp
    flat = ids.reshape(-1)
    local_e = flat - shard_idx * e_loc
    is_local = (local_e >= 0) & (local_e < e_loc)
    onehot = jax.nn.one_hot(jnp.where(is_local, local_e, e_loc), e_loc + 1,
                            dtype=jnp.int32)[:, :e_loc]
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.sum(pos_in_e * onehot, axis=1)
    return is_local, is_local & (pos < capacity)


def _capacity(cfg, tokens):
    return min(max(4, int(cfg.capacity_factor * cfg.top_k * tokens
                          / cfg.n_experts)), tokens * cfg.top_k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_moe_apply_matches_the_reference(runs, case, arch):
    want, got, arrays = runs
    shape, axes, b, t, branch = CASES[case]
    name = f"{case}-{arch}"
    jcfg = jget_config(arch).reduced()
    x = arrays[f"x/{name}"]
    ref_out = want[f"{name}/out"]
    top = float(np.abs(ref_out).max())
    sizes = dict(zip(axes, shape))
    n_data, n_exp = sizes.get("data", 1), sizes.get("model", 1)
    rows = b // n_data
    for r in range(4):
        g = got[r]
        assert str(g[f"{name}/branch"]) == branch
        coord = dict(zip(axes, g[f"{name}/coord"].tolist()))
        di, mi = coord.get("data", 0), coord.get("model", 0)
        mine = ref_out[di * rows:(di + 1) * rows]
        err = float(np.abs(g[f"{name}/out"] - mine).max()) / top
        assert err <= OUT_TOL, (r, err)
        for stat in ("aux", "drop"):
            assert abs(float(g[f"{name}/{stat}"])
                       - float(want[f"{name}/{stat}"])) <= STAT_TOL, (r, stat)
        # the routing this rank did: its tokens (all of them on the
        # decode branch, gathered over data), its experts' keeps
        tokens = (x if branch == "decode" else x[di * rows:(di + 1) * rows])
        tokens = jnp.asarray(tokens.reshape(-1, x.shape[-1]))
        ids = jmoe._route(jnp.asarray(_params(arch)["router"]), tokens,
                          jcfg)[0]
        np.testing.assert_array_equal(g[f"{name}/ids"], np.asarray(ids))
        cap = _capacity(jcfg, tokens.shape[0] if branch == "decode"
                        else rows * t)
        _, keep = _reference_placement(ids, jcfg.n_experts, n_exp, mi, cap)
        np.testing.assert_array_equal(g[f"{name}/keep"].reshape(-1),
                                      np.asarray(keep))


@pytest.mark.parametrize("case", list(CASES))
def test_the_branch_follows_the_global_batch(case):
    shape, axes, b, t, branch = CASES[case]
    assert tmoe.moe_branch(MeshShape(axes, shape), b, t) == branch


def test_local_params_are_the_reference_in_specs_blocks():
    """The decode branch's experts F-sharded over data, the expert
    branch's E over model only (rank 3 of (2 data, 2 model): data 1,
    model 1)."""
    p = {k: torch.from_numpy(np.array(v))
         for k, v in _params("arctic-480b").items()}
    mesh = MeshShape(("data", "model"), (2, 2))
    dec = tmoe.moe_local_params(mesh, p, "decode", rank=3)
    exp = tmoe.moe_local_params(mesh, p, "expert", rank=3)
    assert torch.equal(dec["w_gate"], p["w_gate"][2:, :, 128:])
    assert torch.equal(dec["w_down"], p["w_down"][2:, 128:, :])
    assert torch.equal(exp["w_up"], p["w_up"][2:])
    assert torch.equal(exp["router"], p["router"])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_one_by_one_mesh_is_the_no_mesh_path_bit_for_bit(tmp_path, arch):
    cfg = get_config(arch).reduced()
    params = lm_params_from_numpy(_params(arch), cfg, device="cpu")
    x = torch.from_numpy(_x(2, 16, 5))
    want = tmoe.moe_apply(params, x, cfg)
    with process_group(0, 1, tmp_path / "store", timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        with use_mesh(mesh):
            assert tmoe.moe_branch(mesh, 2, 16) == "one"
            got = tmoe.moe_apply(tmoe.moe_local_params(mesh, params, "one"),
                                 x, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a_mesh_needs_the_rank_shard_of_the_experts():
    """The whole expert stack on a (2, 2) mesh raises before any
    collective, naming the helper that cuts the shard."""
    cfg = get_config("arctic-480b").reduced()
    params = lm_params_from_numpy(_params("arctic-480b"), cfg, device="cpu")
    mesh = MeshShape(("data", "model"), (2, 2))
    with use_mesh(mesh), pytest.raises(ValueError, match="moe_local_params"):
        tmoe.moe_apply(params, torch.zeros(2, 8, cfg.d_model), cfg)
