"""The port's dense and moe LMs trained over a mesh against
``repro.models.lm`` under the same mesh, on the CPU.

The reference's ``train_4k`` layout: parameters, gradients and AdamW's
moments each leaf's block under ``rules.param_spec`` (FSDP over
``data``, heads, MLP width, experts and vocab over ``model``), the
batch's rows over ``data`` (``rules.batch_spec``). Configs:
``tinyllama-1.1b``, ``arctic-480b`` (the moe kind with its dense MLP
beside the experts) and ``kimi-k2-1t-a32b`` (a dense layer, then a moe
layer with a shared expert), all ``.reduced()`` in float32 (4 heads, 2 KV
heads, vocab 512), tinyllama and kimi with remat; the reference's
parameters (norm scales set to seeded noise) carried across by
``interop.lm_train_shard_from_numpy``. The reference runs in one JAX
subprocess with ``--xla_force_host_platform_device_count=4`` (its
mesh's axes Auto), ``jax.jit(jax.value_and_grad(model.loss,
has_aux=True))`` on parameters placed by ``rules.param_spec`` and the
batch by ``rules.batch_spec``, then ``adamw_update``; the port in 4 gloo
ranks (``_torch_dist_child.py``, job ``lm_mesh_train``), both started
once for the file and joined with a timeout. Meshes: (2 ``data``, 2
``model``) and a 4-way ``model`` axis (its 2 KV heads do not divide:
``wk`` and ``wv`` whole, each rank's q head reading one KV head, their
gradients summed over ``model``). The moe cases take the decode branch
(b t <= 4096 on a mesh with ``data``), the expert branch on ``model``
4, and the expert branch on (2, 2) at b t = 4608. One tinyllama case has
a mask whose counts differ between the data ranks.

Each rank: loss, ce and aux equal to the other ranks' and within 1e-6
(relative) of the reference's; each gradient leaf's block within 1e-5 of
the reference leaf's largest |gradient|, bit-equal across the ranks
that hold the same block; after one ``train_step`` from an AdamW state
of step 3 (moments from a seed), gnorm equal on every rank and within
1e-6 of the reference's, and the blocks of the parameters and both
moments within 1e-5 of each leaf's largest |value|. A 1 x 1 mesh gives
the no-mesh ``loss_and_grads`` and ``train_step`` bit for bit; a ``pod``
axis and the kinds not yet trained over a mesh raise, naming their
ROADMAP items. The vocab-parallel CE alone (``mesh_cross_entropy``, its
value and gradients) against ``lm_cross_entropy`` and
``chunked_cross_entropy`` at a vocab that divides over ``model`` (512)
and at one that does not (509, the table whole). The reference's cases
run in two JAX subprocesses side by side.
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
from repro.models import common as jcommon
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.interop import (adamw_state_from_numpy,
                                 lm_params_from_numpy)
from repro_torch.launch.mesh import MeshShape, make_mesh, process_group, spawn
from repro_torch.launch.train import loss_and_grads, train_step
from repro_torch.models.lm import LM
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import use_mesh
from repro_torch.tree import leaves

from _torch_dist_child import KEY_SEP
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(__file__).resolve().parent / "_torch_dist_child.py"
MODELS = ("tinyllama-1.1b", "arctic-480b", "kimi-k2-1t-a32b")
OVERRIDES = {"tinyllama-1.1b": {"remat": True},
             "kimi-k2-1t-a32b": {"remat": True}}
MESHES = {"dm": ((2, 2), ("data", "model")), "m4": ((4,), ("model",))}
# name -> (model, mesh, B, T, masked)
CASES = {
    "tiny/dm": ("tinyllama-1.1b", "dm", 4, 16, False),
    "tiny/m4": ("tinyllama-1.1b", "m4", 4, 16, False),
    "tiny/dm/mask": ("tinyllama-1.1b", "dm", 4, 16, True),
    "arctic/dm": ("arctic-480b", "dm", 4, 16, False),
    "arctic/m4": ("arctic-480b", "m4", 4, 16, False),
    "arctic/dm/long": ("arctic-480b", "dm", 2, 2304, False),
    "kimi/dm": ("kimi-k2-1t-a32b", "dm", 4, 16, False),
    "kimi/m4": ("kimi-k2-1t-a32b", "m4", 4, 16, False),
}
# name -> (mesh, vocab, chunk); B 4, T 16, D 64
CE_CASES = {f"{m}/v{v}/{'chunked' if c else 'lm'}": (m, v, c)
            for m in MESHES for v in (512, 509) for c in (0, 8)}
LR, ADAM_STEP = 1e-3, 3
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5
TIMEOUT_S = 240
# the reference's cases run in this many JAX subprocesses side by side
# (case i in part i % REFERENCE_PARTS): compiling a case's step takes
# 3-7 s, 42 s for the eight in one process
REFERENCE_PARTS = 2

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.models.lm import LM
    from repro.optim import adamw_update
    from repro.sharding import rules
    from repro.sharding.ctx import use_mesh

    job = json.load(open(sys.argv[1]))
    d = np.load(job["data"])
    meshes = {name: jax.make_mesh(tuple(shape), tuple(axes),
                                  axis_types=(jax.sharding.AxisType.Auto,)
                                  * len(axes))
              for name, (shape, axes) in job["meshes"].items()}

    def tree_of(prefix):
        out = {}
        for p in d.files:
            if p.startswith(prefix):
                node = out
                *head, last = p[len(prefix):].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = jnp.asarray(d[p])
        return out

    def place(tree, mesh, rule):
        return jax.device_put(tree, rules.tree_shardings(mesh, tree, rule))

    def leaves_of(tree, prefix):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                yield from leaves_of(sub, f"{prefix}/{key}")
        else:
            yield prefix, np.asarray(tree)

    out = {}
    part = int(sys.argv[2])
    for case in job["cases"][part::job["reference_parts"]]:
        name, model_name = case["name"], case["model"]
        mesh = meshes[case["mesh"]]
        model = LM(get_config(model_name).reduced(
            **job["overrides"].get(model_name, {})))
        batch = {key: jnp.asarray(d[f"{key}/{name}"])
                 for key in ("inputs", "labels", "mask")
                 if f"{key}/{name}" in d.files}

        def step(p, s, b):
            (loss, met), g = jax.value_and_grad(model.loss, has_aux=True)(p, b)
            p2, s2, gnorm = adamw_update(p, g, s, lr=job["lr"])
            return loss, met, g, p2, s2, gnorm

        with use_mesh(mesh):
            params = place(tree_of(model_name + "/"), mesh, rules.param_spec)
            state = {"m": place(tree_of(f"m/{model_name}/"), mesh,
                                rules.param_spec),
                     "v": place(tree_of(f"v/{model_name}/"), mesh,
                                rules.param_spec),
                     "step": jnp.asarray(job["adam_step"], jnp.int32)}
            batch = place(batch, mesh, rules.batch_spec)
            loss, met, g, p2, s2, gnorm = jax.jit(step)(params, state, batch)
        out[name + "/loss"] = np.asarray(loss)
        out[name + "/ce"] = np.asarray(met["ce"])
        out[name + "/aux"] = np.asarray(met["aux"])
        out[name + "/gnorm"] = np.asarray(gnorm)
        for key, tree in (("grads", g), ("params", p2), ("m", s2["m"]),
                          ("v", s2["v"])):
            out.update(leaves_of(tree, f"{name}/{key}"))
    np.savez(job["out"] + f"/reference{part}.npz", **out)
""")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for name, sub in tree.items():
            out.update(_flatten(sub, f"{prefix}{name}{KEY_SEP}"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _tree(flat: dict) -> dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for path, a in flat.items():
        node = out
        *head, last = path.split(KEY_SEP)
        for h in head:
            node = node.setdefault(h, {})
        node[last] = a
    return out


def _cfg(model_name):
    return get_config(model_name).reduced(**OVERRIDES.get(model_name, {}))


@functools.cache
def _params(model_name):
    """The reference's parameters (numpy) of the reduced config, its norm
    scales (zero at init) set to seeded noise."""
    jcfg = jget_config(model_name).reduced(**OVERRIDES.get(model_name, {}))
    flat = _flatten(jax.tree.map(np.asarray,
                                 JLM(jcfg).init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(MODELS.index(model_name))
    for path, a in flat.items():
        if path.endswith(KEY_SEP + "scale"):
            flat[path] = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return flat


@functools.cache
def _moments(model_name):
    """An AdamW state's moments of step ``ADAM_STEP`` (numpy), from a
    seed: m ~ 1e-3 N(0, 1), v ~ 1e-6 U(0.5, 2)."""
    rng = np.random.default_rng(10 + MODELS.index(model_name))
    m = {p: (1e-3 * rng.standard_normal(a.shape)).astype(np.float32)
         for p, a in _params(model_name).items()}
    v = {p: (1e-6 * rng.uniform(0.5, 2.0, a.shape)).astype(np.float32)
         for p, a in _params(model_name).items()}
    return m, v


def _batch(name):
    """(inputs, labels, mask or None) (B, T) of a case, numpy."""
    model_name, _, b, t, masked = CASES[name]
    vocab = _cfg(model_name).vocab
    rng = np.random.default_rng(list(CASES).index(name))
    toks = rng.integers(0, vocab, (b, t + 1)).astype(np.int32)
    mask = None
    if masked:
        # the first data rank's rows keep every position, the second's a
        # quarter of them
        mask = np.ones((b, t), np.float32)
        mask[b // 2:] = (rng.uniform(size=(b - b // 2, t)) < 0.25)
    return toks[:, :-1], toks[:, 1:], mask


def _ce_inputs(name):
    _, vocab, _ = CE_CASES[name]
    rng = np.random.default_rng(100 + list(CE_CASES).index(name))
    feats = rng.standard_normal((4, 16, 64)).astype(np.float32)
    table = (0.2 * rng.standard_normal((vocab, 64))).astype(np.float32)
    labels = rng.integers(0, vocab, (4, 16)).astype(np.int64)
    mask = (rng.uniform(size=(4, 16)) < 0.7).astype(np.float32)
    mask[2:, :12] = 0.0  # the data ranks' counts differ
    return feats, table, labels, mask


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [each rank's outputs]): the reference's
    subprocess and the port's 4 ranks, run side by side."""
    d = tmp_path_factory.mktemp("lm_mesh_train")
    arrays = {}
    for model_name in MODELS:
        arrays.update({f"{model_name}{KEY_SEP}{p}": a
                       for p, a in _params(model_name).items()})
        m, v = _moments(model_name)
        arrays.update({f"m/{model_name}/{p}": a for p, a in m.items()})
        arrays.update({f"v/{model_name}/{p}": a for p, a in v.items()})
    for name in CASES:
        inputs, labels, mask = _batch(name)
        arrays[f"inputs/{name}"], arrays[f"labels/{name}"] = inputs, labels
        if mask is not None:
            arrays[f"mask/{name}"] = mask
    for name in CE_CASES:
        (arrays[f"feats/{name}"], arrays[f"table/{name}"],
         arrays[f"labels/{name}"], arrays[f"mask/{name}"]) = _ce_inputs(name)
    np.savez(d / "data.npz", **arrays)
    job = {"kind": "lm_mesh_train", "world": 4, "store": str(d / "store"),
           "data": str(d / "data.npz"), "out": str(d), "meshes": MESHES,
           "overrides": OVERRIDES, "lr": LR, "adam_step": ADAM_STEP,
           "reference_parts": REFERENCE_PARTS,
           "cases": [{"name": n, "model": c[0], "mesh": c[1]}
                     for n, c in CASES.items()],
           "ce_cases": [{"name": n, "mesh": c[0], "chunk": c[2]}
                        for n, c in CE_CASES.items()],
           "timeout_s": TIMEOUT_S}
    (d / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    refs = [subprocess.Popen([sys.executable, "-c", _REFERENCE,
                              str(d / "job.json"), str(part)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for part in range(REFERENCE_PARTS)]
    try:
        spawn(lambda r: [sys.executable, str(CHILD), str(d / "job.json"),
                         str(r)], 4, timeout_s=TIMEOUT_S, env=env)
        logs = [ref.communicate(timeout=TIMEOUT_S)[0] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    for ref, log in zip(refs, logs):
        assert ref.returncode == 0, log[-3000:]
    want = {}
    for part in range(REFERENCE_PARTS):
        want.update(np.load(d / f"reference{part}.npz"))
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return want, got


def _mesh_shape(name) -> MeshShape:
    shape, axes = MESHES[CASES[name][1]]
    return MeshShape(axes, shape)


def _blocks(name, key, want, r):
    """(path, the rank's block of the reference's leaf, the leaf's
    largest |value|) of every leaf of ``key`` (grads, params, m, v)."""
    mesh = _mesh_shape(name)
    for path in _params(CASES[name][0]):
        ref = torch.from_numpy(want[f"{name}/{key}/{path}"])
        spec = rules.param_spec(mesh, path.split(KEY_SEP), ref)
        yield (path, rules.local_shard(mesh, ref, spec, rank=r).numpy(),
               float(ref.abs().max()))


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_the_reference_on_every_rank(runs, name):
    want, got = runs
    for key in ("loss", "ce", "aux", "step_loss", "step_ce"):
        ref = want[f"{name}/{key.removeprefix('step_')}"]
        vals = [got[r][f"{name}/{key}"] for r in range(4)]
        assert all(np.array_equal(v, vals[0]) for v in vals), (key, vals)
        np.testing.assert_allclose(vals[0], ref, rtol=LOSS_RTOL, atol=1e-12,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_blocks_match_the_reference(runs, name):
    want, got = runs
    for r in range(4):
        for path, mine, top in _blocks(name, "grads", want, r):
            g = got[r][f"{name}/grads/{path}"]
            assert g.shape == mine.shape, (r, path)
            err = float(np.abs(g - mine).max()) / max(top, 1e-30)
            assert err <= GRAD_TOL, (r, path, err)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_holding_one_block_have_bit_equal_gradients(runs, name):
    """Ranks whose coordinates differ only on axes a leaf's spec does not
    name hold the same block, and its gradient bit for bit."""
    want, got = runs
    mesh = _mesh_shape(name)
    sizes = dict(zip(mesh.axis_names, mesh.sizes))
    pairs = 0
    for path in _params(CASES[name][0]):
        spec = rules.param_spec(mesh, path.split(KEY_SEP),
                                torch.from_numpy(want[f"{name}/grads/{path}"]))
        named = {a for ax in spec if ax for a in
                 ((ax,) if isinstance(ax, str) else ax)}
        key = lambda r: tuple(c for a, c in rules.coordinate(  # noqa: E731
            mesh, r).items() if a in named)
        for r in range(1, 4):
            for q in range(r):
                if key(q) == key(r) and set(sizes) - named:
                    pairs += 1
                    assert np.array_equal(got[r][f"{name}/grads/{path}"],
                                          got[q][f"{name}/grads/{path}"]), (
                        path, q, r)
    assert pairs


@pytest.mark.parametrize("name", list(CASES))
def test_one_train_step_matches_the_reference(runs, name):
    want, got = runs
    gnorms = [got[r][f"{name}/gnorm"] for r in range(4)]
    assert all(np.array_equal(g, gnorms[0]) for g in gnorms), gnorms
    np.testing.assert_allclose(gnorms[0], want[f"{name}/gnorm"],
                               rtol=LOSS_RTOL)
    for key in ("params", "m", "v"):
        for r in range(4):
            for path, mine, top in _blocks(name, key, want, r):
                err = (float(np.abs(got[r][f"{name}/{key}/{path}"]
                                    - mine).max()) / max(top, 1e-30))
                assert err <= GRAD_TOL, (key, r, path, err)


@pytest.mark.parametrize("name", list(CE_CASES))
def test_vocab_parallel_ce_matches_the_reference(runs, name):
    """``mesh_cross_entropy`` on each rank's rows and vocab block (the
    whole table at vocab 509) against ``jax.value_and_grad`` of the
    reference's CE over the whole batch."""
    _, got = runs
    mesh_name, vocab, chunk = CE_CASES[name]
    feats, table, labels, mask = _ce_inputs(name)

    def ce(f, t):
        if chunk:
            return jcommon.chunked_cross_entropy(f, t, labels, chunk, mask)
        return jcommon.lm_cross_entropy(f, t, labels, mask)
    val, (gf, gt) = jax.jit(jax.value_and_grad(ce, argnums=(0, 1)))(
        jnp.asarray(feats), jnp.asarray(table))
    shape, axes = MESHES[mesh_name]
    mesh = MeshShape(axes, shape)
    fspec = rules.batch_spec(mesh, (), feats)
    tspec = rules.param_spec(mesh, ("embed", "table"), table)[:1]
    assert (tspec == ("model",)) == (vocab % mesh.shape["model"] == 0)
    for r in range(4):
        out = got[r]
        np.testing.assert_allclose(out[f"ce/{name}/ce"], np.asarray(val),
                                   rtol=LOSS_RTOL)
        for key, g, spec in (("feats", gf, fspec), ("table", gt, tspec)):
            mine = rules.local_shard(mesh, torch.tensor(np.asarray(g)),
                                     spec, rank=r).numpy()
            err = float(np.abs(out[f"ce/{name}/{key}"] - mine).max())
            assert err <= GRAD_TOL * float(np.abs(g).max()), (r, key, err)


@pytest.mark.parametrize("model_name", ["tinyllama-1.1b", "kimi-k2-1t-a32b"])
def test_a_one_by_one_mesh_is_the_no_mesh_step_bit_for_bit(tmp_path,
                                                          model_name):
    cfg = _cfg(model_name)
    model = LM(cfg)
    params = lm_params_from_numpy(_tree(_params(model_name)), cfg,
                                  device="cpu")
    inputs, labels, _ = _batch(
        f"{'tiny' if model_name == MODELS[0] else 'kimi'}/dm")
    batch = {"inputs": torch.from_numpy(inputs).long(),
             "labels": torch.from_numpy(labels).long()}
    m, v = (_tree(x) for x in _moments(model_name))

    def state():
        return adamw_state_from_numpy(
            {"m": m, "v": v, "step": np.array(ADAM_STEP)}, device="cpu")

    def run():
        loss, met, grads = loss_and_grads(model, params, batch)
        p2, s2, loss2, ce2, gnorm = train_step(model, params, state(), batch,
                                               LR)
        return [loss, met["ce"], met["aux"], loss2, ce2, gnorm,
                *leaves(grads), *leaves(p2), *leaves(s2["m"]),
                *leaves(s2["v"])]

    want = run()
    with process_group(0, 1, tmp_path / "store", timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(rules.training_shard(mesh, params)), leaves(params)))
        with use_mesh(mesh):
            got = run()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i


@pytest.mark.parametrize("arch,match", [
    ("tinyllama-1.1b", "the pod axis over a mesh"),
    ("mamba2-780m", "training over a mesh of the other kinds"),
    ("recurrentgemma-2b", "training over a mesh of the other kinds"),
    ("gemma3-1b@rightsized", "training over a mesh of the other kinds"),
    ("whisper-tiny", "training over a mesh of the other kinds"),
    ("llama-3.2-vision-90b", "training over a mesh of the other kinds")])
def test_what_is_not_ported_raises_under_loss(arch, match):
    cfg = get_config(arch).reduced()
    mesh = (MeshShape(("pod", "data", "model"), (2, 2, 2))
            if "pod" in match else MeshShape(("data", "model"), (2, 2)))
    tokens = torch.zeros((4, 8), dtype=torch.int64)
    with use_mesh(mesh), pytest.raises(NotImplementedError,
                                       match=f"ROADMAP.md queue 1, '{match}'"):
        LM(cfg).loss({}, {"inputs": tokens, "labels": tokens})
