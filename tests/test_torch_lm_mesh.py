"""The port's dense and moe LMs served over a mesh against
``repro.models.lm`` and ``repro.serving`` under the same mesh, on the CPU.

Configs: ``tinyllama-1.1b``, ``qwen1.5-110b`` (its q/k/v biases) and
``arctic-480b`` (the moe kind, with its dense MLP beside the experts),
all ``.reduced()`` in float32 (4 heads, 2 KV heads, vocab 512), the
reference's parameters carried across by ``interop.lm_shard_from_numpy``.
The reference runs in one JAX subprocess with
``--xla_force_host_platform_device_count=4`` (its mesh's axes Auto,
which its sharding constraints need), its parameters placed by the
serving layout (``repro.launch.input_specs._serving_param_shardings``);
the port in 4 gloo ranks (``_torch_dist_child.py``, job ``lm_mesh``),
both started once for the file and joined with a timeout. Meshes:
(2 ``data``, 2 ``model``) and a 4-way ``model`` axis, whose 2 KV heads
do not divide over it (the guard keeps ``wk``/``wv`` whole while ``wq``
is split, and each rank takes the KV head its q head reads); a 1 x 1
mesh in this process. Cases:

  * a prefill at batch 4 (T 16) and at batch 1 (T 24), then 4
    teacher-forced decode steps (and arctic on (2, 2) at batch 2, T
    2304: its moe units on the expert-parallel branch): every call's logits within 1e-5 of the
    reference's max |logit|; each rank's cache shards equal to
    ``rules.local_shard`` of the reference's final caches under
    ``rules.state_spec`` (K and V within the same tolerance of their
    max, positions exactly); each rank's parameter leaves at their
    ``rules.serving_param_spec`` block's shape. The reference's moe
    ``shard_map`` takes no batch of 1 over a ``data`` axis of 2, so
    arctic's batch-1 case runs on the ``model`` mesh only;
  * the engine's token streams equal to the reference engine's under
    the same mesh (6 requests, 5 new tokens each, 4 slots);
  * a 1 x 1 mesh bit-equal to no mesh (logits, caches, engine);
  * a mesh with a ``pod`` axis (for the ``dec`` and ``dense_sb`` kinds)
    raises ``NotImplementedError``, and so does ``LM.loss`` there and for
    a kind not yet trained over a mesh (mamba2); weights that are not the
    rank's shard raise ``ValueError``;
  * a backward through a prefill's collectives on (2, 2) (tinyllama,
    its logits times a fixed g) gives each rank its serving shard's
    block of the no-mesh gradient.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy, lm_shard_from_numpy
from repro_torch.launch.mesh import MeshShape, make_mesh, process_group, spawn
from repro_torch.models.lm import LM
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import use_mesh

from _torch_dist_child import (
    KEY_SEP,
    lm_mesh_engine,
    lm_mesh_run,
)
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(__file__).resolve().parent / "_torch_dist_child.py"
ARCHS = ("tinyllama-1.1b", "qwen1.5-110b", "arctic-480b")
MESHES = {"dm": ((2, 2), ("data", "model")), "m4": ((4,), ("model",))}
# name -> (B, T); "long" is arctic's prefill past 4096 tokens on (2, 2),
# whose moe units take the expert-parallel branch with the experts' F
# gathered over data (its decode steps take the decode branch)
BATCHES = {"b4": (4, 16), "b1": (1, 24), "long": (2, 2304)}
CASES = [f"{arch}/{mesh}/{b}" for arch in ARCHS for mesh in MESHES
         for b in ("b4", "b1") if (arch, mesh, b) != ("arctic-480b", "dm", "b1")
         ] + ["arctic-480b/dm/long"]
ENGINE = {"tinyllama-1.1b/dm": ("tinyllama-1.1b", "dm"),
          "qwen1.5-110b/m4": ("qwen1.5-110b", "m4"),
          "arctic-480b/m4": ("arctic-480b", "m4")}
STEPS, CACHE_LEN = 4, 64
PROMPT_LENS, NEW_TOKENS, MAX_BATCH = (5, 17, 9, 30, 3, 12), 5, 4
TOL = 1e-5
TIMEOUT_S = 240
GRAD_CASE = ("tinyllama-1.1b", "dm")  # a prefill's backward on the mesh

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.launch.input_specs import _serving_param_shardings
    from repro.models.lm import LM
    from repro.serving import Request, ServingEngine
    from repro.sharding import rules
    from repro.sharding.ctx import use_mesh

    job = json.load(open(sys.argv[1]))
    d = np.load(job["data"])
    meshes = {name: jax.make_mesh(tuple(shape), tuple(axes),
                                  axis_types=(jax.sharding.AxisType.Auto,)
                                  * len(axes))
              for name, (shape, axes) in job["meshes"].items()}

    def params_of(arch, mesh):
        params = {}
        for p in d.files:
            if p.startswith(arch + "/"):
                node = params
                *head, last = p[len(arch) + 1:].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = jnp.asarray(d[p])
        sh = _serving_param_shardings(
            mesh, params, rules.tree_shardings(mesh, params, rules.param_spec),
            0)
        return jax.device_put(params, sh)

    def leaves_of(tree, prefix):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                yield from leaves_of(sub, f"{prefix}/{key}")
        else:
            yield prefix, tree

    out = {}
    for case in job["cases"]:
        name, arch = case["name"], case["arch"]
        mesh = meshes[case["mesh"]]
        model = LM(get_config(job.get("configs", {}).get(arch, arch))
                   .reduced(**job.get("overrides", {}).get(arch, {})))
        batch = {"inputs": jnp.asarray(d["tokens/" + name], jnp.int32)}
        for key in ("vision", "audio_frames"):
            if f"{key}/{name}" in d.files:
                batch[key] = jnp.asarray(d[f"{key}/{name}"])
        with use_mesh(mesh):
            params = params_of(arch, mesh)
            prefill = jax.jit(lambda p, b: model.prefill(
                p, b, cache_len=case["cache_len"]))
            logits, state = prefill(params, batch)
            got = [np.asarray(logits)]
            decode = jax.jit(model.decode_step)
            for step in d["steps/" + name]:
                logits, state = decode(params, state,
                                       jnp.asarray(step, jnp.int32))
                got.append(np.asarray(logits))
        out[name + "/logits"] = np.stack(got)
        for gi, g in enumerate(state["groups"]):
            for path, a in leaves_of(g, f"{name}/state/{gi}"):
                out[path] = np.asarray(a)
    for case in job["engine"]:
        mesh = meshes[case["mesh"]]
        model = LM(get_config(case["arch"]).reduced())
        with use_mesh(mesh):
            engine = ServingEngine(model, params_of(case["arch"], mesh),
                                   max_batch=job["max_batch"],
                                   cache_len=job["cache_len"])
            reqs = [Request(uid=i, prompt=list(p),
                            max_new_tokens=job["new_tokens"])
                    for i, p in enumerate(job["prompts"])]
            for r in reqs:
                engine.submit(r)
            engine.run()
        out["engine/" + case["name"]] = np.array([r.generated for r in reqs])
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
    """The reference's parameters (numpy) of the reduced config."""
    jcfg = jget_config(arch).reduced()
    return jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))


def _inputs(name):
    """(tokens (B, T), teacher-forced steps (STEPS, B, 1)) of a case."""
    arch, _, b = name.split("/")
    n, t = BATCHES[b]
    vocab = get_config(arch).reduced().vocab
    rng = np.random.default_rng(CASES.index(name))
    return (rng.integers(0, vocab, (n, t)).astype(np.int64),
            rng.integers(0, vocab, (STEPS, n, 1)).astype(np.int64))


def _grad_inputs():
    """(tokens (4, 8), g (4, vocab)) of the backward through a prefill."""
    rng = np.random.default_rng(55)
    vocab = get_config(GRAD_CASE[0]).reduced().vocab
    return (rng.integers(0, vocab, (4, 8)).astype(np.int64),
            rng.standard_normal((4, vocab)).astype(np.float32))


def _leaves_with_grad(tree):
    if isinstance(tree, dict):
        return {k: _leaves_with_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_()


def _flatten_grads(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for name, sub in tree.items():
            out.update(_flatten_grads(sub, f"{prefix}{name}{KEY_SEP}"))
        return out
    return {prefix[:-1]: tree.grad.numpy()}


def _len(name) -> int:
    return BATCHES[name.split("/")[2]][1]


def _prompts():
    rng = np.random.default_rng(99)
    vocab = get_config(ARCHS[0]).reduced().vocab
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [each rank's outputs]): the reference's
    subprocess and the port's 4 ranks, run side by side."""
    d = tmp_path_factory.mktemp("lm_mesh")
    arrays = {}
    for arch in ARCHS:
        arrays.update({f"{arch}{KEY_SEP}{p}": a
                       for p, a in _flatten(_params(arch)).items()})
    for name in CASES:
        arrays[f"tokens/{name}"], arrays[f"steps/{name}"] = _inputs(name)
    arrays["grad/tokens"], arrays["grad/g"] = _grad_inputs()
    np.savez(d / "data.npz", **arrays)
    job = {"kind": "lm_mesh", "world": 4, "store": str(d / "store"),
           "data": str(d / "data.npz"), "out": str(d),
           "meshes": MESHES, "cache_len": CACHE_LEN,
           "cases": [{"name": n, "arch": n.split("/")[0],
                      "mesh": n.split("/")[1],
                      "cache_len": max(CACHE_LEN, _len(n) + STEPS)}
                     for n in CASES],
           "engine": [{"name": n, "arch": a, "mesh": m}
                      for n, (a, m) in ENGINE.items()],
           "prompts": _prompts(), "new_tokens": NEW_TOKENS,
           "max_batch": MAX_BATCH, "grad_case": list(GRAD_CASE),
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
    return want, got


def _mesh_shape(name) -> MeshShape:
    shape, axes = MESHES[name.split("/")[1]]
    return MeshShape(axes, shape)


@pytest.mark.parametrize("name", CASES)
def test_logits_match_the_reference_under_the_mesh(runs, name):
    want, got = runs
    ref = want[f"{name}/logits"]
    top = float(np.abs(ref).max())
    for r in range(4):
        err = float(np.abs(got[r][f"{name}/logits"] - ref).max()) / top
        assert err <= TOL, (r, err)


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_its_cache_shard(runs, name):
    """Every cache leaf of every rank is ``local_shard`` of the
    reference's global leaf under ``state_spec`` (the sequence over
    ``model``, or over (``data``, ``model``) at batch 1)."""
    want, got = runs
    mesh = _mesh_shape(name)
    batch = BATCHES[name.split("/")[2]][0]
    keys = [k for k in want if k.startswith(f"{name}/state/")]
    assert keys
    for key in keys:
        leaf = torch.from_numpy(want[key])
        spec = rules.state_spec(mesh, (key.rsplit("/", 1)[1],), leaf,
                                batch=batch)
        top = float(leaf.abs().max()) or 1.0
        for r in range(4):
            mine = rules.local_shard(mesh, leaf, spec, rank=r).numpy()
            assert got[r][key].shape == mine.shape, (key, r)
            if key.endswith("/pos"):
                np.testing.assert_array_equal(got[r][key], mine)
            else:
                assert float(np.abs(got[r][key] - mine).max()) <= TOL * top


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("/b4")])
def test_each_rank_holds_its_serving_shard_of_the_weights(runs, name):
    """Each rank's leaves have their ``serving_param_spec`` block's shape:
    a (2, 2) rank holds a quarter of ``wq`` (D over data, heads over
    model), a rank of the model mesh a quarter of the heads and of the
    vocab, ``wk`` whole (2 KV heads on 4 ranks)."""
    _, got = runs
    arch = name.split("/")[0]
    mesh = _mesh_shape(name)
    flat = _flatten(_params(arch))
    for r in range(4):
        total = 0
        for path, a in flat.items():
            leaf = torch.from_numpy(np.array(a, dtype=np.float32))
            spec = rules.serving_param_spec(mesh, path.split(KEY_SEP), leaf)
            want = tuple(rules.local_shard(mesh, leaf, spec, rank=r).shape)
            assert tuple(got[r][f"{name}/params/{path}"]) == want, path
            total += int(np.prod(want))
        assert total < sum(a.size for a in flat.values())
    attn = "group0/attn/"
    sizes = dict(zip(mesh.axis_names, mesh.sizes))
    wq = got[0][f"{name}/params/{attn}wq"]
    wk = got[0][f"{name}/params/{attn}wk"]
    cfg = get_config(arch).reduced()
    assert wq[1:3].tolist() == [cfg.d_model // sizes.get("data", 1),
                                cfg.n_heads // sizes["model"]]
    assert wk[2] == (1 if sizes["model"] == 2 else cfg.n_kv_heads)


@pytest.mark.parametrize("name", list(ENGINE))
def test_engine_streams_match_the_reference_engine(runs, name):
    want, got = runs
    for r in range(4):
        np.testing.assert_array_equal(got[r][f"engine/{name}"],
                                      want[f"engine/{name}"])


def test_a_backward_through_the_mesh_collectives_gives_the_no_mesh_gradient(
        runs):
    """The gradient of sum(logits * g) of a prefill on the (2, 2) mesh
    (its collectives' transposes, the FSDP gathers reduce-scattered) with
    respect to each rank's serving shard: the shard's block of the same
    gradient without a mesh, within 1e-5 of each leaf's largest."""
    _, got = runs
    arch, mesh_name = GRAD_CASE
    cfg = get_config(arch).reduced()
    params = lm_params_from_numpy(_params(arch), cfg, device="cpu")
    flat = _leaves_with_grad(params)
    tokens, g = _grad_inputs()
    logits, _ = LM(cfg).prefill(flat, {"inputs": torch.from_numpy(tokens)})
    torch.sum(logits * torch.from_numpy(g)).backward()
    mesh = MeshShape(MESHES[mesh_name][1], MESHES[mesh_name][0])
    want = _flatten_grads(flat)
    assert want
    for r in range(4):
        for path, w in want.items():
            leaf = torch.from_numpy(w)
            spec = rules.serving_param_spec(mesh, path.split(KEY_SEP), leaf)
            mine = rules.local_shard(mesh, leaf, spec, rank=r).numpy()
            top = float(np.abs(w).max()) or 1.0
            err = float(np.abs(got[r][f"grad/{path}"] - mine).max()) / top
            assert err <= TOL, (r, path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_one_by_one_mesh_is_the_no_mesh_path_bit_for_bit(tmp_path, arch):
    cfg = get_config(arch).reduced()
    params = lm_params_from_numpy(_params(arch), cfg, device="cpu")
    model = LM(cfg)
    tokens, steps = (torch.from_numpy(a) for a in
                     _inputs(f"{arch}/m4/b4"))
    want, want_state = lm_mesh_run(model, params, tokens, steps, CACHE_LEN)
    want_streams = lm_mesh_engine(model, params, _prompts(), NEW_TOKENS,
                                  MAX_BATCH, CACHE_LEN)
    with process_group(0, 1, tmp_path / "store", timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        local = lm_shard_from_numpy(_params(arch), cfg, mesh, device="cpu")
        with use_mesh(mesh):
            got, state = lm_mesh_run(model, local, tokens, steps, CACHE_LEN)
            streams = lm_mesh_engine(model, local, _prompts(), NEW_TOKENS,
                                     MAX_BATCH, CACHE_LEN)
    assert torch.equal(got, want)
    assert state["cache_len"] == CACHE_LEN
    for g, w in zip(state["groups"], want_state["groups"]):
        for leaf in w:
            assert torch.equal(g[leaf], w[leaf]), leaf
    assert streams == want_streams


@pytest.mark.parametrize("arch", ["whisper-tiny", "gemma3-1b@rightsized"])
def test_other_kinds_raise_under_a_mesh(arch):
    """Every kind serves over a (data, model) mesh; a mesh with a ``pod``
    axis raises for each, naming its ROADMAP item."""
    cfg = get_config(arch).reduced()
    model = LM(cfg)
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    match = "ROADMAP.md queue 1, 'the pod axis over a mesh'"
    with use_mesh(mesh), pytest.raises(NotImplementedError, match=match):
        model.prefill({}, {"inputs": torch.zeros((1, 8), dtype=torch.int64)})
    with use_mesh(mesh), pytest.raises(NotImplementedError, match=match):
        model.init_decode_state(2, 16, device="cpu")


def test_training_raises_under_a_mesh():
    """Training over a mesh with a ``pod`` axis raises under ``LM.loss``
    for the dense kind and for mamba2's ``ssd``, naming its ROADMAP
    item."""
    tokens = torch.zeros((4, 8), dtype=torch.int64)
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    for arch in ("tinyllama-1.1b", "mamba2-780m"):
        with use_mesh(mesh), pytest.raises(
                NotImplementedError,
                match="ROADMAP.md queue 1, 'the pod axis over a mesh'"):
            LM(get_config(arch).reduced()).loss(
                {}, {"inputs": tokens, "labels": tokens})


def test_weights_of_another_layout_raise(tmp_path):
    """A rank's shard under a (1, 2) mesh's layout, passed on a 1 x 1
    mesh (whose shard is the whole tree), raises before any
    collective."""
    cfg = get_config("tinyllama-1.1b").reduced()
    params = lm_params_from_numpy(_params("tinyllama-1.1b"), cfg,
                                  device="cpu")
    with process_group(0, 1, tmp_path / "store", timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        lm = LM(cfg)
        half = rules.serving_shard(MeshShape(("data", "model"), (1, 2)),
                                   params, rank=0)
        with use_mesh(mesh), pytest.raises(ValueError,
                                           match="serving_param_spec"):
            lm.prefill(half, {"inputs": torch.zeros((1, 8),
                                                    dtype=torch.int64)})
