"""The port's cross-attention LMs served over a mesh against
``repro.models.lm`` under the same mesh, on the CPU.

Configs, float32: ``whisper-tiny`` ``.reduced()`` (the ``dec`` kind and
its encoder of 2 non-causal units over 32 frames: 4 q heads, 2 KV
heads), the same with 6 q and 6 KV heads (``whisper-h6``, the full
config's count: 6 does not divide a 4-way ``model`` axis, so the guard
keeps every head whole on each rank while the MLPs split) and
``llama-3.2-vision-90b`` ``.reduced()`` (one ``vlm`` super-block of 2
self layers and a cross layer over 16 vision tokens of width 64). The
reference's parameters are drawn once with JAX, their zero leaves
replaced by seeded numpy noise and the vlm's gates set to 0.7 and -0.5
(the reference starts them at 0, where the memory reaches no logit:
ROADMAP section 3, record 5), then carried across by
``interop.lm_shard_from_numpy``. The reference runs in one JAX
subprocess with 4 forced host devices (its mesh's axes Auto, the script
of ``test_torch_lm_mesh.py``), the port in 4 gloo ranks
(``_torch_dist_child.py``, job ``lm_mesh_cross``), both started once for
the file and joined with a timeout. Meshes: (2 ``data``, 2 ``model``)
and a 4-way ``model`` axis. Cases:

  * a 12-token prefill over the global batch's frames or vision tokens
    at batch 4 and at batch 1 into caches of 24 slots, then 4
    teacher-forced decode steps: every call's logits within 1e-5 of the
    reference's max |logit| (the tolerance of the other mesh files);
    each rank's self-attention caches and its cross K and V equal to
    ``rules.local_shard`` of the reference's final state under
    ``rules.state_spec`` (the caches' sequence over ``model``, the cross
    K and V whole there and by rows over ``data``; within 1e-5 of their
    max, positions exactly);
  * each rank's parameter leaves at their ``rules.serving_param_spec``
    block's shape, the encoder's and ``vision_proj``'s among them;
  * the memory reaches the logits: the vlm's prefill with the vision
    tokens zeroed moves them by more than 100 times the tolerance;
  * a 1 x 1 mesh bit-equal to no mesh (logits, states).
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

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

from _torch_dist_child import KEY_SEP, lm_mesh_run
from _torch_threads import worker_threads
from test_torch_lm_mesh import _REFERENCE, _flatten

torch.set_num_threads(worker_threads())

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(__file__).resolve().parent / "_torch_dist_child.py"
# model name -> (arch, reduced() overrides)
MODELS = {"whisper-tiny": ("whisper-tiny", {}),
          "whisper-h6": ("whisper-tiny", {"n_heads": 6, "n_kv_heads": 6}),
          "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {})}
MESHES = {"dm": ((2, 2), ("data", "model")), "m4": ((4,), ("model",))}
BATCHES = {"b4": (4, 12), "b1": (1, 12)}  # name -> (B, T)
CASES = [f"{m}/{mesh}/{b}" for m in ("whisper-tiny", "llama-3.2-vision-90b")
         for mesh in MESHES for b in BATCHES] + [
             f"whisper-h6/{mesh}/b4" for mesh in MESHES]
STEPS, CACHE_LEN = 4, 24
GATES = (0.7, -0.5)  # the vlm's gate and gate_mlp
TOL = 1e-5
TIMEOUT_S = 240


def _cfg(name):
    arch, overrides = MODELS[name]
    return get_config(arch).reduced(**overrides)


@functools.cache
def _params(name):
    """The reference's parameters (numpy) of the reduced config, zero
    leaves noised, the vlm's gates set."""
    arch, overrides = MODELS[name]
    rng = np.random.default_rng(0)

    def leaf(a):
        a = np.asarray(a)
        if not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    params = jax.tree.map(leaf, JLM(jget_config(arch).reduced(**overrides))
                          .init(jax.random.PRNGKey(0)))
    if "vision_proj" in params:
        cross = params["group0"]["cross"]
        for gate, value in zip(("gate", "gate_mlp"), GATES):
            cross[gate] = np.full_like(cross[gate], value)
    return params


def _memory_key(name) -> str:
    return "vision" if name.startswith("llama") else "audio_frames"


def _inputs(name):
    """(tokens (B, T), teacher-forced steps (STEPS, B, 1), the memory's
    inputs (B, S, width)) of a case."""
    model, _, b = name.split("/")
    n, t = BATCHES[b]
    cfg = _cfg(model)
    rng = np.random.default_rng(CASES.index(name))
    memory = ((cfg.vision_tokens, cfg.vision_dim) if cfg.family == "vlm"
              else (cfg.audio_frames, cfg.d_model))
    return (rng.integers(0, cfg.vocab, (n, t)).astype(np.int64),
            rng.integers(0, cfg.vocab, (STEPS, n, 1)).astype(np.int64),
            rng.standard_normal((n, *memory)).astype(np.float32))


def _job(d, kind: str, cases) -> dict:
    return {"kind": kind, "world": 4, "store": str(d / "store"),
            "data": str(d / "data.npz"), "out": str(d), "meshes": MESHES,
            "cache_len": CACHE_LEN,
            "configs": {n: arch for n, (arch, _) in MODELS.items()},
            "overrides": {n: ov for n, (_, ov) in MODELS.items()},
            "cases": [{"name": n, "arch": n.split("/")[0],
                       "mesh": n.split("/")[1], "cache_len": CACHE_LEN}
                      for n in cases],
            "engine": [], "timeout_s": TIMEOUT_S}


# the vlm's cases again with the vision tokens zeroed (the port alone)
BLIND = [n + "/blind" for n in CASES if n.startswith("llama")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [each rank's outputs]): the reference's
    subprocess and the port's 4 ranks, run side by side."""
    d = tmp_path_factory.mktemp("lm_mesh_cross")
    arrays = {}
    for name in MODELS:
        arrays.update({f"{name}{KEY_SEP}{p}": a
                       for p, a in _flatten(_params(name)).items()})
    for name in CASES:
        tokens, steps, memory = _inputs(name)
        key = _memory_key(name)
        arrays[f"tokens/{name}"], arrays[f"steps/{name}"] = tokens, steps
        arrays[f"{key}/{name}"] = memory
        if name + "/blind" in BLIND:
            arrays[f"tokens/{name}/blind"] = tokens
            arrays[f"steps/{name}/blind"] = steps
            arrays[f"{key}/{name}/blind"] = np.zeros_like(memory)
    np.savez(d / "data.npz", **arrays)
    (d / "job.json").write_text(json.dumps(_job(d, "lm_mesh_cross",
                                                 CASES + BLIND)))
    (d / "reference.json").write_text(json.dumps(_job(d, "lm_mesh_cross",
                                                      CASES)))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                            str(d / "reference.json")], env=env,
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


def _rel_err(a, b, top) -> float:
    return float(np.abs(a - b).max()) / top


@pytest.mark.parametrize("name", CASES)
def test_logits_match_the_reference_under_the_mesh(runs, name):
    want, got = runs
    ref = want[f"{name}/logits"]
    top = float(np.abs(ref).max())
    for r in range(4):
        assert _rel_err(got[r][f"{name}/logits"], ref, top) <= TOL, r


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_its_cache_and_cross_shards(runs, name):
    want, got = runs
    mesh = _mesh_shape(name)
    batch = BATCHES[name.split("/")[2]][0]
    prefix = f"{name}/state/0/"
    keys = [k for k in want if k.startswith(prefix)]
    assert sorted(k[len(prefix):] for k in keys) == [
        "cross_k", "cross_v", "k", "pos", "v"]
    for key in keys:
        leaf = torch.from_numpy(want[key])
        spec = rules.state_spec(mesh, (key.rsplit("/", 1)[1],), leaf,
                                batch=batch)
        top = float(leaf.abs().max()) or 1.0
        for r in range(4):
            mine = rules.local_shard(mesh, leaf, spec, rank=r).numpy()
            assert got[r][key].shape == mine.shape, (key, r)
            if key.endswith("/pos"):
                np.testing.assert_array_equal(got[r][key], mine, (key, r))
            else:
                assert _rel_err(got[r][key], mine, top) <= TOL, (key, r)
    # the cross K and V: every KV head and memory token, the rank's rows
    cfg = _cfg(name.split("/")[0])
    rows = batch // (2 if name.split("/")[1:] == ["dm", "b4"] else 1)
    assert got[0][prefix + "cross_k"].shape[-4:] == (
        rows, cfg.vision_tokens or cfg.audio_frames, cfg.n_kv_heads,
        cfg.head_dim)


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("/b4")])
def test_each_rank_holds_its_serving_shard_of_the_weights(runs, name):
    """Each rank's leaves have their ``serving_param_spec`` block's shape:
    the encoder's and the cross layers' projections by heads over
    ``model`` (whole for 6 heads on 4 ranks), ``vision_proj`` by its
    d_model over ``data``."""
    _, got = runs
    model = name.split("/")[0]
    mesh = _mesh_shape(name)
    flat = _flatten(_params(model))
    for r in range(4):
        total = 0
        for path, a in flat.items():
            leaf = torch.from_numpy(np.array(a, dtype=np.float32))
            spec = rules.serving_param_spec(mesh, path.split(KEY_SEP), leaf)
            want = tuple(rules.local_shard(mesh, leaf, spec, rank=r).shape)
            assert tuple(got[r][f"{name}/params/{path}"]) == want, path
            total += int(np.prod(want))
        assert total < sum(a.size for a in flat.values())
    cfg = _cfg(model)
    sizes = dict(zip(mesh.axis_names, mesh.sizes))
    data, m = sizes.get("data", 1), sizes["model"]
    heads = cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads
    wq = ("encoder/attn/wq" if cfg.family == "audio"
          else "group0/cross/attn/wq")
    assert got[0][f"{name}/params/{wq}"].tolist()[-3:] == [
        cfg.d_model // data, heads, cfg.head_dim]
    if cfg.family == "vlm":
        assert got[0][f"{name}/params/vision_proj"].tolist() == [
            cfg.vision_dim, cfg.d_model // data]
    if model == "whisper-h6" and m == 4:
        assert heads == 6


@pytest.mark.parametrize("name", [n[:-len("/blind")] for n in BLIND])
def test_the_vision_memory_reaches_the_logits(runs, name):
    want, got = runs
    ref = want[f"{name}/logits"]
    top = float(np.abs(ref).max())
    for r in range(4):
        assert _rel_err(got[r][f"{name}/blind/logits"], ref, top) > 100 * TOL


@pytest.mark.parametrize("name", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_a_one_by_one_mesh_is_the_no_mesh_path_bit_for_bit(tmp_path, name):
    cfg = _cfg(name)
    params = lm_params_from_numpy(_params(name), cfg, device="cpu")
    model = LM(cfg)
    case = f"{name}/m4/b4"
    tokens, steps, memory = (torch.from_numpy(a) for a in _inputs(case))
    memory = {_memory_key(case): memory}
    want, want_state = lm_mesh_run(model, params, tokens, steps, CACHE_LEN,
                                   memory)
    with process_group(0, 1, tmp_path / "store", timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        local = lm_shard_from_numpy(_params(name), cfg, mesh, device="cpu")
        with use_mesh(mesh):
            got, state = lm_mesh_run(model, local, tokens, steps, CACHE_LEN,
                                     memory)
    assert torch.equal(got, want)
    for g, w in zip(state["groups"], want_state["groups"]):
        assert set(g) == set(w)
        for leaf in w:
            assert torch.equal(g[leaf], w[leaf]), leaf
