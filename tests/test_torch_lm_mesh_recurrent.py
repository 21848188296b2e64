"""The port's recurrent LMs served over a mesh against ``repro.models.lm``
under the same mesh, on the CPU.

Configs: ``mamba2-780m`` ``.reduced()`` (the ``ssd`` kind: 16 SSD heads
of 32, state 32, ``w_in`` 1104 columns), the same with SSD head dim 256
(2 heads, the guard's fallback on 4 ranks: heads and ``w_in`` whole,
``w_out``'s rows split) and ``recurrentgemma-2b``
``.reduced(n_layers=4)`` (one ``griffin`` super-block and a ``rec``
remainder: 4 q heads, 1 KV head, window 32), in float32, the
reference's parameters carried across by ``interop.lm_shard_from_numpy``.
The reference runs in one JAX subprocess with 4 forced host devices (its
mesh's axes Auto), the parameters placed by the serving layout (the
script of ``test_torch_lm_mesh.py``); the port in 4 gloo ranks
(``_torch_dist_child.py``, job ``lm_mesh_recurrent``), both started once
for the file and joined with a timeout. Meshes: (2 ``data``, 2
``model``) and a 4-way ``model`` axis (4 SSD heads or 64 RG-LRU channels
a rank); a 1 x 1 mesh in this process. Cases:

  * a prefill at batch 4 (T 64: two SSD chunks, twice griffin's window)
    and at batch 1 (T 24; the head-dim-256 model at batch 4 on the
    ``model`` mesh only), then 4 teacher-forced decode steps: every
    call's logits within 1e-5 of the reference's max |logit|; each
    rank's ``ssm``, ``conv``, ``h*``, K and V shards within 1e-5 of the
    max of ``rules.local_shard`` of the reference's final state under
    ``rules.state_spec`` (positions exactly); each rank's parameter
    leaves at their ``rules.serving_param_spec`` block's shape;
  * griffin's decode past its window over the cache's sequence shards:
    the batch-4 steps sit at positions 64-67 of a 68-slot cache whose
    slots are split over ``model``, the mask taken from each slot's
    global position; lifting the window from the decode steps moves
    the logits by more than 100 times the tolerance;
  * the engine's token streams on the mesh equal to the port's engine
    without a mesh (the reference's engine pads a recurrent prompt into
    its state: ROADMAP section 3, record 3);
  * a 1 x 1 mesh bit-equal to no mesh (logits, states, engine).
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

from _torch_dist_child import KEY_SEP, lm_mesh_engine, lm_mesh_run
from _torch_threads import worker_threads
from test_torch_lm_mesh import _REFERENCE, _flatten

torch.set_num_threads(worker_threads())

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(__file__).resolve().parent / "_torch_dist_child.py"
# model name -> (arch, reduced() overrides). "mamba2-p256" has SSD head
# dim 256: its 2 heads do not divide over a 4-way model axis, so the
# guard keeps them (and w_in's 1090 columns) whole on every rank while
# w_out's 512 rows split
MODELS = {"mamba2-780m": ("mamba2-780m", {}),
          "recurrentgemma-2b": ("recurrentgemma-2b", {"n_layers": 4}),
          "mamba2-p256": ("mamba2-780m", {"ssm_head_dim": 256})}
ARCHS = ("mamba2-780m", "recurrentgemma-2b")
MESHES = {"dm": ((2, 2), ("data", "model")), "m4": ((4,), ("model",))}
BATCHES = {"b4": (4, 64), "b1": (1, 24)}  # name -> (B, T)
CASES = [f"{arch}/{mesh}/{b}" for arch in ARCHS for mesh in MESHES
         for b in BATCHES] + ["mamba2-p256/m4/b4"]
WINDOWED = [f"recurrentgemma-2b/{mesh}/b4" for mesh in MESHES]
ENGINE = [f"{arch}/{mesh}" for arch in ARCHS for mesh in MESHES]
STEPS, CACHE_LEN = 4, 64
# 40 and 33: an ssd prefix of one 32-token chunk, the rest decoded
PROMPT_LENS, NEW_TOKENS, MAX_BATCH = (5, 17, 40, 9, 33, 12), 5, 4
TOL = 1e-5
TIMEOUT_S = 240


def _cfg(name):
    arch, overrides = MODELS[name]
    return get_config(arch).reduced(**overrides)


@functools.cache
def _params(name):
    """The reference's parameters (numpy) of the reduced config."""
    arch, overrides = MODELS[name]
    jcfg = jget_config(arch).reduced(**overrides)
    return jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))


def _inputs(name):
    """(tokens (B, T), teacher-forced steps (STEPS, B, 1)) of a case."""
    arch, _, b = name.split("/")
    n, t = BATCHES[b]
    rng = np.random.default_rng(CASES.index(name))
    vocab = _cfg(arch).vocab
    return (rng.integers(0, vocab, (n, t)).astype(np.int64),
            rng.integers(0, vocab, (STEPS, n, 1)).astype(np.int64))


def _cache_len(name) -> int:
    return max(CACHE_LEN, BATCHES[name.split("/")[2]][1] + STEPS)


def _prompts():
    rng = np.random.default_rng(98)
    return [rng.integers(0, 512, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [each rank's outputs]): the reference's
    subprocess and the port's 4 ranks, run side by side."""
    d = tmp_path_factory.mktemp("lm_mesh_recurrent")
    arrays = {}
    for name in MODELS:
        arrays.update({f"{name}{KEY_SEP}{p}": a
                       for p, a in _flatten(_params(name)).items()})
    for name in CASES:
        arrays[f"tokens/{name}"], arrays[f"steps/{name}"] = _inputs(name)
    np.savez(d / "data.npz", **arrays)
    job = {"kind": "lm_mesh_recurrent", "world": 4, "store": str(d / "store"),
           "data": str(d / "data.npz"), "out": str(d),
           "meshes": MESHES, "cache_len": CACHE_LEN,
           "configs": {n: arch for n, (arch, _) in MODELS.items()},
           "overrides": {n: ov for n, (_, ov) in MODELS.items()},
           "cases": [{"name": n, "arch": n.split("/")[0],
                      "mesh": n.split("/")[1], "cache_len": _cache_len(n)}
                     for n in CASES],
           "window_off": WINDOWED,
           "engine": [{"name": n, "arch": n.split("/")[0],
                       "mesh": n.split("/")[1]} for n in ENGINE],
           "prompts": _prompts(), "new_tokens": NEW_TOKENS,
           "max_batch": MAX_BATCH, "timeout_s": TIMEOUT_S}
    (d / "job.json").write_text(json.dumps(job))
    # the reference's engine is not run: it pads a recurrent prompt
    (d / "reference.json").write_text(json.dumps(dict(job, engine=[])))
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
        err = _rel_err(got[r][f"{name}/logits"], ref, top)
        assert err <= TOL, (r, err)


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_its_state_shard(runs, name):
    """Every state leaf of every rank is ``local_shard`` of the
    reference's global leaf under ``state_spec``: ``ssm`` by its heads
    over ``model``, ``conv*`` and ``h*`` whole there, griffin's cache by
    its sequence; rows over ``data`` at batch 4."""
    want, got = runs
    mesh = _mesh_shape(name)
    batch = BATCHES[name.split("/")[2]][0]
    keys = [k for k in want if k.startswith(f"{name}/state/")]
    names = {k.rsplit("/", 1)[1] for k in keys}
    assert names == ({"ssm", "conv"} if name.startswith("mamba2")
                     else {"h0", "conv0", "h1", "conv1", "k", "v", "pos",
                           "h", "conv"})
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
                assert float(np.abs(got[r][key] - mine).max()) <= TOL * top, (
                    key, r)
    if name.startswith("mamba2"):
        h, m = _cfg(name.split("/")[0]).ssm_heads, mesh.sizes[-1]
        heads = got[0][f"{name}/state/0/ssm"].shape[2]
        assert heads == (h // m if h % m == 0 else h)


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("/b4")])
def test_each_rank_holds_its_serving_shard_of_the_weights(runs, name):
    """Each rank's leaves have their ``serving_param_spec`` block's
    shape: ``w_in``'s columns (1104; 1090 for the head dim 256, which
    stay whole on 4 ranks) and the RG-LRU's (D, D) projections cut over
    ``model``, their d_model rows over ``data``, ``w_out``'s rows over
    ``model``."""
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
    sizes = dict(zip(mesh.axis_names, mesh.sizes))
    data, model = sizes.get("data", 1), sizes["model"]
    cfg = _cfg(arch)
    if arch.startswith("mamba2"):
        cols = 2 * cfg.ssm_d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
        w_in = got[0][f"{name}/params/group0/ssd/w_in"]
        assert w_in.tolist() == [cfg.n_layers, cfg.d_model // data,
                                 cols // model if cols % model == 0
                                 else cols]
        w_out = got[0][f"{name}/params/group0/ssd/w_out"]
        assert w_out.tolist() == [cfg.n_layers, cfg.ssm_d_inner // model,
                                  cfg.d_model // data]
    else:
        for leaf in ("w_x", "w_gate", "w_a", "w_i"):
            w = got[0][f"{name}/params/group1/rec/{leaf}"]
            assert w.tolist() == [1, cfg.d_model // data,
                                  cfg.d_model // model], leaf
        w_out = got[0][f"{name}/params/group1/rec/w_out"]
        assert w_out.tolist() == [1, cfg.d_model // model,
                                  cfg.d_model // data]


@pytest.mark.parametrize("name", WINDOWED)
def test_griffin_decodes_past_its_window_over_sequence_shards(runs, name):
    """The steps' positions pass the window, the cache's slots lie on
    several ranks, the logits match the reference's, and the window's
    mask bites: the same steps without it move them far past the
    tolerance."""
    want, got = runs
    cfg = _cfg("recurrentgemma-2b")
    t = BATCHES["b4"][1]
    assert t - cfg.window > 0
    mesh = _mesh_shape(name)
    spec = rules.state_spec(mesh, ("pos",),
                            torch.empty((1, 4, _cache_len(name))), batch=4)
    assert spec[-1] == "model"
    ref = want[f"{name}/logits"][1:]
    top = float(np.abs(ref).max())
    for r in range(4):
        assert _rel_err(got[r][f"{name}/logits"][1:], ref, top) <= TOL
        assert _rel_err(got[r][f"{name}/window_off"], ref, top) > 100 * TOL


@functools.cache
def _engine_without_mesh(arch):
    cfg = _cfg(arch)
    params = lm_params_from_numpy(_params(arch), cfg, device="cpu")
    return lm_mesh_engine(LM(cfg), params, _prompts(), NEW_TOKENS,
                          MAX_BATCH, CACHE_LEN)


@pytest.mark.parametrize("name", ENGINE)
def test_engine_streams_match_the_engine_without_a_mesh(runs, name):
    _, got = runs
    want = np.array(_engine_without_mesh(name.split("/")[0]))
    for r in range(4):
        np.testing.assert_array_equal(got[r][f"engine/{name}"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_one_by_one_mesh_is_the_no_mesh_path_bit_for_bit(tmp_path, arch):
    cfg = _cfg(arch)
    params = lm_params_from_numpy(_params(arch), cfg, device="cpu")
    model = LM(cfg)
    name = f"{arch}/m4/b4"
    tokens, steps = (torch.from_numpy(a) for a in _inputs(name))
    want, want_state = lm_mesh_run(model, params, tokens, steps,
                                   _cache_len(name))
    with process_group(0, 1, tmp_path / "store", timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        local = lm_shard_from_numpy(_params(arch), cfg, mesh, device="cpu")
        with use_mesh(mesh):
            got, state = lm_mesh_run(model, local, tokens, steps,
                                     _cache_len(name))
            streams = lm_mesh_engine(model, local, _prompts(), NEW_TOKENS,
                                     MAX_BATCH, CACHE_LEN)
    assert torch.equal(got, want)
    for g, w in zip(state["groups"], want_state["groups"]):
        assert set(g) == set(w)
        for leaf in w:
            assert torch.equal(g[leaf], w[leaf]), leaf
    assert streams == _engine_without_mesh(arch)
