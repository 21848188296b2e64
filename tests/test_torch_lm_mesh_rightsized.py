"""The port's right-sized LMs served over a mesh against
``repro.models.lm`` under the same mesh, on the CPU.

Configs: ``gemma3-1b@rightsized`` and ``gemma3-4b@rightsized`` at
``reduced(n_layers=8, window=8)``: a ``dense_sb`` group of two
super-blocks (2 local units, each with a ring of 8 slots, then a global
unit with a cache of ``cache_len`` slots) and a remainder ``dense``
group of 2 ring layers; 4 q heads and 1 or 2 KV heads, float32. The
reference's parameters are drawn once with JAX, their zero leaves
(norm scales) replaced by seeded numpy noise so those paths carry
weight and the embedding scaled by 0.1 (at the reference's init every
greedy stream repeats one id), then carried across by
``interop.lm_shard_from_numpy``. The reference runs in one JAX
subprocess with 4 forced host devices (its mesh's axes Auto, the script
of ``test_torch_lm_mesh.py``), the port in 4 gloo ranks
(``_torch_dist_child.py``, job ``lm_mesh_rightsized``), both started
once for the file and joined with a timeout. Meshes: (2 ``data``, 2
``model``) and a 4-way ``model`` axis. Cases:

  * a 12-token prefill (1.5 windows: every ring wraps) at batch 4 and at
    batch 1 into caches of 24 slots, then 4 teacher-forced decode steps:
    every call's logits within 1e-5 of the reference's max |logit| (the
    tolerance of the other mesh files); each rank's rings, global caches
    and positions equal to ``rules.local_shard`` of the reference's final
    state under ``rules.state_spec`` (K and V within 1e-5 of their max,
    positions exactly), a ring's 8 slots over ``model`` (4 a rank at
    batch 4 on (2, 2), 2 on the ``model`` mesh) or over (``data``,
    ``model``) at batch 1. The reference's prefill gives the remainder
    group a full cache of 24 slots where the port keeps a ring (ROADMAP
    section 3, record 6 (a)), so that group's ring slot p % 8 is held
    against the reference's slot p for every position it keeps;
  * each rank's parameter leaves at their ``rules.serving_param_spec``
    block's shape;
  * the engine's token streams on the mesh equal to the port's engine
    without a mesh (the reference's engine pads a right-sized prompt out
    of its ring: record 6 (b));
  * ``_cache_put`` of a ring's block alone, against the whole ring cut
    to the block, for prompts past the ring's length over 2 and 4 shards;
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
from repro_torch.models import attention as attn
from repro_torch.models import lm as tlm
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import use_mesh

from _torch_dist_child import KEY_SEP, lm_mesh_engine, lm_mesh_run
from _torch_threads import worker_threads
from test_torch_lm_mesh import _REFERENCE, _flatten

torch.set_num_threads(worker_threads())

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(__file__).resolve().parent / "_torch_dist_child.py"
ARCHS = ("gemma3-1b@rightsized", "gemma3-4b@rightsized")
OVERRIDES = {"n_layers": 8, "window": 8}
MESHES = {"dm": ((2, 2), ("data", "model")), "m4": ((4,), ("model",))}
BATCHES = {"b4": (4, 12), "b1": (1, 12)}  # name -> (B, T)
CASES = [f"{arch}/{mesh}/{b}" for arch in ARCHS for mesh in MESHES
         for b in BATCHES]
ENGINE = ["gemma3-1b@rightsized/dm", "gemma3-4b@rightsized/m4"]
STEPS, CACHE_LEN = 4, 24
PROMPT_LENS, NEW_TOKENS, MAX_BATCH = (5, 17, 9, 12, 3, 11), 5, 4
TOL = 1e-5
TIMEOUT_S = 240


def _cfg(arch):
    return get_config(arch).reduced(**OVERRIDES)


@functools.cache
def _params(arch):
    """The reference's parameters (numpy) of the reduced config, zero
    leaves noised and the embedding scaled by 0.1."""
    rng = np.random.default_rng(0)

    def leaf(a):
        a = np.asarray(a)
        if not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    params = jax.tree.map(leaf, JLM(jget_config(arch).reduced(**OVERRIDES))
                          .init(jax.random.PRNGKey(0)))
    params["embed"]["table"] = params["embed"]["table"] * np.float32(0.1)
    return params


def _inputs(name):
    """(tokens (B, T), teacher-forced steps (STEPS, B, 1)) of a case."""
    n, t = BATCHES[name.split("/")[2]]
    rng = np.random.default_rng(CASES.index(name))
    vocab = _cfg(name.split("/")[0]).vocab
    return (rng.integers(0, vocab, (n, t)).astype(np.int64),
            rng.integers(0, vocab, (STEPS, n, 1)).astype(np.int64))


def _prompts():
    rng = np.random.default_rng(97)
    return [rng.integers(0, 512, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [each rank's outputs]): the reference's
    subprocess and the port's 4 ranks, run side by side."""
    d = tmp_path_factory.mktemp("lm_mesh_rightsized")
    arrays = {}
    for arch in ARCHS:
        arrays.update({f"{arch}{KEY_SEP}{p}": a
                       for p, a in _flatten(_params(arch)).items()})
    for name in CASES:
        arrays[f"tokens/{name}"], arrays[f"steps/{name}"] = _inputs(name)
    np.savez(d / "data.npz", **arrays)
    job = {"kind": "lm_mesh_rightsized", "world": 4,
           "store": str(d / "store"), "data": str(d / "data.npz"),
           "out": str(d), "meshes": MESHES, "cache_len": CACHE_LEN,
           "overrides": {arch: OVERRIDES for arch in ARCHS},
           "cases": [{"name": n, "arch": n.split("/")[0],
                      "mesh": n.split("/")[1], "cache_len": CACHE_LEN}
                     for n in CASES],
           "engine": [{"name": n, "arch": n.split("/")[0],
                       "mesh": n.split("/")[1]} for n in ENGINE],
           "prompts": _prompts(), "new_tokens": NEW_TOKENS,
           "max_batch": MAX_BATCH, "timeout_s": TIMEOUT_S}
    (d / "job.json").write_text(json.dumps(job))
    # the reference's engine is not run: it pads a right-sized prompt
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


def _ring_of(full: dict, end: int, slots: int) -> dict:
    """The ring of ``slots`` slots (k, v, pos) that holds a full cache's
    positions [end - slots, end), position p at slot p % slots."""
    ring = {name: np.zeros(a.shape[:2] + (slots,) + a.shape[3:], a.dtype)
            for name, a in full.items()}
    ring["pos"][:] = -1
    for p in range(max(0, end - slots), end):
        for name, a in full.items():
            ring[name][:, :, p % slots] = a[:, :, p]
    return ring


@pytest.mark.parametrize("name", CASES)
def test_logits_match_the_reference_under_the_mesh(runs, name):
    want, got = runs
    ref = want[f"{name}/logits"]
    top = float(np.abs(ref).max())
    for r in range(4):
        assert _rel_err(got[r][f"{name}/logits"], ref, top) <= TOL, r


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_its_ring_and_cache_shards(runs, name):
    """Every state leaf of every rank is ``local_shard`` of the global
    leaf under ``state_spec``: the super-blocks' local rings and global
    caches as the reference's, the remainder group's ring as the
    reference's full cache folded into 8 slots."""
    want, got = runs
    mesh = _mesh_shape(name)
    batch, t = BATCHES[name.split("/")[2]]
    cfg = _cfg(name.split("/")[0])
    prefix = f"{name}/state/"
    rem = {leaf: want[f"{prefix}1/{leaf}"] for leaf in ("k", "v", "pos")}
    assert rem["k"].shape[2] == CACHE_LEN  # the reference's full cache
    glob = {k[len(prefix):]: a for k, a in want.items()
            if k.startswith(prefix + "0/")}
    glob.update({f"1/{leaf}": a for leaf, a in
                 _ring_of(rem, t + STEPS, cfg.window).items()})
    assert sorted(glob) == sorted(
        f"{g}/{leaf}" for g in ("0/loc", "0/glob", "1")
        for leaf in ("k", "v", "pos"))
    assert glob["0/loc/k"].shape[3] == glob["1/k"].shape[2] == cfg.window
    assert glob["0/glob/k"].shape[2] == CACHE_LEN
    for key, a in glob.items():
        leaf = torch.from_numpy(a)
        spec = rules.state_spec(mesh, (key.rsplit("/", 1)[1],), leaf,
                                batch=batch)
        top = float(leaf.abs().max()) or 1.0
        for r in range(4):
            mine = rules.local_shard(mesh, leaf, spec, rank=r).numpy()
            have = got[r][prefix + key]
            assert have.shape == mine.shape, (key, r)
            if key.endswith("pos"):
                np.testing.assert_array_equal(have, mine, (key, r))
            else:
                assert _rel_err(have, mine, top) <= TOL, (key, r)
    # a ring's slots lie on several ranks: 8 / 2 or 8 / 4
    ring = got[0][prefix + "0/loc/pos"].shape[-1]
    assert ring == cfg.window // (2 if name.split("/")[1:] == ["dm", "b4"]
                                  else 4)


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("/b4")])
def test_each_rank_holds_its_serving_shard_of_the_weights(runs, name):
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
        assert total < sum(a.size for a in flat.values()) / 2
    cfg = _cfg(arch)
    sizes = dict(zip(mesh.axis_names, mesh.sizes))
    wq = got[0][f"{name}/params/group0/loc/attn/wq"]
    assert wq.tolist() == [2, cfg.local_per_global,
                           cfg.d_model // sizes.get("data", 1),
                           cfg.n_heads // sizes["model"], cfg.head_dim]


@functools.cache
def _engine_without_mesh(arch):
    cfg = _cfg(arch)
    params = lm_params_from_numpy(_params(arch), cfg, device="cpu")
    return lm_mesh_engine(tlm.LM(cfg), params, _prompts(), NEW_TOKENS,
                          MAX_BATCH, CACHE_LEN)


@pytest.mark.parametrize("name", ENGINE)
def test_engine_streams_match_the_engine_without_a_mesh(runs, name):
    _, got = runs
    want = np.array(_engine_without_mesh(name.split("/")[0]))
    assert len({tuple(s) for s in want.tolist()}) > 1
    for r in range(4):
        np.testing.assert_array_equal(got[r][f"engine/{name}"], want)


@pytest.mark.parametrize("t,shards", [(12, 2), (12, 4), (10, 2), (21, 4),
                                      (5, 2)])
def test_a_rings_block_takes_the_kept_positions_of_its_slots(t, shards):
    """``_cache_put`` of each block of an 8-slot ring (``SeqShard``
    offset, 8 slots) equals the whole ring's write cut to the block: a
    prompt of 1.5 rings over 2 shards keeps positions 4-11, position p at
    slot p % 8; one of 10 leaves positions 8, 9, 2, 3 in the first
    block."""
    s = 8
    gen = torch.Generator().manual_seed(t)
    k, v = (torch.randn((2, t, 1, 4), generator=gen) for _ in range(2))

    def empty(slots):
        return {"k": torch.zeros((2, slots, 1, 4)),
                "v": torch.zeros((2, slots, 1, 4)),
                "pos": torch.full((2, slots), -1, dtype=torch.int32)}
    whole = empty(s)
    tlm._cache_put(whole, k, v)
    kept = range(max(0, t - s), t)
    assert sorted(whole["pos"][0].tolist()) == sorted(
        list(kept) + [-1] * (s - len(kept)))
    for p in kept:
        assert int(whole["pos"][0, p % s]) == p
    local = s // shards
    for b in range(shards):
        block = empty(local)
        tlm._cache_put(block, k, v, attn.SeqShard(b * local, s, None))
        for name in block:
            assert torch.equal(block[name],
                               whole[name][:, b * local:(b + 1) * local])
    if (t, shards) == (10, 2):
        assert whole["pos"][0, :4].tolist() == [8, 9, 2, 3]


@pytest.mark.parametrize("arch", ARCHS)
def test_a_one_by_one_mesh_is_the_no_mesh_path_bit_for_bit(tmp_path, arch):
    cfg = _cfg(arch)
    params = lm_params_from_numpy(_params(arch), cfg, device="cpu")
    model = tlm.LM(cfg)
    tokens, steps = (torch.from_numpy(a) for a in _inputs(f"{arch}/m4/b4"))
    want, want_state = lm_mesh_run(model, params, tokens, steps, CACHE_LEN)
    with process_group(0, 1, tmp_path / "store", timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        local = lm_shard_from_numpy(_params(arch), cfg, mesh, device="cpu")
        with use_mesh(mesh):
            got, state = lm_mesh_run(model, local, tokens, steps, CACHE_LEN)
            streams = lm_mesh_engine(model, local, _prompts(), NEW_TOKENS,
                                     MAX_BATCH, CACHE_LEN)
    assert torch.equal(got, want)
    flat, want_flat = (_flatten({str(i): g for i, g in enumerate(s["groups"])})
                       for s in (state, want_state))
    assert flat.keys() == want_flat.keys()
    for key, a in want_flat.items():
        np.testing.assert_array_equal(flat[key], a, key)
    assert streams == _engine_without_mesh(arch)
