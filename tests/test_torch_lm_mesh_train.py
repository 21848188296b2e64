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
``interop.lm_train_shard_from_numpy``. The reference runs in two JAX
subprocesses with ``--xla_force_host_platform_device_count=4`` (its
mesh's axes Auto), ``jax.jit(jax.value_and_grad(model.loss,
has_aux=True))`` on parameters placed by ``rules.param_spec`` and the
batch by ``rules.batch_spec``, then ``adamw_update``; the port in 4 gloo
ranks (``_torch_dist_child.py``, job ``lm_mesh_train``), all started
once for the file and joined with a timeout (``_torch_mesh_train.py``).
Meshes: (2 ``data``, 2 ``model``) and a 4-way ``model`` axis (its 2 KV
heads do not divide: ``wk`` and ``wv`` whole, each rank's q head reading
one KV head, their gradients summed over ``model``). The moe cases take
the decode branch (b t <= 4096 on a mesh with ``data``), the expert
branch on ``model`` 4, and the expert branch on (2, 2) at b t = 4608.
One tinyllama case has a mask whose counts differ between the data
ranks.

Each rank: loss, ce and aux equal to the other ranks' and within 1e-6
(relative) of the reference's; each gradient leaf's block within 1e-5 of
the reference leaf's largest |gradient|, bit-equal across the ranks
that hold the same block; after one ``train_step`` from an AdamW state
of step 3 (moments from a seed), gnorm equal on every rank and within
1e-6 of the reference's, and the blocks of the parameters and both
moments within 1e-5 of each leaf's largest |value|. A 1 x 1 mesh gives
the no-mesh ``loss_and_grads`` and ``train_step`` bit for bit (the
dense, moe, ssd and dec kinds, whisper's encoder with them); a ``pod``
axis raises for every kind, naming its ROADMAP item. The vocab-parallel
CE alone (``mesh_cross_entropy``, its value and gradients) against
``lm_cross_entropy`` and ``chunked_cross_entropy`` at a vocab that
divides over ``model`` (512) and at one that does not (509, the table
whole).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_train as mt
from repro.models import common as jcommon
from repro_torch.configs import get_config
from repro_torch.interop import (adamw_state_from_numpy,
                                 lm_params_from_numpy)
from repro_torch.launch.mesh import MeshShape, make_mesh, process_group
from repro_torch.launch.train import loss_and_grads, train_step
from repro_torch.models.lm import LM
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import use_mesh
from repro_torch.tree import leaves

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

MESHES = mt.MESHES
SUITE = mt.Suite(
    models={"tinyllama-1.1b": ("tinyllama-1.1b", {"remat": True}),
            "arctic-480b": ("arctic-480b", {}),
            "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", {"remat": True})},
    # name -> (model, mesh, B, T, masked)
    cases={"tiny/dm": ("tinyllama-1.1b", "dm", 4, 16, False),
           "tiny/m4": ("tinyllama-1.1b", "m4", 4, 16, False),
           "tiny/dm/mask": ("tinyllama-1.1b", "dm", 4, 16, True),
           "arctic/dm": ("arctic-480b", "dm", 4, 16, False),
           "arctic/m4": ("arctic-480b", "m4", 4, 16, False),
           "arctic/dm/long": ("arctic-480b", "dm", 2, 2304, False),
           "kimi/dm": ("kimi-k2-1t-a32b", "dm", 4, 16, False),
           "kimi/m4": ("kimi-k2-1t-a32b", "m4", 4, 16, False)})
CASES = SUITE.cases
# name -> (mesh, vocab, chunk); B 4, T 16, D 64
CE_CASES = {f"{m}/v{v}/{'chunked' if c else 'lm'}": (m, v, c)
            for m in MESHES for v in (512, 509) for c in (0, 8)}
# the no-mesh step against a 1 x 1 mesh's: a model of each of the dense,
# moe, ssd and dec kinds (whisper's encoder with it)
ONE_BY_ONE = mt.Suite(
    models={"tinyllama-1.1b": ("tinyllama-1.1b", {"remat": True}),
            "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", {"remat": True}),
            "mamba2-780m": ("mamba2-780m", {"remat": True}),
            "whisper-tiny": ("whisper-tiny", {})},
    cases={m: (m, "dm", 4, 16, False) for m in ("tinyllama-1.1b",
                                                 "kimi-k2-1t-a32b",
                                                 "mamba2-780m",
                                                 "whisper-tiny")})


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
    subprocesses and the port's 4 ranks, run side by side, the CE cases
    with them."""
    arrays = {}
    for name in CE_CASES:
        (arrays[f"feats/{name}"], arrays[f"table/{name}"],
         arrays[f"labels/{name}"], arrays[f"mask/{name}"]) = _ce_inputs(name)
    return mt.run(SUITE, tmp_path_factory.mktemp("lm_mesh_train"), arrays,
                  {"ce_cases": [{"name": n, "mesh": c[0], "chunk": c[2]}
                                for n, c in CE_CASES.items()]})


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_the_reference_on_every_rank(runs, name):
    mt.check_loss(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_blocks_match_the_reference(runs, name):
    mt.check_gradient_blocks(SUITE, runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_holding_one_block_have_bit_equal_gradients(runs, name):
    """Ranks whose coordinates differ only on axes a leaf's spec does not
    name hold the same block, and its gradient bit for bit."""
    mt.check_bit_equal_blocks(SUITE, runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_one_train_step_matches_the_reference(runs, name):
    mt.check_train_step(SUITE, runs, name)


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
                                   rtol=mt.LOSS_RTOL)
        for key, g, spec in (("feats", gf, fspec), ("table", gt, tspec)):
            mine = rules.local_shard(mesh, torch.tensor(np.asarray(g)),
                                     spec, rank=r).numpy()
            err = float(np.abs(out[f"ce/{name}/{key}"] - mine).max())
            assert err <= mt.GRAD_TOL * float(np.abs(g).max()), (r, key, err)


@pytest.mark.parametrize("model_name", list(ONE_BY_ONE.models))
def test_a_one_by_one_mesh_is_the_no_mesh_step_bit_for_bit(tmp_path,
                                                          model_name):
    cfg = ONE_BY_ONE.cfg(model_name)
    model = LM(cfg)
    params = lm_params_from_numpy(
        mt.unflatten(mt.params(ONE_BY_ONE, model_name)), cfg, device="cpu")
    batch = {key: torch.from_numpy(a).long() if key in ("inputs", "labels")
             else torch.from_numpy(a)
             for key, a in mt.batch(ONE_BY_ONE, model_name).items()}
    m, v = (mt.unflatten(x) for x in mt.moments(ONE_BY_ONE, model_name))

    def state():
        return adamw_state_from_numpy(
            {"m": m, "v": v, "step": np.array(mt.ADAM_STEP)}, device="cpu")

    def run():
        loss, met, grads = loss_and_grads(model, params, batch)
        p2, s2, loss2, ce2, gnorm = train_step(model, params, state(), batch,
                                               mt.LR)
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


@pytest.mark.parametrize("arch", [
    "tinyllama-1.1b", "mamba2-780m", "recurrentgemma-2b",
    "gemma3-1b@rightsized", "whisper-tiny", "llama-3.2-vision-90b"])
def test_what_is_not_ported_raises_under_loss(arch):
    """A mesh with a ``pod`` axis raises for every kind, naming its
    ROADMAP item."""
    cfg = get_config(arch).reduced()
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    tokens = torch.zeros((4, 8), dtype=torch.int64)
    with use_mesh(mesh), pytest.raises(
            NotImplementedError,
            match="ROADMAP.md queue 1, 'the pod axis over a mesh'"):
        LM(cfg).loss({}, {"inputs": tokens, "labels": tokens})
