"""The port's sharding rules (``repro_torch.sharding.rules``) against
``repro.sharding.rules``, spec for spec, on the CPU.

Trees: every config of ``repro.configs`` and gemma3's right-sized
variants (``dense_sb`` rings of 1024 / 512 slots, over (``data``,
``model``) at batch 1) at full size through ``jax.eval_shape``
(parameters, decode states at batch 128 x 32,768 and batch 1 x 4,096, a
training batch of 8 x 4,096), and the port's own
trees: its parameters at ``reduced()`` and its decode states at full
size on the meta device. Meshes: (1, 1), (2, 2), a 4-way ``model`` axis
alone, the production 16 x 16
``data``/``model`` and 2 x 16 x 16 ``pod``/``data``/``model`` layouts
(``launch.mesh.make_production_mesh``), as ``MeshShape``s: the rules
read axis names and sizes only, and the reference's rule gets a stand-in
mesh with ``axis_names`` and ``devices.shape`` (all that its ``_axsize``
and ``_guard`` read). ``cohort_spec`` on ``clients`` and ``data``
meshes. ``placements`` and ``local_shard`` against DTensor's own layout.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.launch.input_specs import _batch_struct, _serving_param_shardings
from repro.models.lm import LM as JLM
from repro.sharding import rules as jrules
from repro_torch.configs import get_config
from repro_torch.core.base import root_key
from repro_torch.launch.mesh import (
    MeshShape,
    make_debug_mesh,
    make_production_mesh,
    process_group,
)
from repro_torch.models.lm import LM
from repro_torch.sharding import ctx
from repro_torch.sharding import rules

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

MESHES = {"1x1": MeshShape(("data", "model"), (1, 1)),
          "2x2": MeshShape(("data", "model"), (2, 2)),
          "m4": MeshShape(("model",), (4,)),
          "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
# (batch, cache) of the decode states
STATES = ((128, 32_768), (1, 4_096))
# the right-sized variants: dense_sb rings of min(window, cache) slots
RIGHTSIZED = ("gemma3_1b@rightsized", "gemma3_4b@rightsized")


def _stand_in(mesh: MeshShape):
    """What the reference's rules read of a ``jax.sharding.Mesh``."""
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 devices=np.empty(mesh.sizes, np.int8))


def _node(tree, names):
    for name in names:
        tree = tree[int(name)] if isinstance(tree, list) else tree[name]
    return tree


def _compare(mesh, tree, jrule, trule, **kw):
    """Every leaf's spec under the reference's rule equals the port's,
    read out of ``rules.tree_specs``; returns the leaf count."""
    got = rules.tree_specs(mesh, tree, trule, **kw)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        names = jrules._path_names(path)
        want = tuple(jrule(_stand_in(mesh), path, leaf, **kw))
        assert _node(got, names) == want, (names, leaf.shape)
    return len(flat)


@functools.cache
def _reference_trees(arch):
    cfg = jget_config(arch)
    model = JLM(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    states = [jax.eval_shape(lambda b=b, c=c: model.init_decode_state(b, c))
              for b, c in STATES]
    return cfg, params, states


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS + RIGHTSIZED)
def test_rules_match_the_reference_on_every_config(arch, mesh):
    cfg, params, states = _reference_trees(arch)
    m = MESHES[mesh]
    assert _compare(m, params, jrules.param_spec, rules.param_spec) > 0
    for (b, _), state in zip(STATES, states):
        _compare(m, state, jrules.state_spec, rules.state_spec, batch=b)
    batch = _batch_struct(cfg, 8, 4096, train=True)
    _compare(m, batch, jrules.batch_spec, rules.batch_spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["arctic_480b", "kimi_k2_1t_a32b",
                                  "tinyllama_1_1b", "llama32_vision_90b",
                                  "mamba2_780m", "recurrentgemma_2b",
                                  "whisper_tiny", "gemma3_1b@rightsized"])
def test_serving_layout_matches_the_reference(arch, mesh, monkeypatch):
    """``serving_param_spec`` against ``input_specs._serving_param_
    shardings`` (the experts F-sharded over data, the vocab table's
    d_model whole; the recurrent blocks' ``w_in``, ``w_x``, ``w_gate``,
    ``w_a``, ``w_i`` (data, model), ``w_out`` (model, data), ``conv_w``,
    ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip``, ``lam`` and the norms
    whole), whose ``NamedSharding`` is swapped for the spec it is
    given."""
    import repro.launch.input_specs as jspecs

    _, params, _ = _reference_trees(arch)
    m = MESHES[mesh]
    stand = _stand_in(m)
    base = jax.tree_util.tree_map_with_path(
        lambda p, leaf: types.SimpleNamespace(
            spec=jrules.param_spec(stand, p, leaf)), params)
    monkeypatch.setattr(jspecs, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(
                            spec=tuple(spec)))
    want = _serving_param_shardings(stand, params, base, 0)
    got = rules.tree_specs(m, params, rules.serving_param_spec)
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = jrules._path_names(path)
        assert _node(got, names) == _node(want, names).spec, names


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "arctic-480b",
                                  "kimi-k2-1t-a32b", "mamba2-780m",
                                  "recurrentgemma-2b", "whisper-tiny",
                                  "llama-3.2-vision-90b", "gemma3-1b"])
def test_the_ports_own_trees_give_the_reference_specs(arch):
    """The port's parameters at ``reduced()`` and its decode states at
    full size (meta device) against the reference's trees of the same
    config, on the 2 x 2 and multi-pod meshes."""
    jcfg = jget_config(arch).reduced()
    jparams = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    tparams = LM(get_config(arch).reduced()).init(root_key(0, device="cpu"))
    full = JLM(jget_config(arch))
    tfull = LM(get_config(arch))
    for m in (MESHES["2x2"], MESHES["2x16x16"]):
        want = rules.tree_specs(m, jparams, rules.param_spec)
        got = rules.tree_specs(m, tparams, rules.param_spec)
        assert got == want
        for b, c in STATES:
            jstate = jax.eval_shape(lambda: full.init_decode_state(b, c))
            tstate = tfull.init_decode_state(b, c, device="meta")
            assert (rules.tree_specs(m, tstate, rules.state_spec, batch=b)
                    == rules.tree_specs(m, jstate, rules.state_spec, batch=b))


COHORT_MESHES = {"clients4": MeshShape(("clients",), (4,)),
                 "data8": MeshShape(("data",), (8,)),
                 "clients_data": MeshShape(("clients", "data"), (2, 4)),
                 "data_model": MeshShape(("data", "model"), (2, 2)),
                 "model": MeshShape(("model",), (4,))}


@pytest.mark.parametrize("mesh", list(COHORT_MESHES))
def test_cohort_spec_matches_the_reference(mesh):
    m = COHORT_MESHES[mesh]
    for shape in ((8, 100, 18), (8, 100), (8,), (6, 5), (), (1, 3)):
        leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
        assert rules.cohort_spec(m, leaf) == tuple(
            jrules.cohort_spec(_stand_in(m), leaf)), shape


def test_pspec_and_axis_size_read_the_active_mesh():
    """Axes filtered to the active mesh as the reference's
    ``_filter_axes`` filters them; none without a mesh."""
    from repro.sharding import ctx as jctx

    axes = [(ctx.BATCH, None, ctx.MODEL), (None, ctx.MODEL, "pod"),
            (ctx.FSDP, ("model", "pod"))]
    assert ctx.pspec(*axes[0]) == ()
    assert ctx.axis_size("model") == 1
    for name, mesh in MESHES.items():
        with ctx.use_mesh(mesh):
            for a in axes:
                assert ctx.pspec(*a) == tuple(
                    jctx._filter_axes(_stand_in(mesh), a)), (name, a)
            assert ctx.axis_size("model") == mesh.shape["model"]
            assert ctx.axis_size("pod") == mesh.shape.get("pod", 1)
    assert ctx.get_mesh() is None


def test_local_shard_is_dtensors_block(tmp_path):
    """``placements`` and ``local_shard`` give the block that
    ``distribute_tensor`` puts on the rank (a 1 x 1 mesh here, and every
    rank of a 2 x 2 ``MeshShape`` against the reference's row-major
    blocks)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    m = MESHES["2x2"]
    spec = (("data", "model"), None)
    assert rules.placements(m, spec) == [Shard(0), Shard(0)]
    assert rules.placements(m, ("data", None)) == [Shard(0), Replicate()]
    for rank in range(4):
        d, mo = divmod(rank, 2)
        assert torch.equal(rules.local_shard(m, x, ("data", None, "model"),
                                             rank),
                           x[2 * d:2 * d + 2, :, 4 * mo:4 * mo + 4])
        assert torch.equal(rules.local_shard(m, x, spec, rank),
                           x[rank:rank + 1])
    with process_group(0, 1, tmp_path / "store", timeout_s=60):
        mesh = make_debug_mesh(1, 1)
        spec = ("data", None, "model")
        dt = distribute_tensor(x, mesh, rules.placements(mesh, spec))
        assert torch.equal(dt.to_local(), rules.local_shard(mesh, x, spec))
