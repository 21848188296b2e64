"""The port's mixture of experts (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy inputs, on the CPU.

Configs: ``arctic-480b`` ``.reduced()`` (4 experts, top-2, no shared
expert; its dense MLP beside the MoE lives in the LM unit) and
``kimi-k2-1t-a32b`` ``.reduced()`` (4 experts, top-2, one shared
expert), capacity factor 1.25. The reference's parameters are drawn once
with JAX and carried across by ``interop.lm_params_from_numpy``; the JAX
side is jitted.

Routing is held exactly: the expert ids, the kept mask and the buffer
slots (a capacity drop is all or nothing), and the drop fraction, which
counts them. Values are held by their largest |error| over their
largest |value|: ``TOL`` = 1e-4 in float32 (the matmuls sum in other
orders than XLA's), ``BF16_TOL`` = 2e-2 in bfloat16; the auxiliary loss
to ``AUX_TOL`` = 1e-5 (a float32 sum over the experts).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
TOL = 1e-4
BF16_TOL = 2e-2
AUX_TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _cfgs(arch, dtype="float32", **over):
    jover, tover = dict(over), dict(over)
    if dtype == "bfloat16":
        jover.update(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
        tover.update(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    return jget_config(arch).reduced(**jover), get_config(arch).reduced(**tover)


@functools.cache
def _setup(arch, dtype="float32"):
    """(jcfg, cfg, the reference's MoE parameters as numpy, the port's)."""
    jcfg, cfg = _cfgs(arch, dtype)
    params = jax.tree.map(np.asarray,
                          jmoe.moe_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, params, lm_params_from_numpy(params, cfg, device="cpu")


def _x(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _reference_dispatch(ids, e, capacity):
    """``repro.models.moe._moe_shard_body``'s lines (one shard) that
    place the assignments: (pos, keep, slot)."""
    flat = ids.reshape(-1)
    onehot = jax.nn.one_hot(flat, e + 1, dtype=jnp.int32)[:, :e]
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.sum(pos_in_e * onehot, axis=1)
    keep = pos < capacity
    slot = jnp.where(keep, flat * capacity + pos, e * capacity)
    return pos, keep, slot


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for name, sub in tree.items():
            out.update(_paths(sub, f"{prefix}/{name}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_reference(arch, dtype):
    """``moe_init``'s names, shapes and dtypes, alone and stacked by
    ``lead``; the shared expert only where the config has one."""
    jcfg, cfg, params, _ = _setup(arch, dtype)
    want = _paths(params)
    got = _paths(tmoe.moe_init(torch.Generator().manual_seed(0), cfg))
    stacked = _paths(tmoe.moe_init(torch.Generator().manual_seed(0), cfg,
                                   lead=(3,)))
    assert got.keys() == want.keys() == stacked.keys()
    assert ("/shared/w_up" in got) == (arch == "kimi-k2-1t-a32b")
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert tuple(stacked[path].shape) == (3, *w.shape), path
        assert str(got[path].dtype).split(".")[-1] == np.dtype(w.dtype).name
    if cfg.n_shared_experts:
        assert got["/shared/w_gate"].shape == (
            cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts)


def test_sliced_draws_keep_the_truncated_normal():
    """The expert stacks are drawn a matrix at a time: each matrix, and
    the stack, keep ``dense_init``'s truncated normal (cut at 2 standard
    deviations, so 0.8796 of its scale), the scale 1/sqrt(fan_in), and
    for w_down the residual scale 1/sqrt(2 L); the matrices differ."""
    cfg = get_config("arctic-480b").reduced(n_layers=3, moe_d_ff=384,
                                            n_experts=6)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, lead=(2,))
    d, f = cfg.d_model, cfg.moe_d_ff
    for name, fan_in, scale in (("w_gate", d, 1.0), ("w_up", d, 1.0),
                                ("w_down", f, (2.0 * cfg.n_layers) ** -0.5)):
        w = p[name]
        std = scale / fan_in**0.5
        assert float(w.abs().max()) <= 2 * std, name
        assert abs(float(w.std()) / std - 0.8796) < 0.01, name
        for m in w.reshape(-1, *w.shape[-2:]):
            assert abs(float(m.std()) / std - 0.8796) < 0.03, name
            assert abs(float(m.mean())) / std < 0.03, name
        flat = w.reshape(-1, *w.shape[-2:])
        assert not torch.equal(flat[0], flat[1])
    # a bfloat16 stack holds the float32 draws, rounded
    w16 = tcommon.stacked_dense_init(torch.Generator().manual_seed(1),
                                     (4, 64, 96), 64, torch.bfloat16)
    w32 = tcommon.stacked_dense_init(torch.Generator().manual_seed(1),
                                     (4, 64, 96), 64, torch.float32)
    assert w16.dtype == torch.bfloat16
    assert torch.equal(w16, w32.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens", [9, 32])
def test_route_matches_the_reference(arch, tokens):
    jcfg, cfg, params, tp = _setup(arch)
    jx, tx = _x((tokens, cfg.d_model), tokens)
    jids, jw, jaux = jax.jit(jmoe._route, static_argnums=2)(
        jnp.asarray(params["router"]), jx, jcfg)
    ids, w, aux = tmoe._route(tp["router"], tx, cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw, what="weights")
    _close(aux, jaux, AUX_TOL, "aux")
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.1, 0.4, 0.1]])
    values, ids = tmoe._top_k(probs, 2)
    jvalues, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jvalues))


@pytest.mark.parametrize("capacity", [1, 3, 8, 64])
def test_dispatch_places_like_the_reference(capacity):
    """pos, the kept mask and the slots, exactly, for ids with every
    expert over- and under-subscribed."""
    rng = np.random.default_rng(capacity)
    ids = rng.integers(0, 5, (40, 3))
    ids[:10] = 2  # one expert far over its capacity
    want = jax.jit(_reference_dispatch, static_argnums=(1, 2))(
        jnp.asarray(ids), 5, capacity)
    got = tmoe._dispatch(torch.from_numpy(ids).reshape(-1), 5, capacity)
    for name, g, w in zip(("pos", "keep", "slot"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_compute_matches_the_reference(arch):
    jcfg, cfg, params, tp = _setup(arch)
    jx, tx = _x((cfg.n_experts, 6, cfg.d_model), 4)
    want = jax.jit(jmoe._expert_compute, static_argnums=4)(
        *(jnp.asarray(params[n]) for n in ("w_gate", "w_up", "w_down")),
        jx, jcfg)
    got = tmoe._expert_compute(tp["w_gate"], tp["w_up"], tp["w_down"], tx,
                               cfg)
    _close(got, want)


def _reference_body(jcfg, params, jx, capacity):
    return jax.jit(functools.partial(
        jmoe._moe_shard_body, cfg=jcfg, n_exp_shards=1, shard_idx=0,
        capacity=capacity, model_axis=None))(
        jx, *(jnp.asarray(params[n]) for n in ("router", "w_gate", "w_up",
                                               "w_down")))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity", [1, 5, 64])
def test_shard_body_matches_the_reference(arch, capacity):
    """``_moe_shard_body`` with its routing recorded: ids, kept mask and
    slots equal the reference's, and output, aux and drop fraction."""
    jcfg, cfg, params, tp = _setup(arch)
    jx, tx = _x((24, cfg.d_model), 5)
    jout, jaux, jdrop = _reference_body(jcfg, params, jx, capacity)
    with tmoe.record_routes() as routes:
        out, aux, drop = tmoe._moe_shard_body(
            tx, tp["router"], tp["w_gate"], tp["w_up"], tp["w_down"],
            cfg=cfg, capacity=capacity)
    (r,) = routes
    jids = jax.jit(jmoe._route, static_argnums=2)(
        jnp.asarray(params["router"]), jx, jcfg)[0]
    _, jkeep, jslot = _reference_dispatch(jids, cfg.n_experts, capacity)
    np.testing.assert_array_equal(r["ids"].numpy(), np.asarray(jids))
    np.testing.assert_array_equal(r["keep"].numpy().reshape(-1),
                                  np.asarray(jkeep))
    np.testing.assert_array_equal(r["slot"].numpy().reshape(-1),
                                  np.asarray(jslot))
    assert r["capacity"] == capacity
    _close(out, jout)
    _close(aux, jaux, AUX_TOL, "aux")
    assert float(drop) == float(jdrop) == float(r["drop_frac"])
    assert (float(drop) > 0) == (not bool(r["keep"].all()))
    # 48 assignments over 4 experts: capacity 1 drops, 64 keeps all
    if capacity == 1:
        assert float(drop) > 0
    if capacity == 64:
        assert float(drop) == 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 9), (2, 16), (3, 7)])
@pytest.mark.parametrize("capacity", [None, 1, "ample"])
def test_moe_apply_matches_the_reference(arch, shape, capacity):
    """At the config's capacity (1.25 k B T / E, at least 4), at 1 and at
    B T k (nothing dropped): output, aux and drop fraction; the shared
    expert's MLP is added where the config has one."""
    jcfg, cfg, params, tp = _setup(arch)
    b, t = shape
    if capacity == "ample":
        capacity = b * t * cfg.top_k
    jx, tx = _x((b, t, cfg.d_model), b * t)
    jout, jaux, jdrop = jax.jit(functools.partial(
        jmoe.moe_apply, cfg=jcfg, capacity=capacity))(
        jax.tree.map(jnp.asarray, params), jx)
    out, aux, drop = tmoe.moe_apply(tp, tx, cfg, capacity=capacity)
    _close(out, jout)
    _close(aux, jaux, AUX_TOL, "aux")
    assert float(drop) == float(jdrop)
    if capacity == b * t * cfg.top_k:
        assert float(drop) == 0.0


def test_reduced_capacity_drops_and_unit_capacity_drops_more():
    """kimi at ``reduced()`` drops assignments at its own capacity on a
    9-token input (the capacity path runs), and more at capacity 1."""
    jcfg, cfg, params, tp = _setup("kimi-k2-1t-a32b")
    _, tx = _x((1, 9, cfg.d_model), 9)
    _, _, drop = tmoe.moe_apply(tp, tx, cfg)
    _, _, drop1 = tmoe.moe_apply(tp, tx, cfg, capacity=1)
    assert 0.0 < float(drop) < float(drop1) < 1.0


def _dense_oracle(params, x, cfg):
    """``tests/test_moe.py``'s no-capacity oracle: every token exactly by
    its top-k experts (no shared expert)."""
    b, t, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf.float() @ params["router"].float(), dim=-1)
    w, ids = torch.topk(probs, cfg.top_k)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    out = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        h = torch.nn.functional.silu(xf @ params["w_gate"][e]) * (
            xf @ params["w_up"][e])
        mask = torch.sum(torch.where(ids == e, w, 0.0), dim=-1)
        out = out + (h @ params["w_down"][e]) * mask[:, None]
    return out.reshape(b, t, d)


def test_matches_dense_oracle_with_ample_capacity():
    """``tests/test_moe.py``'s oracle test on the port: arctic reduced at
    capacity factor 8, no dense residual, capacity 32 > B T k / E."""
    jcfg = dataclasses.replace(jget_config("arctic-480b").reduced(
        capacity_factor=8.0), moe_dense_residual=False)
    cfg = dataclasses.replace(get_config("arctic-480b").reduced(
        capacity_factor=8.0), moe_dense_residual=False)
    params = jax.tree.map(np.asarray,
                          jmoe.moe_init(jax.random.PRNGKey(0), jcfg))
    tp = lm_params_from_numpy(params, cfg, device="cpu")
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(1), (2, 16, cfg.d_model), jnp.float32)))
    out, aux, drop = tmoe.moe_apply(tp, x, cfg, capacity=32)
    want = _dense_oracle(tp, x, cfg)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert float(drop) == 0.0
    # the Switch loss is near top_k for a near-uniform router
    assert 0.8 * cfg.top_k < float(aux) < 2.0 * cfg.top_k


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_moe_apply_matches_the_reference(arch):
    """In bfloat16 on identical inputs: ids and keeps exactly (the router
    runs in float32 on the same bfloat16 values), output within
    ``BF16_TOL``."""
    jcfg, cfg, params, tp = _setup(arch, "bfloat16")
    jx, tx = _x((2, 16, cfg.d_model), 11, "bfloat16")
    jout, jaux, jdrop = jax.jit(functools.partial(jmoe.moe_apply, cfg=jcfg))(
        jax.tree.map(jnp.asarray, params), jx)
    with tmoe.record_routes() as routes:
        out, aux, drop = tmoe.moe_apply(tp, tx, cfg)
    jids = jax.jit(jmoe._route, static_argnums=2)(
        jnp.asarray(params["router"]), jx.reshape(32, -1), jcfg)[0]
    np.testing.assert_array_equal(routes[0]["ids"].numpy(), np.asarray(jids))
    assert out.dtype == torch.bfloat16
    _close(out, jout, BF16_TOL)
    _close(aux, jaux, AUX_TOL, "aux")
    assert float(drop) == float(jdrop)
