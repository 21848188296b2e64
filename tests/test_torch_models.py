"""The port's LM modules (``repro_torch.models``) against ``repro.models``
on the same parameters and inputs, on the CPU in float32.

Configs: ``tinyllama-1.1b`` (SwiGLU, GQA), ``gemma3-1b`` (local:global
windows and thetas, qk-norm, sandwich norms, GeGLU, tied embeddings) and
``qwen1.5-110b`` (QKV bias), each ``.reduced()``. The reference's
parameters are drawn once with JAX, their norm scales and biases (zero
at init) replaced by seeded numpy noise so those paths carry weight, and
carried across by ``lm_params_from_numpy``. Matmuls sum in another order
than XLA's, so values are held to 1e-4 (atol and rtol); decode is
teacher-forced with the reference's tokens, so one near-tie cannot
cascade.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

ARCHS = ["tinyllama-1.1b", "gemma3-1b", "qwen1.5-110b"]
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol, atol=tol)


def _noisy(params, rng):
    """Replace zero-initialized leaves (norm scales, biases) with noise."""
    def leaf(a):
        a = np.asarray(a)
        if not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(leaf, params)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    params = _noisy(jlm.LM(jcfg).init(jax.random.PRNGKey(0)),
                    np.random.default_rng(0))
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = lm_params_from_numpy(params, cfg, device="cpu")
    return jcfg, cfg, jparams, tparams


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _unit(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_configs_match_reference():
    for arch in ARCH_IDS:
        want = dataclasses.asdict(jget_config(arch))
        got = dataclasses.asdict(get_config(arch))
        for name in ("dtype", "param_dtype"):
            assert str(got.pop(name)).split(".")[-1] == jnp.dtype(
                want.pop(name)).name
        assert got == want, arch
    red = get_config("gemma3-1b").reduced()
    assert (red.n_layers, red.window, red.local_per_global, red.dtype) == (
        2, 32, 2, torch.float32)
    assert get_config("gemma3-4b@rightsized").cache_mode == "rightsized"
    assert INPUT_SHAPES["prefill_32k"].seq_len == 32_768


def test_primitives(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(1)
    x = _x(rng, 2, 5, cfg.d_model)
    p0 = _unit(jp["group0"], 0)
    t0 = tlm._layer(tp["group0"], 0)
    _close(tcommon.rmsnorm(t0["ln1"], torch.from_numpy(x)),
           jcommon.rmsnorm(p0["ln1"], jnp.asarray(x)))
    _close(tcommon.mlp_apply(t0["mlp"], torch.from_numpy(x), cfg),
           jcommon.mlp_apply(p0["mlp"], jnp.asarray(x), jcfg))
    toks = rng.integers(0, cfg.vocab, (2, 7))
    _close(tcommon.embed(tp["embed"], torch.from_numpy(toks), cfg),
           jcommon.embed(jp["embed"], jnp.asarray(toks), jcfg))
    h = _x(rng, 2, 9, cfg.n_heads, cfg.head_dim)
    for positions in (np.arange(9), rng.integers(0, 4000, (2, 9))):
        for theta in (1e4, 1e6):
            _close(tattn.rope(torch.from_numpy(h), torch.from_numpy(positions),
                              theta),
                   jattn.rope(jnp.asarray(h), jnp.asarray(positions),
                              jnp.float32(theta)), tol=2e-4)


def test_embed_scales_in_bfloat16():
    """The sqrt(d) scale is rounded to the activation dtype first."""
    cfg = get_config("gemma3-1b").reduced(d_model=200, dtype=torch.bfloat16,
                                          param_dtype=torch.bfloat16)
    jcfg = jget_config("gemma3-1b").reduced(d_model=200, dtype=jnp.bfloat16,
                                            param_dtype=jnp.bfloat16)
    table = np.random.default_rng(2).standard_normal((cfg.vocab, 200))
    toks = np.arange(12).reshape(3, 4)
    got = tcommon.embed({"table": torch.tensor(table).bfloat16()},
                        torch.from_numpy(toks), cfg)
    want = jcommon.embed({"table": jnp.asarray(table, jnp.bfloat16)},
                         jnp.asarray(toks), jcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_attention_and_unit(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(3)
    x = _x(rng, 2, 20, cfg.d_model)
    g = tlm.build_groups(cfg)[0]
    for i in range(cfg.n_layers):
        p, t = _unit(jp["group0"], i), tlm._layer(tp["group0"], i)
        kw = dict(window=g.windows[i], theta=g.thetas[i])
        jkw = dict(window=jnp.int32(g.windows[i]),
                   theta=jnp.float32(g.thetas[i]))
        _close(tattn.attn_full(t["attn"], torch.from_numpy(x), cfg, **kw),
               jax.jit(jattn.attn_full, static_argnums=2)(
                   p["attn"], jnp.asarray(x), jcfg, **jkw))
        got = tlm._dense_unit_apply(t, torch.from_numpy(x), cfg, **kw)[0]
        want = jax.jit(jlm._dense_unit_apply, static_argnums=2)(
            p, jnp.asarray(x), jcfg, **jkw)
        _close(got, want)


def test_attn_decode_with_per_row_index(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(4)
    s = 24
    k = _x(rng, 3, s, cfg.n_kv_heads, cfg.head_dim)
    v = _x(rng, 3, s, cfg.n_kv_heads, cfg.head_dim)
    pos = np.tile(np.arange(s, dtype=np.int32), (3, 1))
    pos[1, 10:] = -1  # a shorter row
    index = np.array([30, 10, 17], np.int32)  # row 0 wraps the ring
    x = _x(rng, 3, 1, cfg.d_model)
    g = tlm.build_groups(cfg)[0]
    for window in (0, 5):
        p, t = _unit(jp["group0"], 0), tlm._layer(tp["group0"], 0)
        tcache = {"k": torch.tensor(k), "v": torch.tensor(v),
                  "pos": torch.tensor(pos)}
        got, tcache = tattn.attn_decode(t["attn"], torch.from_numpy(x), tcache,
                                        torch.from_numpy(index), cfg,
                                        window=window, theta=g.thetas[0])
        want, jcache = jax.jit(jattn.attn_decode, static_argnums=4)(
            p["attn"], jnp.asarray(x),
            {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)},
            jnp.asarray(index), jcfg, window=jnp.int32(window),
            theta=jnp.float32(g.thetas[0]))
        _close(got, want)
        for name in ("k", "v", "pos"):
            _close(tcache[name], jcache[name])


def test_prefill_and_teacher_forced_decode(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 40))
    jm, tm = jlm.LM(jcfg), tlm.LM(cfg)
    jl, js = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"inputs": jnp.asarray(toks)}, cache_len=48)
    tl, ts = tm.prefill(tp, {"inputs": torch.from_numpy(toks)}, cache_len=48)
    _close(tl, jl)
    for name in ("k", "v", "pos"):
        _close(ts["groups"][0][name], js["groups"][0][name])
    js["index"] = jnp.asarray([40, 37], jnp.int32)
    ts["index"] = torch.tensor([40, 37], dtype=torch.int32)
    tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
    decode = jax.jit(jm.decode_step)
    for _ in range(4):
        jl, js = decode(jp, js, jnp.asarray(tok))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(tok))
        _close(tl, jl)
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
    np.testing.assert_array_equal(ts["index"].numpy(), [44, 41])


def test_init_draws_the_reference_distributions():
    cfg = get_config("tinyllama-1.1b").reduced(n_layers=4)
    params = tlm.LM(cfg).init(torch.Generator().manual_seed(0))
    wq = params["group0"]["attn"]["wq"]
    assert wq.shape == (4, cfg.d_model, cfg.n_heads, cfg.head_dim)
    std = 1.0 / cfg.d_model**0.5
    assert float(wq.abs().max()) <= 2 * std
    # a standard normal truncated at +-2 has standard deviation 0.8796
    assert abs(float(wq.std()) / std - 0.8796) < 0.02
    wo = params["group0"]["attn"]["wo"]
    assert float(wo.abs().max()) <= 2 / (cfg.n_heads * cfg.head_dim
                                         * 2 * cfg.n_layers) ** 0.5
    emb = params["embed"]["table"]
    assert abs(float(emb.std()) * cfg.d_model**0.5 - 1.0) < 0.02
    assert not params["group0"]["ln1"]["scale"].any()
    assert params["lm_head"].shape == (cfg.d_model, cfg.vocab)


def test_later_families_and_loss_raise():
    for arch, kind in (("mamba2-780m", "ssd"), ("kimi-k2-1t-a32b", "moe"),
                       ("recurrentgemma-2b", "griffin"),
                       ("llama-3.2-vision-90b", "vlm"),
                       ("whisper-tiny", "dec"),
                       ("gemma3-1b@rightsized", "dense_sb")):
        with pytest.raises(NotImplementedError, match=f"'{kind}'.*ROADMAP"):
            tlm.LM(get_config(arch).reduced())
    cfg = get_config("tinyllama-1.1b").reduced()
    model = tlm.LM(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 9),
                         generator=torch.Generator().manual_seed(0))
    total, metrics = model.loss(model.init(torch.Generator().manual_seed(0)),
                                {"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    assert total.shape == () and bool(torch.isfinite(total))
    assert float(metrics["aux"]) == 0.0 and torch.equal(total, metrics["ce"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tlm.LM(get_config("tinyllama-1.1b").reduced()).init_decode_state(1, 8)
