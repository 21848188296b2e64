"""The port's cross attention (``repro_torch.models.attention``:
``attention_init`` with ``d_kv_in``, ``cross_kv``, ``attn_cross``) and
whisper's ``sinusoidal_positions`` (``repro_torch.models.lm``) against
``repro.models`` on the same numpy inputs, on the CPU.

The layers' parameters are the reference's (``attention_init`` from a
JAX key, the zero biases and norm scales replaced by seeded numpy noise
so those paths carry weight), carried across by
``interop.lm_params_from_numpy``. The JAX side is jitted.

Tolerances, each output's largest |error| over its largest |value|:
``TOL`` = 1e-4 in float32 (the products sum in another order than
XLA's), ``BF16_TOL`` = 2e-2 in bfloat16 (the projections round to
bfloat16 at other places than XLA's). The positions are sines and
cosines of float32 angles up to T - 1 radians, whose ``exp`` and
argument reduction differ between the libraries by an ulp: they are held
to ``POS_ULPS`` = 2 float32 ulps of the largest angle, absolute (2.4e-4
at whisper's 1500 frames, 1.9e-6 at 7).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

TOL = 1e-4
BF16_TOL = 2e-2
POS_ULPS = 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float().numpy(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _cfgs(dtype, **over):
    """whisper-tiny's reduced config with ``over``, in both packages."""
    jdt, tdt = DTYPES[dtype]
    return (jget_config("whisper-tiny").reduced(dtype=jdt, param_dtype=jdt,
                                                **over),
            get_config("whisper-tiny").reduced(dtype=tdt, param_dtype=tdt,
                                               **over))


def _noisy(params, rng):
    def leaf(a):
        a = np.asarray(a)
        if not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(leaf, params)


def _layer(jcfg, cfg, d_kv_in, seed):
    """(reference params as jax arrays, the same as the port's tensors)."""
    params = _noisy(jattn.attention_init(jax.random.PRNGKey(seed), jcfg,
                                         d_kv_in=d_kv_in),
                    np.random.default_rng(seed))
    return (jax.tree.map(jnp.asarray, params),
            lm_params_from_numpy(params, cfg, device="cpu"))


def _x(rng, dtype, *shape):
    """The same values as a jax array and a tensor in ``dtype``."""
    a = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("d_kv_in", [None, 96])
def test_attention_init_shapes_with_d_kv_in(d_kv_in):
    """K and V project from ``d_kv_in`` (default d_model), Q and the output
    keep d_model; the projections' scale is 1/sqrt(fan in)."""
    jcfg, cfg = _cfgs("float32", qkv_bias=True, qk_norm=True)
    want = jattn.attention_init(jax.random.PRNGKey(0), jcfg, d_kv_in=d_kv_in)
    got = tattn.attention_init(torch.Generator().manual_seed(0), cfg,
                               lead=(3,), d_kv_in=d_kv_in)
    assert sorted(got) == sorted(want)
    for name, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        key = jax.tree_util.keystr(name)
        leaf = got
        for part in key.strip("[]'").split("']['"):
            leaf = leaf[part]
        assert tuple(leaf.shape) == (3, *w.shape), key
        assert leaf.dtype == torch.float32, key
    d_kv = d_kv_in or cfg.d_model
    assert got["wk"].shape == (3, d_kv, cfg.n_kv_heads, cfg.head_dim)
    assert float(got["wk"].abs().max()) <= 2 / d_kv**0.5
    assert abs(float(got["wk"].std()) * d_kv**0.5 - 0.8796) < 0.05


@functools.cache
def _jit_cross_kv(jcfg):
    return jax.jit(lambda p, m: jattn.cross_kv(p, m, jcfg))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias,norm", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_cross_kv_matches_the_reference(dtype, bias, norm):
    jcfg, cfg = _cfgs(dtype, qkv_bias=bias, qk_norm=norm)
    jp, tp = _layer(jcfg, cfg, None, 1)
    assert ("bk" in tp) == bias and ("k_norm" in tp) == norm
    jm, tm = _x(np.random.default_rng(2), dtype, 2, 19, cfg.d_model)
    want = _jit_cross_kv(jcfg)(jp, jm)
    got = tattn.cross_kv(tp, tm, cfg)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    for name in ("k", "v"):
        assert got[name].dtype == DTYPES[dtype][1]
        _close(got[name], want[name], tol, name)


@functools.cache
def _jit_attn_cross(jcfg):
    return jax.jit(lambda p, x, mkv: jattn.attn_cross(p, x, mkv, jcfg))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("heads,kv_heads", [(8, 8), (8, 1)])
@pytest.mark.parametrize("t,s", [(5, 23), (17, 3), (1, 40)])
def test_attn_cross_matches_the_reference(dtype, heads, kv_heads, t, s):
    """GQA groups of 1 and 8, T != S (one query: a decode step), over K
    and V of a memory wider than d_model, with q-norm."""
    jcfg, cfg = _cfgs(dtype, n_heads=heads, n_kv_heads=kv_heads,
                      qk_norm=True)
    jp, tp = _layer(jcfg, cfg, 96, 3)
    rng = np.random.default_rng(4)
    jx, tx = _x(rng, dtype, 2, t, cfg.d_model)
    jm, tm = _x(rng, dtype, 2, s, 96)
    want = _jit_attn_cross(jcfg)(jp, jx, _jit_cross_kv(jcfg)(jp, jm))
    got = tattn.attn_cross(tp, tx, tattn.cross_kv(tp, tm, cfg), cfg)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, BF16_TOL if dtype == "bfloat16" else TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attn_cross_on_the_same_kv(dtype):
    """On identical K and V (the reference's, as the port's dtype), so
    only the attention's own arithmetic differs: the float32 products of
    ``q * scale`` rounded in the activations' dtype."""
    jcfg, cfg = _cfgs(dtype, n_heads=8, n_kv_heads=2)
    jp, tp = _layer(jcfg, cfg, None, 5)
    rng = np.random.default_rng(6)
    jx, tx = _x(rng, dtype, 3, 9, cfg.d_model)
    jk, tk = _x(rng, dtype, 3, 31, 2, cfg.head_dim)
    jv, tv = _x(rng, dtype, 3, 31, 2, cfg.head_dim)
    want = _jit_attn_cross(jcfg)(jp, jx, {"k": jk, "v": jv})
    got = tattn.attn_cross(tp, tx, {"k": tk, "v": tv}, cfg)
    _close(got, want, BF16_TOL if dtype == "bfloat16" else TOL)


@pytest.mark.parametrize("t,d", [(1, 2), (7, 64), (1500, 384), (33, 256)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sinusoidal_positions_even_widths(t, d, dtype):
    jdt, tdt = DTYPES[dtype]
    want = jlm.sinusoidal_positions(t, d, jdt)
    got = tlm.sinusoidal_positions(t, d, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (t, d)
    if dtype == "float32":
        atol = POS_ULPS * float(np.spacing(np.float32(max(t - 1, 1))))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)
    else:  # float32 values that close round to bfloat16 within an ulp
        _close(got, want, 2.0**-8)


@pytest.mark.parametrize("d", [3, 7, 385])
def test_sinusoidal_positions_odd_widths_raise(d):
    """The reference's odd width past 1 fails (its cosine columns are one
    too many for the odd slots); the port refuses it too. At width 1 the
    reference's one cosine column broadcasts into no slot, and both give
    the sines alone."""
    with pytest.raises(ValueError):
        jlm.sinusoidal_positions(4, d, jnp.float32)
    with pytest.raises(ValueError, match="even width"):
        tlm.sinusoidal_positions(4, d, torch.float32)
    np.testing.assert_allclose(
        tlm.sinusoidal_positions(9, 1, torch.float32).numpy(),
        np.asarray(jlm.sinusoidal_positions(9, 1, jnp.float32)), rtol=0,
        atol=POS_ULPS * float(np.spacing(np.float32(8))))
