"""The port's recurrent blocks (``repro_torch.models.ssd`` and ``rglru``)
against ``repro.models.ssd`` and ``rglru`` on the CPU in float32.

Configs: ``mamba2-780m`` and ``recurrentgemma-2b`` ``.reduced()``. Block
parameters are drawn by the reference, their zero leaves (conv bias,
norm scale, gate biases) replaced by seeded numpy noise, and carried
across by ``interop.lm_params_from_numpy``; inputs come from a numpy
seed. The JAX side is jitted. The port's scans sum in another order than
the reference's (batched products in place of four-operand einsums, a
doubling scan in place of ``lax.associative_scan``), so every output is
held to ``TOL`` = 1e-4 of its largest |value| (and the scans' decode
continuations the same).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import rglru as jrg
from repro.models import ssd as jssd
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import rglru as trg
from repro_torch.models import ssd as tssd

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

TOL = 1e-4


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)


def _noisy(params, rng):
    def leaf(a):
        a = np.asarray(a)
        if not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(leaf, params)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@functools.cache
def _block(arch):
    """(jcfg, cfg, the reference's block params, the port's)."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    init = jssd.ssd_init if arch.startswith("mamba2") else jrg.rglru_init
    params = _noisy(init(jax.random.PRNGKey(1), jcfg),
                    np.random.default_rng(0))
    return (jcfg, cfg, jax.tree.map(jnp.asarray, params),
            lm_params_from_numpy(params, cfg, device="cpu"))


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# shared pieces: the causal conv, the segment sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["ssd", "rglru"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(module, with_state):
    jmod, tmod = (jssd, tssd) if module == "ssd" else (jrg, trg)
    rng = np.random.default_rng(2)
    x, w, b = _x(rng, 2, 9, 12), _x(rng, 4, 12), _x(rng, 12)
    state = _x(rng, 2, 3, 12) if with_state else None
    got, got_s = tmod._causal_conv(_t(x), _t(w), _t(b),
                                   None if state is None else _t(state))
    want, want_s = jmod._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b),
                                     None if state is None
                                     else jnp.asarray(state))
    _close(got, want)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_segsum_decay():
    rng = np.random.default_rng(3)
    da = -np.abs(_x(rng, 2, 3, 16))
    got = torch.exp(tssd._segsum_decay(_t(da)))
    want = jnp.exp(jssd._segsum_decay(jnp.asarray(da)))
    _close(got, want)
    assert not got.triu(diagonal=1).any()


# ---------------------------------------------------------------------------
# ssd (mamba2)
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, b, t, h, p, n):
    x = _x(rng, b, t, h, p)
    dt = np.log1p(np.exp(_x(rng, b, t, h) - 2.0)).astype(np.float32)
    a_neg = -np.arange(1, h + 1, dtype=np.float32) / h
    return (x, dt, a_neg, _x(rng, b, t, n), _x(rng, b, t, n),
            1.0 + 0.1 * _x(rng, h))


@pytest.mark.parametrize("t,chunk", [(32, 32), (64, 32), (96, 32), (16, 16),
                                     (64, 8), (7, 7)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan(t, chunk, with_state):
    rng = np.random.default_rng(4 + t + chunk)
    b, h, p, n = 2, 4, 8, 16
    inputs = _ssd_inputs(rng, b, t, h, p, n)
    s0 = _x(rng, b, h, n, p) if with_state else None
    y, s = tssd.ssd_scan(*map(_t, inputs), chunk=chunk,
                         init_state=None if s0 is None else _t(s0))
    jy, js = jax.jit(jssd.ssd_scan, static_argnames="chunk")(
        *map(jnp.asarray, inputs), chunk=chunk,
        init_state=None if s0 is None else jnp.asarray(s0))
    assert y.dtype == s.dtype == torch.float32
    _close(y, jy, what="y")
    _close(s, js, what="state")


def test_ssd_scan_refuses_a_ragged_length():
    rng = np.random.default_rng(5)
    inputs = _ssd_inputs(rng, 1, 40, 2, 4, 8)
    with pytest.raises(ValueError, match="divisible by the SSD scan chunk 32"):
        tssd.ssd_scan(*map(_t, inputs), chunk=32)


@pytest.mark.parametrize("t", [32, 64, 5])
def test_ssd_block_and_decode_continue_the_scan(t):
    jcfg, cfg, jp, tp = _block("mamba2-780m")
    rng = np.random.default_rng(6 + t)
    u = 0.5 * _x(rng, 2, t, cfg.d_model)
    out, s, c = tssd.ssd_block_apply(tp, _t(u), cfg, return_state=True)
    jout, js, jc = jax.jit(jssd.ssd_block_apply, static_argnums=2,
                           static_argnames="return_state")(
        jp, jnp.asarray(u), jcfg, return_state=True)
    _close(out, jout, what="out")
    _close(s, js, what="ssm state")
    _close(c, jc, what="conv state")
    step = jax.jit(jssd.ssd_decode_step, static_argnums=2)
    for i in range(3):
        v = 0.5 * _x(rng, 2, 1, cfg.d_model)
        out, s, c = tssd.ssd_decode_step(tp, _t(v), cfg, ssm_state=s,
                                         conv_state=c)
        jout, js, jc = step(jp, jnp.asarray(v), jcfg, ssm_state=js,
                            conv_state=jc)
        _close(out, jout, what=f"decode {i}")
        _close(s, js, what=f"decode {i} state")
        _close(c, jc, what=f"decode {i} conv")


def test_ssd_block_from_a_state_equals_the_whole_sequence():
    """A block run on the second half from the first half's states equals
    the run over the whole sequence (the scan's and the conv's carry)."""
    _, cfg, _, tp = _block("mamba2-780m")
    u = _t(0.5 * _x(np.random.default_rng(7), 1, 64, cfg.d_model))
    whole = tssd.ssd_block_apply(tp, u, cfg)
    _, s, c = tssd.ssd_block_apply(tp, u[:, :32], cfg, return_state=True)
    second = tssd.ssd_block_apply(tp, u[:, 32:], cfg, ssm_state=s,
                                  conv_state=c)
    _close(second, whole[:, 32:])


def test_make_ssd_state():
    jcfg, cfg, _, _ = _block("mamba2-780m")
    got = tssd.make_ssd_state(cfg, 3, 2, "cpu")
    want = jssd.make_ssd_state(jcfg, 3, 2)
    for name in ("ssm", "conv"):
        assert tuple(got[name].shape) == want[name].shape
        assert not got[name].any()
    assert got["ssm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# rglru (recurrentgemma)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 7, 64, 300])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_scan(t, with_state):
    jcfg, cfg, jp, tp = _block("recurrentgemma-2b")
    rng = np.random.default_rng(8 + t)
    x = _x(rng, 2, t, cfg.d_model)
    h0 = _x(rng, 2, cfg.d_model) if with_state else None
    y, h = trg.rglru_scan(tp, _t(x), None if h0 is None else _t(h0))
    jy, jh = jax.jit(jrg.rglru_scan)(jp, jnp.asarray(x),
                                     None if h0 is None else jnp.asarray(h0))
    assert h.dtype == torch.float32
    _close(y, jy, what="y")
    _close(h, jh, what="h_T")


def test_linear_scan_equals_the_recurrence():
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 77, 5)))
    b = torch.from_numpy(rng.standard_normal((2, 77, 5)))
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for i in range(77):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    _close(trg._linear_scan(a, b), torch.stack(want, dim=1), tol=1e-12)


@pytest.mark.parametrize("t", [32, 9])
def test_rglru_block_and_decode_continue_the_scan(t):
    jcfg, cfg, jp, tp = _block("recurrentgemma-2b")
    rng = np.random.default_rng(10 + t)
    u = _x(rng, 2, t, cfg.d_model)
    out, h, c = trg.rglru_block_apply(tp, _t(u), cfg, return_state=True)
    jout, jh, jc = jax.jit(jrg.rglru_block_apply, static_argnums=2,
                           static_argnames="return_state")(
        jp, jnp.asarray(u), jcfg, return_state=True)
    _close(out, jout, what="out")
    _close(h, jh, what="h")
    _close(c, jc, what="conv")
    step = jax.jit(jrg.rglru_decode_step, static_argnums=2)
    for i in range(3):
        v = _x(rng, 2, 1, cfg.d_model)
        out, h, c = trg.rglru_decode_step(tp, _t(v), cfg, state=h,
                                          conv_state=c)
        jout, jh, jc = step(jp, jnp.asarray(v), jcfg, state=jh,
                            conv_state=jc)
        _close(out, jout, what=f"decode {i}")
        _close(h, jh, what=f"decode {i} h")
        _close(c, jc, what=f"decode {i} conv")
        y, h1 = trg.rglru_step(tp, _t(v), h)
        jy, jh1 = jrg.rglru_step(jp, jnp.asarray(v), jh)
        _close(y, jy, what=f"step {i}")
        _close(h1, jh1, what=f"step {i} h")


# ---------------------------------------------------------------------------
# init: names, shapes, dtypes and distributions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_init_matches_the_reference(arch, dtype):
    jcfg = jget_config(arch).reduced(dtype=jnp.dtype(dtype),
                                     param_dtype=jnp.dtype(dtype))
    cfg = get_config(arch).reduced(dtype=getattr(torch, dtype),
                                   param_dtype=getattr(torch, dtype))
    jinit, tinit = ((jssd.ssd_init, tssd.ssd_init) if arch.startswith("mamba2")
                    else (jrg.rglru_init, trg.rglru_init))
    want = jinit(jax.random.PRNGKey(0), jcfg)
    got = tinit(torch.Generator().manual_seed(0), cfg, lead=(3,))
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: a, got, is_leaf=torch.is_tensor))[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        g = flat_g[path]
        assert tuple(g.shape) == (3,) + w.shape, path
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path
        if path[-1].key in ("a_log", "d_skip", "lam"):  # deterministic
            np.testing.assert_allclose(g[1].float().numpy(),
                                       np.asarray(w, np.float32), rtol=1e-6)
    if arch.startswith("mamba2"):
        dt0 = torch.nn.functional.softplus(got["dt_bias"])
        assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1001
