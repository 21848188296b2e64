"""The port's recurrent LM families (``repro_torch.models.lm`` with the
``ssd``, ``rec`` and ``griffin`` group kinds) against ``repro.models.lm``
on the CPU.

Configs: ``mamba2-780m`` ``.reduced()`` (2 ``ssd`` layers, d 256, 16
heads of 32, state 32, chunk 32) and ``recurrentgemma-2b``
``.reduced(n_layers=5)`` (a ``griffin`` super-block and a ``rec`` group
of 2, window 32, one KV head of 64). The reference's parameters are drawn
once with JAX, their zero leaves replaced by seeded numpy noise so those
paths carry weight, and carried across by ``lm_params_from_numpy``; the
JAX side is jitted.

Tolerances, each output's largest |error| over its largest |value|:
``TOL`` = 1e-4 in float32 (the scans and matmuls sum in other orders
than XLA's), ``BF16_TOL`` = 2e-2 in bfloat16 (the two sides round
activations at other places). In float32 every gradient leaf is held to
``TOL``; in bfloat16 the gradients are held to ``BF16_TOL`` as one
vector, by the norm of their error over their norm: a single leaf's
bfloat16 gradient is as far as 1.5-4% of its largest |value| from the
same model's float32 gradient on the reference's side too (these
configs), so 2e-2 leaf by leaf would test the rounding, not the port.
Decode is teacher-forced with the reference's tokens, so one near-tie
cannot cascade.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.optim import extract_features as jextract
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.optim import extract_features
from repro_torch.tree import leaves

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

# arch -> its reduced() overrides: recurrentgemma at 5 layers, so that
# the rec remainder group runs beside the griffin super-block
ARCHS = {"mamba2-780m": (), "recurrentgemma-2b": (("n_layers", 5),)}
TOL = 1e-4
BF16_TOL = 2e-2
F32_LEAVES = {"a_log", "d_skip", "dt_bias", "lam"}


def _close(got, want, tol=TOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
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


def _overrides(arch, dtype, remat):
    over = dict(ARCHS[arch], remat=remat)
    jover, tover = dict(over), dict(over)
    if dtype == "bfloat16":
        jover.update(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
        tover.update(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    return jover, tover


@functools.cache
def _model(arch, dtype="float32", remat=False):
    """(jcfg, cfg, the reference's parameters as numpy, the same as the
    port's tensors)."""
    jover, tover = _overrides(arch, dtype, remat)
    jcfg = jget_config(arch).reduced(**jover)
    cfg = get_config(arch).reduced(**tover)
    params = _noisy(jlm.LM(jcfg).init(jax.random.PRNGKey(0)),
                    np.random.default_rng(0))
    return (jcfg, cfg, params,
            interop.lm_params_from_numpy(params, cfg, device="cpu"))


def _jp(params):
    return jax.tree.map(jnp.asarray, params)


def _paths(tree):
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dtype_name(x):
    return (str(x.dtype).split(".")[-1] if isinstance(x, torch.Tensor)
            else np.dtype(x.dtype).name)


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else TOL


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the group plan and the parameter tree
# ---------------------------------------------------------------------------

def test_group_plans():
    assert [(g.kind, g.n) for g in tlm.LM(get_config(
        "recurrentgemma-2b")).groups] == [("griffin", 8), ("rec", 2)]
    assert [(g.kind, g.n) for g in tlm.LM(get_config(
        "recurrentgemma-2b").reduced(n_layers=5)).groups] == [
        ("griffin", 1), ("rec", 2)]
    assert [(g.kind, g.n) for g in tlm.LM(get_config(
        "mamba2-780m")).groups] == [("ssd", 48)]
    assert tlm.LM(get_config("mamba2-780m")).recurrent
    assert not tlm.LM(get_config("tinyllama-1.1b")).recurrent


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_reference(arch, dtype):
    """Names, shapes and dtypes of ``LM.init`` and of the reference's tree
    through ``lm_params_from_numpy``: the float32 leaves stay float32 in a
    bfloat16 tree, every other leaf is ``param_dtype``."""
    jcfg, cfg, params, tparams = _model(arch, dtype)
    want = _paths(params)
    got = _paths(tlm.LM(cfg).init(torch.Generator().manual_seed(0)))
    crossed = _paths(tparams)
    assert got.keys() == want.keys() == crossed.keys()
    for path, w in want.items():
        name = path.split("'")[-2]
        assert _dtype_name(w) == ("float32" if name in F32_LEAVES
                                  else dtype), path
        for tree in (got, crossed):
            assert tuple(tree[path].shape) == w.shape, path
            assert _dtype_name(tree[path]) == _dtype_name(w), path
        np.testing.assert_array_equal(crossed[path].float().numpy(),
                                      np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# serving: prefill's logits and states, teacher-forced decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_teacher_forced_decode(arch, dtype):
    jcfg, cfg, params, tp = _model(arch, dtype)
    jp, tol = _jp(params), _tol(dtype)
    toks = _tokens(cfg.vocab, (2, 64), 5)
    jm, tm = jlm.LM(jcfg), tlm.LM(cfg)
    jl, js = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"inputs": jnp.asarray(toks)}, cache_len=72)
    tl, ts = tm.prefill(tp, {"inputs": torch.from_numpy(toks)}, cache_len=72)
    _close(tl, jl, tol, "prefill logits")

    def states_close(step):
        got, want = _paths(ts["groups"]), _paths(js["groups"])
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert _dtype_name(got[path]) == _dtype_name(w), path
            if path.endswith("['pos']"):
                np.testing.assert_array_equal(got[path].numpy(), w)
            else:
                _close(got[path], w, tol, f"{step} {path}")
        assert int(ts["index"]) == int(js["index"])
    states_close("prefill")
    tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
    decode = jax.jit(jm.decode_step)
    for i in range(4):
        jl, js = decode(jp, js, jnp.asarray(tok))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(tok))
        _close(tl, jl, tol, f"decode {i} logits")
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
    states_close("decode")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_decode_state_matches_the_reference(arch):
    jcfg, cfg, _, _ = _model(arch, "bfloat16")
    want = _paths(jlm.LM(jcfg).init_decode_state(3, 40, index=5)["groups"])
    state = tlm.LM(cfg).init_decode_state(3, 40, index=5, device="cpu")
    got = _paths(state["groups"])
    assert got.keys() == want.keys() and int(state["index"]) == 5
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert _dtype_name(got[path]) == _dtype_name(w), path
        np.testing.assert_array_equal(got[path].float().numpy(),
                                      np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# training: LM.loss and its gradients; the backbone's features
# ---------------------------------------------------------------------------

@functools.cache
def _jax_value_and_grad(arch, dtype, remat):
    model = jlm.LM(_model(arch, dtype, remat)[0])
    return jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b),
                                      has_aux=True))


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", True)])
def test_loss_and_gradients_match_the_reference(arch, dtype, remat):
    _, cfg, params, tp = _model(arch, dtype, remat)
    toks = _tokens(cfg.vocab, (2, 33), 6)
    mask = (np.random.default_rng(7).random((2, 32)) < 0.8).astype(np.float32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    (jloss, jaux), jgrads = _jax_value_and_grad(arch, dtype, remat)(
        _jp(params), {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = ttrain.loss_and_grads(
        tlm.LM(cfg), tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = _tol(dtype)
    _close(loss, jloss, tol if dtype == "bfloat16" else 1e-5, "loss")
    _close(metrics["ce"], jaux["ce"], tol if dtype == "bfloat16" else 1e-5,
           "ce")
    want = _paths(jgrads)
    got = _paths(grads)
    assert got.keys() == want.keys()
    err2 = ref2 = 0.0
    for path, w in want.items():
        assert _dtype_name(got[path]) == _dtype_name(w), path
        if dtype == "float32":
            _close(got[path], w, tol, f"grad {path}")
        w = np.asarray(jnp.asarray(w, jnp.float32), np.float64)
        err2 += float(np.sum((got[path].float().numpy() - w) ** 2))
        ref2 += float(np.sum(w * w))
    assert (err2 / ref2) ** 0.5 <= tol


@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_gives_the_same_gradients(arch):
    """Per-unit recomputation (a griffin super-block one unit) changes no
    value."""
    _, cfg, _, tp = _model(arch)
    toks = torch.from_numpy(_tokens(cfg.vocab, (2, 33), 8))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    plain = ttrain.loss_and_grads(tlm.LM(cfg), tp, batch)
    remat = ttrain.loss_and_grads(
        tlm.LM(dataclasses.replace(cfg, remat=True)), tp, batch)
    assert torch.equal(plain[0], remat[0])
    for g, w in zip(leaves(remat[2]), leaves(plain[2])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_features(arch, dtype):
    jcfg, cfg, params, tp = _model(arch, dtype)
    toks = _tokens(cfg.vocab, (3, 32), 9)
    jm, tm = jlm.LM(jcfg), tlm.LM(cfg)
    for pool in ("mean", "last"):
        want = jax.jit(functools.partial(jextract, jm, pool=pool))(
            _jp(params), jnp.asarray(toks))
        with torch.no_grad():
            got = extract_features(tm, tp, torch.from_numpy(toks), pool=pool)
        assert got.dtype == torch.float32
        _close(got, want, _tol(dtype), pool)
