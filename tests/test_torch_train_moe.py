"""``LM.loss`` of the port's MoE LM family (the ``moe`` group kind), its
auxiliary loss and its gradients, and ``extract_features``, against
``repro.models.lm`` on the CPU.

The configs, parameters and tolerances are ``tests/test_torch_models_moe.py``'s
(its helpers are imported): arctic ``.reduced()`` and kimi
``.reduced(n_layers=3)``, and the two head layouts of the full models.
Values are held by their largest |error| over their largest |value|:
the loss and CE to 1e-5 in float32, every gradient leaf to ``TOL`` =
1e-4; in bfloat16 everything to ``BF16_TOL`` = 2e-2, the gradients as
one vector by the norm of their error over their norm. The auxiliary
loss to ``AUX_TOL`` = 1e-5 in float32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.optim import extract_features as jextract
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.optim import extract_features
from repro_torch.tree import leaves

from _torch_threads import worker_threads
from test_torch_models_moe import (
    ARCHS,
    AUX_TOL,
    LAYOUTS,
    _close,
    _dtype_name,
    _jp,
    _model,
    _paths,
    _tokens,
    _tol,
)

torch.set_num_threads(worker_threads())


# ---------------------------------------------------------------------------
# training: LM.loss with its auxiliary loss, and its gradients
# ---------------------------------------------------------------------------

@functools.cache
def _jax_value_and_grad(arch, dtype, remat, over=None):
    model = jlm.LM(_model(arch, dtype, remat, over)[0])
    return jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b),
                                      has_aux=True))


def _batch(vocab, seed=6):
    toks = _tokens(vocab, (2, 33), seed)
    mask = (np.random.default_rng(7).random((2, 32)) < 0.8).astype(np.float32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _loss_and_grads_close(arch, dtype, remat, over=None):
    _, cfg, params, tp = _model(arch, dtype, remat, over)
    batch = _batch(cfg.vocab)
    (jloss, jaux), jgrads = _jax_value_and_grad(arch, dtype, remat, over)(
        _jp(params), {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = ttrain.loss_and_grads(
        tlm.LM(cfg), tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = _tol(dtype)
    scalar_tol = tol if dtype == "bfloat16" else 1e-5
    _close(loss, jloss, scalar_tol, "loss")
    _close(metrics["ce"], jaux["ce"], scalar_tol, "ce")
    _close(metrics["aux"], jaux["aux"],
           tol if dtype == "bfloat16" else AUX_TOL, "aux")
    assert metrics["aux"].dtype == torch.float32 and float(metrics["aux"]) > 0
    assert torch.equal(loss, metrics["ce"] + 0.01 * metrics["aux"])
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
@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", True)])
def test_loss_and_gradients_match_the_reference(arch, dtype, remat):
    """``LM.loss`` = ce + 0.01 aux, aux the float32 sum of the moe
    layers' Switch losses, and every gradient leaf (the router's through
    the routing weights and the Switch loss, every expert's)."""
    _loss_and_grads_close(arch, dtype, remat)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_head_layouts_loss_and_gradients(layout):
    arch, over = LAYOUTS[layout]
    _loss_and_grads_close(arch, "float32", False, over)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_gives_the_same_loss_and_gradients(arch):
    _, cfg, _, tp = _model(arch)
    toks = torch.from_numpy(_tokens(cfg.vocab, (2, 33), 8))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    plain = ttrain.loss_and_grads(tlm.LM(cfg), tp, batch)
    remat = ttrain.loss_and_grads(
        tlm.LM(dataclasses.replace(cfg, remat=True)), tp, batch)
    assert torch.equal(plain[0], remat[0])
    assert torch.equal(plain[1]["aux"], remat[1]["aux"])
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
