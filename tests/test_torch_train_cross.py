"""The port's cross-attention LM families in training, and the serving
launcher on them: ``LM.loss`` and its gradients for whisper-tiny and
llama-3.2-vision-90b ``.reduced()`` / ``.reduced(n_layers=6)`` against
``jax.value_and_grad`` of ``repro.models.lm``'s on the CPU, remat on and
off, and ``python -m repro_torch.launch.serve`` on both.

The configs, the reference's parameters (zero leaves replaced by seeded
noise, the vlm's gates by +-U(0.5, 1.5)) and the tolerances are
``test_torch_models_cross``'s: ``TOL`` = 1e-4 in float32, every gradient
leaf held to it (the loss and CE to 1e-5); ``BF16_TOL`` = 2e-2 in
bfloat16, the loss and CE and the gradients held as one vector, by the
norm of their error over their norm.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.tree import leaves

from _torch_threads import worker_threads
from test_torch_models_cross import (BF16_TOL, CASES, TOL, _batch, _close,
                                     _dtype_name, _j, _jp, _model, _paths,
                                     _t, _tol)

torch.set_num_threads(worker_threads())

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def _jax_value_and_grad(case, dtype, remat):
    model = jlm.LM(_model(case, dtype, remat)[0])
    return jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b),
                                      has_aux=True))


def _loss_batch(cfg):
    batch = _batch(cfg, 2, 17, 10)
    toks = batch.pop("inputs")
    mask = (np.random.default_rng(11).random((2, 16)) < 0.8).astype(
        np.float32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:], "mask": mask,
            **batch}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", True)])
def test_loss_and_gradients_match_the_reference(case, dtype, remat):
    """``LM.loss`` and the gradient of every leaf (the vision projection,
    the gates and the encoder among them) against
    ``jax.value_and_grad`` of the reference's."""
    _, cfg, params, tp = _model(case, dtype, remat)
    batch = _loss_batch(cfg)
    (jloss, jaux), jgrads = _jax_value_and_grad(case, dtype, remat)(
        _jp(params), _j(batch))
    loss, metrics, grads = ttrain.loss_and_grads(tlm.LM(cfg), tp, _t(batch))
    tol = _tol(dtype)
    _close(loss, jloss, tol if dtype == "bfloat16" else 1e-5, "loss")
    _close(metrics["ce"], jaux["ce"], tol if dtype == "bfloat16" else 1e-5,
           "ce")
    assert float(metrics["aux"]) == 0.0
    want, got = _paths(jgrads), _paths(grads)
    assert got.keys() == want.keys()
    err2 = ref2 = 0.0
    for path, w in want.items():
        assert _dtype_name(got[path]) == _dtype_name(w), path
        w = np.asarray(jnp.asarray(w, jnp.float32), np.float64)
        if any(name in path for name in ("vision_proj", "encoder", "gate")):
            assert np.abs(w).max() > 0, path  # the memory's path is live
        if dtype == "float32":
            _close(got[path], w, tol, f"grad {path}")
        err2 += float(np.sum((got[path].float().numpy() - w) ** 2))
        ref2 += float(np.sum(w * w))
    assert (err2 / ref2) ** 0.5 <= tol


@pytest.mark.parametrize("case", list(CASES))
def test_remat_gives_the_same_gradients(case):
    """Per-unit recomputation (a vlm super-block one unit, its cross K and
    V recomputed with it) changes no value."""
    _, cfg, _, tp = _model(case)
    batch = _t(_loss_batch(cfg))
    plain = ttrain.loss_and_grads(tlm.LM(cfg), tp, batch)
    remat = ttrain.loss_and_grads(
        tlm.LM(dataclasses.replace(cfg, remat=True)), tp, batch)
    assert torch.equal(plain[0], remat[0])
    for g, w in zip(leaves(remat[2]), leaves(plain[2])):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_serve_launcher_on_the_cpu(arch):
    """``launch.serve`` draws the family's payload and prints its tokens."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS=str(worker_threads()))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--prompt-len", "16", "--gen", "8"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
        check=True).stdout
    assert f"arch={arch} batch=4 prompt=16 device=cpu" in out
    line = next(x for x in out.splitlines() if x.startswith("sample tokens:"))
    toks = [int(v) for v in line.split(":", 1)[1].strip(" []").split(",")]
    assert len(toks) == 8 and all(0 <= v < 512 for v in toks)
