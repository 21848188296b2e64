"""The port's LM training path against ``repro``'s on the CPU: the
cross-entropy functions, ``LM.loss`` and its gradients, AdamW and the
schedules, the token streams, one whole train step from the reference's
state, and ``repro_torch.launch.train``.

The model is ``tinyllama-1.1b`` reduced (2 layers, d 256, 4 heads over 2
KV heads, float32), its parameters drawn by the reference with the zero
norm scales replaced by seeded noise, and carried across by
``lm_params_from_numpy``. The JAX side is jitted. Tolerances: losses to
rtol 1e-5; each gradient leaf, each parameter and each moment after a
step to 1e-4 of its largest |value| (float32 sums in other orders than
XLA's, through two layers and their backward); bfloat16 AdamW states to
one bfloat16 ulp (2^-8) of each leaf's largest |value|, and the
parameters they move to lr 2^-7 a step; the streams' tokens bit for bit.
"""
import io
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.lm_stream import FastLMStream as JFastLMStream
from repro.data.lm_stream import LMStream as JLMStream
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.optim import linear_warmup_cosine as jwarmup
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data import FastLMStream, LMStream
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    cosine_schedule,
    linear_warmup_cosine,
)
from repro_torch.tree import leaves

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

ARCH = "tinyllama-1.1b"
B, T = 2, 32
RTOL = 1e-5
LEAF_TOL = 1e-4


def _leaf_close(got, want, tol=LEAF_TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
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


@functools.cache
def _model(**overrides):
    jcfg = jget_config(ARCH).reduced(**overrides)
    cfg = get_config(ARCH).reduced(**overrides)
    params = _noisy(jlm.LM(jcfg).init(jax.random.PRNGKey(0)),
                    np.random.default_rng(0))
    return jcfg, cfg, params


def _batch(vocab, mask=False, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, T + 1)).astype(np.int32)
    out = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["mask"] = (rng.random((B, T)) < 0.7).astype(np.float32)
    return out


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.tensor(np.asarray(v)) for k, v in b.items()}


@functools.cache
def _jax_value_and_grad(overrides):
    jcfg = _model(**dict(overrides))[0]
    model = jlm.LM(jcfg)
    return jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b),
                                      has_aux=True))


# -- cross-entropy -----------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_functions_match_reference(masked):
    rng = np.random.default_rng(2)
    v, d, chunk = 50, 16, 8
    logits = rng.standard_normal((B, T, v)).astype(np.float32)
    feats = rng.standard_normal((B, T, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.5).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    pairs = [
        (tcommon.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), tm),
         jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jm)),
        (tcommon.lm_cross_entropy(torch.from_numpy(feats),
                                  torch.from_numpy(table),
                                  torch.from_numpy(labels), tm),
         jcommon.lm_cross_entropy(jnp.asarray(feats), jnp.asarray(table),
                                  jnp.asarray(labels), jm)),
        (tcommon.chunked_cross_entropy(torch.from_numpy(feats),
                                       torch.from_numpy(table),
                                       torch.from_numpy(labels), chunk, tm),
         jcommon.chunked_cross_entropy(jnp.asarray(feats), jnp.asarray(table),
                                       jnp.asarray(labels), chunk, jm)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    # the chunked CE equals the unchunked one on the same features
    np.testing.assert_allclose(float(pairs[2][0]), float(pairs[1][0]),
                               rtol=RTOL)
    with pytest.raises(ValueError, match="divisible"):
        tcommon.chunked_cross_entropy(torch.from_numpy(feats),
                                      torch.from_numpy(table),
                                      torch.from_numpy(labels), 5)


# -- LM.loss and its gradients ------------------------------------------------

# (config overrides, batch with a mask): plain, masked, the chunked CE
LOSS_CASES = [((), False), ((), True), ((("logits_chunk", 8),), True)]


@pytest.mark.parametrize("overrides,masked", LOSS_CASES)
def test_loss_and_gradients_match_reference(overrides, masked):
    jcfg, cfg, params = _model(**dict(overrides))
    batch = _batch(cfg.vocab, mask=masked)
    (jloss, jaux), jgrads = _jax_value_and_grad(overrides)(
        jax.tree.map(jnp.asarray, params), _jbatch(batch))
    model = tlm.LM(cfg)
    tparams = interop.lm_params_from_numpy(params, cfg, device="cpu")
    loss, metrics, grads = ttrain.loss_and_grads(model, tparams,
                                                 _tbatch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jaux["ce"]),
                               rtol=RTOL)
    assert float(metrics["aux"]) == float(jaux["aux"]) == 0.0
    jl = jax.tree.leaves(jgrads)
    tl = leaves(grads)
    assert len(tl) == len(jl)
    for i, (g, w) in enumerate(zip(tl, jl)):
        _leaf_close(g.numpy(), w, what=f"grad leaf {i}")


@pytest.mark.parametrize("distinct", [8, 64, 512])
def test_bf16_embedding_gradient_is_no_farther_from_float32(distinct):
    """The table's gradient through a bfloat16 ``embed`` (its backward a
    bfloat16 scatter-add of the rows' cotangents) against ``jax.vjp`` of
    the reference's (``jnp.take``), 2048 tokens drawn from ``distinct``
    ids (a row summed 4 to 256 times): each against the float64 sum of
    the same bfloat16 cotangents times the bfloat16 scale; the port's
    error is at most the reference's (ROADMAP queue 2, item 30)."""
    cfg = get_config(ARCH).reduced(dtype=torch.bfloat16,
                                   param_dtype=torch.bfloat16)
    jcfg = jget_config(ARCH).reduced(dtype=jnp.bfloat16,
                                     param_dtype=jnp.bfloat16)
    rng = np.random.default_rng(distinct)
    v, d = cfg.vocab, cfg.d_model
    table = torch.tensor((rng.standard_normal((v, d)) * d**-0.5)
                         .astype(np.float32)).bfloat16()
    tokens = rng.integers(0, distinct, (8, 256))
    g = torch.tensor(rng.standard_normal((8, 256, d)).astype(
        np.float32)).bfloat16()
    t = table.clone().requires_grad_()
    tcommon.embed({"table": t}, torch.from_numpy(tokens), cfg).backward(g)
    _, vjp = jax.vjp(lambda tab: jcommon.embed({"table": tab},
                                               jnp.asarray(tokens), jcfg),
                     jnp.asarray(table.float().numpy(), jnp.bfloat16))
    ref = np.asarray(vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))[0]
                     .astype(jnp.float32), np.float64)
    scale = float(torch.tensor(d**0.5, dtype=torch.bfloat16))
    want = np.zeros((v, d))
    np.add.at(want, tokens.reshape(-1),
              g.double().numpy().reshape(-1, d) * scale)

    def err(got):
        return np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err(t.grad.double().numpy()) <= err(ref), (
        err(t.grad.double().numpy()), err(ref))


def test_remat_gives_the_same_gradients():
    """Per-unit recomputation (``cfg.remat``) changes no value."""
    _, cfg, params = _model()
    batch = _tbatch(_batch(cfg.vocab, mask=True))
    tparams = interop.lm_params_from_numpy(params, cfg, device="cpu")
    plain = ttrain.loss_and_grads(tlm.LM(cfg), tparams, batch)
    remat_cfg = get_config(ARCH).reduced(remat=True)
    remat = ttrain.loss_and_grads(tlm.LM(remat_cfg), tparams, batch)
    assert torch.equal(plain[0], remat[0])
    for g, w in zip(leaves(remat[2]), leaves(plain[2])):
        assert torch.equal(g, w)


def test_loss_features_equal_prefill_features():
    """The cache-free backbone computes what the prefill's does."""
    _, cfg, params = _model()
    model = tlm.LM(cfg)
    tparams = interop.lm_params_from_numpy(params, cfg, device="cpu")
    toks = torch.from_numpy(_batch(cfg.vocab)["inputs"])
    x = tcommon.embed(tparams["embed"], toks, cfg)
    with torch.no_grad():
        feats, aux, none = model._backbone(tparams, x)
        full, _, caches = model._backbone(tparams, x, cache_len=T)
    assert none is None and len(caches) == 1 and float(aux) == 0.0
    assert torch.equal(feats, full)


# -- AdamW and the schedules ------------------------------------------------

def test_schedules_match_reference():
    for step in (0, 1, 7, 19, 20, 21, 50, 99, 100, 150):
        for got, want in (
                (cosine_schedule(step, base_lr=3e-3, total_steps=100),
                 jcosine(jnp.float32(step), base_lr=3e-3, total_steps=100)),
                (linear_warmup_cosine(step, base_lr=3e-3, warmup_steps=20,
                                      total_steps=100),
                 jwarmup(jnp.float32(step), base_lr=3e-3, warmup_steps=20,
                         total_steps=100)),
                (linear_warmup_cosine(step, base_lr=1.0, warmup_steps=0,
                                      total_steps=10),
                 jwarmup(jnp.float32(step), base_lr=1.0, warmup_steps=0,
                         total_steps=10))):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _tree(rng, dtype):
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "nested": {"b": rng.standard_normal((5,)).astype(dtype),
                       "a": rng.standard_normal((3, 2, 2)).astype(dtype)}}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, None])
def test_adamw_matches_reference(state_dtype, grad_clip):
    rng = np.random.default_rng(4)
    params = _tree(rng, np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js = jadamw_init(jp, state_dtype=getattr(jnp, state_dtype))
    ts = adamw_init(tp, state_dtype=getattr(torch, state_dtype))
    jupd = jax.jit(functools.partial(jadamw_update, grad_clip=grad_clip))
    tol = 2.0**-8 if state_dtype == "bfloat16" else LEAF_TOL
    for step in range(4):
        grads = jax.tree.map(lambda a: 3 * a, _tree(rng, np.float32))
        lr = linear_warmup_cosine(step, base_lr=0.1, warmup_steps=2,
                                  total_steps=4)
        jp, js, jn = jupd(jp, jax.tree.map(jnp.asarray, grads), js,
                          lr=jwarmup(jnp.float32(step), base_lr=0.1,
                                     warmup_steps=2, total_steps=4))
        tp, ts, tn = adamw_update(tp, jax.tree.map(torch.from_numpy, grads),
                                  ts, lr=lr, grad_clip=grad_clip)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        for name in ("m", "v"):
            for g, w in zip(leaves(ts[name]), jax.tree.leaves(js[name])):
                assert str(g.dtype).endswith(state_dtype)
                _leaf_close(g.float().numpy(), w.astype(jnp.float32), tol=tol,
                            what=f"{name} step {step}")
        for g, w in zip(leaves(tp), jax.tree.leaves(jp)):
            assert g.dtype == torch.float32
            if state_dtype == "float32":
                _leaf_close(g.numpy(), w, what=f"params step {step}")
            else:
                # a moment one bfloat16 ulp apart moves a step's update
                # (at most about lr in size) by at most lr 2^-7
                err = np.abs(g.numpy() - np.asarray(w)).max()
                assert err <= (step + 1) * 0.1 * 2.0**-7, (step, err)


def test_adamw_keeps_bfloat16_parameters_and_state():
    tp = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    ts = adamw_init(tp, state_dtype=torch.bfloat16)
    tp2, ts2, _ = adamw_update(tp, {"w": torch.ones(4, dtype=torch.bfloat16)},
                               ts, lr=0.1)
    assert tp2["w"].dtype == ts2["m"]["w"].dtype == ts2["v"]["w"].dtype \
        == torch.bfloat16
    assert tp["w"].abs().sum() == 0  # the inputs are left as they were


# -- the token streams --------------------------------------------------------

def test_streams_are_bit_equal_to_reference():
    for mine, ref in ((FastLMStream(97, 24, 3, seed=5, device="cpu"),
                       JFastLMStream(97, 24, 3, seed=5)),
                      (LMStream(61, 12, 2, seed=2, device="cpu"),
                       JLMStream(61, 12, 2, seed=2))):
        for got, want in zip(mine.batches(3), ref.batches(3)):
            for name in ("inputs", "labels"):
                assert got[name].dtype == torch.int32
                np.testing.assert_array_equal(got[name].numpy(),
                                              np.asarray(want[name]))


# -- one whole train step, and the launcher -------------------------------------

def test_train_step_from_reference_state():
    """Three reference steps, then one step in each package from the
    reference's parameters and AdamW state."""
    jcfg, cfg, params = _model()
    jmodel, tmodel = jlm.LM(jcfg), tlm.LM(cfg)
    lr_at = functools.partial(jwarmup, base_lr=3e-3, warmup_steps=2,
                              total_steps=10)

    @jax.jit
    def jstep(p, s, batch, step):
        (loss, aux), grads = jax.value_and_grad(
            lambda q: jmodel.loss(q, batch), has_aux=True)(p)
        p2, s2, gnorm = jadamw_update(p, grads, s, lr=lr_at(step))
        return p2, s2, loss, aux["ce"], gnorm

    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw_init(jp)
    stream = JFastLMStream(cfg.vocab, T, B, seed=0)
    batches = list(stream.batches(4))
    for step in range(3):
        jp, js, *_ = jstep(jp, js, batches[step], jnp.float32(step))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    ts = interop.adamw_state_from_numpy(jax.tree.map(np.asarray, js),
                                        device="cpu")
    assert int(ts["step"]) == 3 and leaves(ts["m"])[0].dtype == torch.float32
    jp, js, jloss, jce, jn = jstep(jp, js, batches[3], jnp.float32(3))
    lr = linear_warmup_cosine(3, base_lr=3e-3, warmup_steps=2, total_steps=10)
    tp, ts, loss, ce, gnorm = ttrain.train_step(
        tmodel, tp, ts, _tbatch(jax.tree.map(np.asarray, batches[3])), lr)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(ce), float(jce), rtol=RTOL)
    np.testing.assert_allclose(float(gnorm), float(jn), rtol=1e-4)
    for g, w in zip(leaves(tp), jax.tree.leaves(jp)):
        _leaf_close(g.numpy(), w, what="params")
    for name in ("m", "v"):
        for g, w in zip(leaves(ts[name]), jax.tree.leaves(js[name])):
            _leaf_close(g.numpy(), w, what=name)


def test_train_launcher_runs_on_the_cpu(tmp_path):
    argv = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq", "16", "--log-every", "2", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "4"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttrain.main(argv)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("arch=tinyllama-1.1b params=")
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in steps] == [0, 2, 4, 5]
    for ln in steps:
        fields = dict(f.split("=") for f in ln.split()[2:])
        assert set(fields) == {"ce", "gnorm", "tok/s"}
        assert np.isfinite(float(fields["ce"]))
    assert lines[-1].startswith("ce first10=") and "improvement=" in lines[-1]
    # checkpoints at step 4 and at the end; a rerun resumes from step 6
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_000000004", "step_000000006"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttrain.main(argv[:4] + ["8"] + argv[5:])
    assert "restored step 6" in out.getvalue()
