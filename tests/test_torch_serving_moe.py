"""The port's serving engine and launchers on the MoE family, on the CPU in
float32: ``arctic-480b`` and ``kimi-k2-1t-a32b`` ``.reduced()`` (kimi: a
dense layer and a moe layer; 4 experts, top-2, capacity factor 1.25),
with the reference's weights through ``interop.lm_params_from_numpy``.

A moe layer's capacity counts the tokens of its call, and the engine
right-pads a prompt to a power-of-two bucket, so the bucket decides
which of a prompt's assignments are dropped: the reference's engine
differs from an exact-length prefill wherever that changes a drop
(ROADMAP, standing record 4 of the reference). The port follows the
reference there, so the oracle is the reference's engine: its tokens
equal the port engine's, request by request. At decode a moe call sees
``max_batch`` rows, and at ``max_batch`` <= 4 its capacity of 4 drops
nothing, so a request's tokens do not depend on its batch neighbours.
"""
import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.lm import LM as JLM
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import LM
from repro_torch.serving import Request, ServingEngine

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
CACHE_LEN = 64
LENGTHS, N_NEW = (5, 16, 9, 40, 7, 3), (6, 6, 6, 6, 6, 6)


@functools.cache
def _load(arch):
    jcfg = jget_config(arch).reduced()
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    return cfg, LM(cfg), params, (jcfg, jparams)


def _requests(cls, vocab):
    """One request per length, the prompts drawn in turn from one numpy
    stream of seed 0."""
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, vocab, n)] for n in LENGTHS]
    return [cls(uid=i, prompt=p, max_new_tokens=k)
            for i, (p, k) in enumerate(zip(prompts, N_NEW))]


@functools.cache
def _reference_engine_tokens(arch):
    cfg, _, _, (jcfg, jparams) = _load(arch)
    reqs = _requests(JRequest, cfg.vocab)
    engine = JServingEngine(JLM(jcfg), jax.tree.map(jnp.asarray, jparams),
                            max_batch=2, cache_len=CACHE_LEN)
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return tuple(tuple(r.generated) for r in reqs)


def _port_engine_tokens(arch, max_batch=2):
    cfg, model, params, _ = _load(arch)
    reqs = _requests(Request, cfg.vocab)
    engine = ServingEngine(model, params, max_batch=max_batch,
                           cache_len=CACHE_LEN)
    for r in reqs:
        engine.submit(r)
    with torch.no_grad():
        engine.run()
    assert all(r.done for r in reqs)
    return tuple(tuple(r.generated) for r in reqs)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_the_reference_engine(arch):
    assert _port_engine_tokens(arch) == _reference_engine_tokens(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_drops_nothing_so_slots_do_not_interact(arch):
    """One slot or two: the same tokens for every request (a decode call's
    capacity, 4, is at least its rows' assignments to any one expert)."""
    assert _port_engine_tokens(arch, 1) == _port_engine_tokens(arch, 2)
    cfg, model, params, _ = _load(arch)
    state = model.init_decode_state(4, CACHE_LEN, index=3, device="cpu")
    with tmoe.record_routes() as routes, torch.no_grad():
        model.decode_step(params, state, torch.zeros(4, 1, dtype=torch.int64))
    assert routes and all(r["capacity"] == 4 and bool(r["keep"].all())
                          for r in routes)


def _exact_length_generation(arch, prompt, n_new):
    """The reference's prefill of the prompt at its own length, then
    greedy decode."""
    _, _, _, (jcfg, jparams) = _load(arch)
    model = JLM(jcfg)
    jp = jax.tree.map(jnp.asarray, jparams)
    logits, state = jax.jit(model.prefill, static_argnames="cache_len")(
        jp, {"inputs": jnp.asarray([prompt], jnp.int32)}, cache_len=CACHE_LEN)
    decode = jax.jit(model.decode_step)
    out = [int(jnp.argmax(logits[0]))]
    for _ in range(n_new - 1):
        logits, state = decode(jp, state, jnp.asarray([[out[-1]]], jnp.int32))
        out.append(int(jnp.argmax(logits[0])))
    return out


def test_the_bucket_sets_the_capacity_of_a_padded_prompt():
    """Standing record 4: kimi's 7-token prompt is padded to the bucket of
    16, which raises each expert's capacity from max(4, int(1.25 2 7 / 4))
    = 4 to int(1.25 2 16 / 4) = 10. The reference engine's tokens then
    differ from the reference's own exact-length generation, and the port
    engine's equal the reference engine's."""
    arch = "kimi-k2-1t-a32b"
    cfg, model, params, _ = _load(arch)
    i = LENGTHS.index(7)
    req = _requests(Request, cfg.vocab)[i]
    exact = _exact_length_generation(arch, req.prompt, N_NEW[i])
    engine = _reference_engine_tokens(arch)
    assert list(engine[i]) != exact
    assert _port_engine_tokens(arch)[i] == engine[i]
    for tokens, capacity in ((7, 4), (16, 10)):
        with tmoe.record_routes() as routes, torch.no_grad():
            model.prefill(params, {"inputs": torch.zeros(
                1, tokens, dtype=torch.int64)}, cache_len=CACHE_LEN)
        assert [r["capacity"] for r in routes] == [capacity]


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_on_the_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "64", "--gen", "4"])
    text = out.getvalue()
    assert f"arch={arch}" in text and "sample tokens:" in text
    assert "nan" not in text.lower()


def test_train_launcher_and_its_loss_on_arctic():
    """``launch.train`` takes 2 steps of reduced arctic, and
    ``loss_and_grads``' loss is ce + 0.01 aux with aux > 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttrain.main(["--arch", "arctic-480b", "--reduced", "--device", "cpu",
                     "--steps", "2", "--batch", "2", "--seq", "32",
                     "--log-every", "1"])
    text = out.getvalue()
    assert "arch=arctic-480b" in text and "step     1" in text
    assert "nan" not in text.lower()
    cfg, model, params, _ = _load("arctic-480b")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 17)))
    loss, metrics, grads = ttrain.loss_and_grads(
        model, params, {"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    assert float(metrics["aux"]) > 0
    assert torch.equal(loss, metrics["ce"] + 0.01 * metrics["aux"])
    assert grads["group0"]["moe"]["router"].abs().sum() > 0
