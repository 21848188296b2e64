"""The port's serving engine on the recurrent LM families, on the CPU in
float32: ``mamba2-780m`` ``.reduced()`` (ssd chunk 32) and
``recurrentgemma-2b`` ``.reduced(n_layers=5)`` (griffin + rec), with the
reference's weights through ``interop.lm_params_from_numpy``.

A recurrent state absorbs whatever the prefill feeds it, so the engine
admits such a prompt without padding: the longest prefix the scan takes
through ``prefill`` (all of it for the rglru kinds; for mamba2 all of it
when its length is at most 32 or a multiple of 32), the rest through
``decode_step``. At the lengths (5, 16, 9, 40, 7, 3), 40 takes that
second path for mamba2 (32 + 8). The engine's tokens must equal each
request's isolated generation, and its first logits a ``decode_step``
walk from a zero state within ``TOL`` = 1e-4 of their largest |value|
(the scans sum in other orders than the one-token steps). The
reference's engine pads recurrent prompts too, and its tokens then
differ (ROADMAP, standing fault 3 of the reference).
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
from repro_torch.models.lm import LM
from repro_torch.serving import Request, ServingEngine

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

ARCHS = {"mamba2-780m": {}, "recurrentgemma-2b": {"n_layers": 5}}
CACHE_LEN = 64
LENGTHS, N_NEW = (5, 16, 9, 40, 7, 3), (4, 6, 5, 3, 6, 2)
TOL = 1e-4


@functools.cache
def _load(arch):
    jcfg = jget_config(arch).reduced(**ARCHS[arch])
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced(**ARCHS[arch])
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    return cfg, LM(cfg), params, (jcfg, jparams)


def _prompts(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def _isolated_generate(model, params, prompt, n_new):
    """Oracle: the prompt's real tokens alone (an exact-length prefill,
    or for an ssd length the scan refuses, the longest multiple of the
    chunk then one ``decode_step`` a token), then greedy decode."""
    cfg = model.cfg
    n = len(prompt)
    if cfg.family == "ssm" and n > cfg.ssm_chunk and n % cfg.ssm_chunk:
        n -= n % cfg.ssm_chunk
    toks = torch.tensor([prompt], dtype=torch.int64)
    with torch.no_grad():
        logits, state = model.prefill(params, {"inputs": toks[:, :n]},
                                      cache_len=CACHE_LEN)
        for i in range(n, len(prompt)):
            logits, state = model.decode_step(params, state,
                                              toks[:, i:i + 1])
        out = [int(torch.argmax(logits[0]))]
        for _ in range(n_new - 1):
            logits, state = model.decode_step(params, state,
                                              torch.tensor([[out[-1]]]))
            out.append(int(torch.argmax(logits[0])))
    return out


def _close(got, want, what=""):
    got, want = got.double(), want.double()
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_tokens_equal_isolated_generation(arch):
    cfg, model, params, _ = _load(arch)
    engine = ServingEngine(model, params, max_batch=2, cache_len=CACHE_LEN)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=k) for i, (p, k) in
            enumerate(zip(_prompts(cfg.vocab, LENGTHS), N_NEW))]
    for r in reqs:
        engine.submit(r)
    with torch.no_grad():
        engine.run()
    for r in reqs:
        assert r.done
        want = _isolated_generate(model, params, r.prompt, r.max_new_tokens)
        assert r.generated == want, (r.uid, len(r.prompt), r.generated, want)
    assert [engine._exact_prefix(n) for n in LENGTHS] == (
        [5, 16, 9, 32, 7, 3] if arch.startswith("mamba2") else list(LENGTHS))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_admission_equals_a_decode_walk_from_a_zero_state(arch):
    """The engine's first logits and its one-row state equal those of
    ``decode_step`` fed the prompt a token at a time from zeros."""
    cfg, model, params, _ = _load(arch)
    engine = ServingEngine(model, params, max_batch=2, cache_len=CACHE_LEN)
    with torch.no_grad():
        for n, prompt in zip(LENGTHS, _prompts(cfg.vocab, LENGTHS, seed=4)):
            logits, state = engine._prefill_exact(prompt)
            walk = model.init_decode_state(1, CACHE_LEN, index=0,
                                           device="cpu")
            for tok in prompt:
                want, walk = model.decode_step(params, walk,
                                               torch.tensor([[tok]]))
            _close(logits, want, f"logits at {n}")
            assert int(state["index"]) == int(walk["index"]) == n
            for got_g, want_g in zip(state["groups"], walk["groups"]):
                for name, leaf in want_g.items():
                    if name == "pos":
                        assert torch.equal(got_g[name], leaf), n
                    elif name in ("k", "v"):  # the slots the prompt wrote
                        _close(got_g[name][:, :, :n], leaf[:, :, :n],
                               f"{name} at {n}")
                    else:
                        _close(got_g[name], leaf, f"{name} at {n}")


def test_reference_engine_corrupts_the_recurrent_state():
    """The reference's engine right-pads a mamba2 prompt of 9 tokens to 16
    and replays its last token: its tokens differ from the reference's own
    isolated generation, which the port's engine reproduces."""
    cfg, model, params, (jcfg, jparams) = _load("mamba2-780m")
    prompt = _prompts(cfg.vocab, (9,), seed=5)[0]
    n_new = 6
    jmodel = JLM(jcfg)
    jp = jax.tree.map(jnp.asarray, jparams)
    logits, state = jax.jit(jmodel.prefill, static_argnames="cache_len")(
        jp, {"inputs": jnp.asarray([prompt], jnp.int32)}, cache_len=CACHE_LEN)
    decode = jax.jit(jmodel.decode_step)
    want = [int(jnp.argmax(logits[0]))]
    for _ in range(n_new - 1):
        logits, state = decode(jp, state, jnp.asarray([[want[-1]]], jnp.int32))
        want.append(int(jnp.argmax(logits[0])))
    jreq = JRequest(uid=0, prompt=prompt, max_new_tokens=n_new)
    jengine = JServingEngine(jmodel, jp, max_batch=2, cache_len=CACHE_LEN)
    jengine.submit(jreq)
    jengine.run()
    assert jreq.done and jreq.generated != want
    req = Request(uid=0, prompt=prompt, max_new_tokens=n_new)
    engine = ServingEngine(model, params, max_batch=2, cache_len=CACHE_LEN)
    engine.submit(req)
    with torch.no_grad():
        engine.run()
    assert req.generated == want


@pytest.mark.parametrize("arch", list(ARCHS))
def test_launchers_run_on_the_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "64", "--gen", "4"])
        ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--steps", "2", "--batch", "2", "--seq", "32",
                     "--log-every", "1"])
    text = out.getvalue()
    assert f"arch={arch}" in text and "sample tokens:" in text
    assert "nan" not in text.lower()
