"""The port's serving engine on right-sized models, on the CPU in float32:
``gemma3-1b@rightsized`` and ``gemma3-4b@rightsized``
``.reduced(n_layers=8, window=8)`` (two ``dense_sb`` super-blocks of 2
local units and a global one, then a remainder ``dense`` group of 2 with
rings), with the reference's weights through ``lm_params_from_numpy``.

The engine admits a right-sized model's prompt unpadded, its whole
length through ``prefill``: a ring of ``window`` slots would keep the
padding of a bucket past the window and drop the prompt's last real keys.
Its tokens must equal each request's isolated generation (an exact-length
prefill and greedy decode), and the logits each token came from the
isolated generation's within ``TOL`` = 1e-4 of their largest |value|
(batched and one-row matmuls sum in other orders), at prompt lengths
below, at and above the window, every bucket (16, 32) above it.

At the reference's init greedy decoding repeats one id: the tied
embedding of the input token dominates its own logit. The tests scale
the reference's embedding table by ``EMBED_SCALE`` = 0.1 (and replace
its zero leaves by seeded noise), and check that every generation holds
at least two distinct ids.

The two records of ROADMAP section 3, record 6, are pinned here: (a) the
reference's prefill and ``init_decode_state`` disagree on the remainder
group's cache (``cache_len`` against ``window`` slots), and its engine
raises at its first admission; (b) the reference's engine, which pads
the prompt and replays its last token, gives logits far from an
exact-length prefill's when the bucket exceeds the window. The example
``examples/long_context_decode_torch.py`` runs here too.
"""
import contextlib
import copy
import functools
import importlib.util
import io
import pathlib
import re

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
from repro_torch.models.lm import LM
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import _bucket

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

ARCHS = ("gemma3-1b@rightsized", "gemma3-4b@rightsized")
CUT = {"n_layers": 8, "window": 8}
CACHE_LEN = 48
# below, at and above the window of 8; buckets 16 and 32
LENGTHS, N_NEW = (5, 8, 13, 3, 20, 9), (6, 5, 4, 7, 3, 6)
EMBED_SCALE = 0.1
TOL = 1e-4
# finding (b): the reference engine's replayed logits against an
# exact-length prefill, as a share of max |logit|, at prompts whose bucket
# (16, 32) exceeds the window
PADDING_FAULT = 0.1


@functools.cache
def _load(arch, **cut):
    """(cfg, the port's model and parameters, (jcfg, the reference's
    parameters)): the reference's init, zero leaves replaced by noise and
    the embedding scaled by ``EMBED_SCALE``."""
    cut = cut or CUT
    jcfg = jget_config(arch).reduced(**cut)
    rng = np.random.default_rng(0)

    def leaf(a):
        a = np.asarray(a)
        return a if a.any() else (0.1 * rng.standard_normal(a.shape)).astype(
            a.dtype)
    params = jax.tree.map(leaf, JLM(jcfg).init(jax.random.PRNGKey(0)))
    params["embed"]["table"] = params["embed"]["table"] * EMBED_SCALE
    cfg = get_config(arch).reduced(**cut)
    return (cfg, LM(cfg), lm_params_from_numpy(params, cfg, device="cpu"),
            (jcfg, params))


def _prompts(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def _isolated_generate(model, params, prompt, n_new, cache_len=CACHE_LEN):
    """Oracle: an exact-length prefill, then greedy decode; the tokens and
    the logits row each came from."""
    with torch.no_grad():
        logits, state = model.prefill(
            params, {"inputs": torch.tensor([prompt])}, cache_len=cache_len)
        out, rows = [int(torch.argmax(logits[0]))], [logits[0]]
        for _ in range(n_new - 1):
            logits, state = model.decode_step(params, state,
                                              torch.tensor([[out[-1]]]))
            out.append(int(torch.argmax(logits[0])))
            rows.append(logits[0])
    return out, rows


def _spied_engine(model, params, **kw):
    """(an engine, {uid: the logits rows its tokens came from}): the
    model's prefill records an unpadded prompt's logits for the request
    with that prompt, its decode step each active slot's row."""
    rows, uids = {}, {}
    spy = copy.copy(model)

    def prefill(p, batch, **k):
        logits, state = model.prefill(p, batch, **k)
        uid = uids[tuple(batch["inputs"][0].tolist())]
        rows[uid] = [logits[0]]
        return logits, state

    def decode_step(p, state, toks):
        logits, state = model.decode_step(p, state, toks)
        for slot, req in enumerate(engine.slots):
            if req is not None:
                rows[req.uid].append(logits[slot])
        return logits, state
    spy.prefill, spy.decode_step = prefill, decode_step
    engine = ServingEngine(spy, params, **kw)
    real_submit = engine.submit

    def submit(req):
        uids[tuple(req.prompt)] = req.uid
        real_submit(req)
    engine.submit = submit
    return engine, rows


def _rows_close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= TOL, (what, i, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_and_logits_equal_isolated_generation(arch):
    cfg, model, params, _ = _load(arch)
    assert model.exact_prefill and cfg.window == 8
    assert all(_bucket(n) > cfg.window for n in LENGTHS)
    engine, rows = _spied_engine(model, params, max_batch=2,
                                 cache_len=CACHE_LEN)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=k) for i, (p, k) in
            enumerate(zip(_prompts(cfg.vocab, LENGTHS), N_NEW))]
    for r in reqs:
        engine.submit(r)
    with torch.no_grad():
        engine.run()
    for r in reqs:
        assert r.done
        want, want_rows = _isolated_generate(model, params, r.prompt,
                                             r.max_new_tokens)
        assert r.generated == want, (r.uid, len(r.prompt), r.generated, want)
        assert len(set(want)) >= 2, (r.uid, want)
        _rows_close(rows[r.uid], want_rows, f"request {r.uid}")


def test_reference_remainder_shapes_disagree_and_its_engine_raises():
    """Record 6 (a): at cache_len 24 > window 8 the reference's prefill
    gives the remainder group (2, 1, 24, 1, 64) keys and its
    ``init_decode_state`` (2, 1, 8, 1, 64), so its engine raises at its
    first admission. The port's prefill state has the shapes of its
    ``init_decode_state``, and its engine serves."""
    arch, cache_len = ARCHS[0], 24
    cfg, model, params, (jcfg, jparams) = _load(arch)
    jmodel, jp = JLM(jcfg), jax.tree.map(jnp.asarray, jparams)
    prompt = _prompts(cfg.vocab, (13,), seed=4)[0]
    _, jstate = jax.jit(jmodel.prefill, static_argnames="cache_len")(
        jp, {"inputs": jnp.asarray([prompt], jnp.int32)}, cache_len=cache_len)
    jzero = jmodel.init_decode_state(1, cache_len)
    assert [g.kind for g in jmodel.groups] == ["dense_sb", "dense"]
    assert jstate["groups"][1]["k"].shape == (2, 1, 24, 1, 64)
    assert jzero["groups"][1]["k"].shape == (2, 1, 8, 1, 64)
    jengine = JServingEngine(jmodel, jp, max_batch=2, cache_len=cache_len)
    jengine.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=4))
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jengine.run()

    with torch.no_grad():
        _, state = model.prefill(params, {"inputs": torch.tensor([prompt])},
                                 cache_len=cache_len)
    zero = model.init_decode_state(1, cache_len, device="cpu")
    assert state["groups"][1]["k"].shape == (2, 1, 8, 1, 64)
    for got, want in zip(state["groups"], zero["groups"]):
        assert jax.tree.map(lambda a: tuple(a.shape), got) == jax.tree.map(
            lambda a: tuple(a.shape), want)
    req = Request(uid=0, prompt=prompt, max_new_tokens=6)
    engine = ServingEngine(model, params, max_batch=2, cache_len=cache_len)
    engine.submit(req)
    with torch.no_grad():
        engine.run()
    assert req.generated == _isolated_generate(model, params, prompt, 6,
                                               cache_len)[0]


@pytest.mark.parametrize("n", [5, 9, 20])
def test_reference_engine_padding_drops_the_prompt_from_the_ring(n):
    """Record 6 (b): at ``reduced(n_layers=6, window=8)`` (no remainder,
    so the reference's engine admits) and cache_len 40, the reference's
    engine pads an n-token prompt to its bucket (16 or 32), masks the
    padding and replays the last real token: the logits of that replay
    differ from an exact-length prefill's by more than ``PADDING_FAULT``
    of max |logit|, as the ring kept the padding in place of the prompt's
    last keys. The port's engine takes the exact-length prefill's."""
    arch, cache_len = ARCHS[0], 40
    cfg, model, params, (jcfg, jparams) = _load(arch, n_layers=6, window=8)
    assert _bucket(n) > cfg.window
    jmodel, jp = JLM(jcfg), jax.tree.map(jnp.asarray, jparams)
    prompt = _prompts(cfg.vocab, (n,), seed=5)[0]
    exact, _ = jax.jit(jmodel.prefill, static_argnames="cache_len")(
        jp, {"inputs": jnp.asarray([prompt], jnp.int32)}, cache_len=cache_len)
    exact = np.asarray(exact[0], np.float64)
    jengine = JServingEngine(jmodel, jp, max_batch=1, cache_len=cache_len)
    replayed = []
    decode = jengine._decode

    def spy(p, state, toks):
        logits, state = decode(p, state, toks)
        replayed.append(np.asarray(logits[0], np.float64))
        return logits, state
    jengine._decode = spy
    jengine.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=1))
    jengine.run()
    fault = np.abs(replayed[0] - exact).max() / np.abs(exact).max()
    assert fault > PADDING_FAULT, fault

    engine, rows = _spied_engine(model, params, max_batch=1,
                                 cache_len=cache_len)
    engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=1))
    with torch.no_grad():
        engine.run()
    got = rows[0][0].double().numpy()
    assert np.abs(got - exact).max() / np.abs(exact).max() <= TOL


def test_example_prints_a_smaller_rightsized_state():
    """``examples/long_context_decode_torch.py --context 64 --gen 4
    --device cpu``: every architecture runs, and gemma3-1b@rightsized's
    printed state is smaller than gemma3-1b's (its rings hold the window
    of 32, not the 68 slots of the context)."""
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "long_context_decode_torch.py")
    spec = importlib.util.spec_from_file_location("long_context_decode_torch",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sizes = example.main(["--context", "64", "--gen", "4",
                              "--device", "cpu"])
    printed = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\s*(\S+) ctx=.*state=\s*([0-9.]+)MB", out.getvalue(), re.M)}
    assert printed.keys() == sizes.keys() == set(example.ARCHS)
    assert printed["gemma3-1b@rightsized"] < printed["gemma3-1b"]
    assert sizes["gemma3-1b@rightsized"] < sizes["gemma3-1b"]
