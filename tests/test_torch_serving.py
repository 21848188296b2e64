"""The port's continuous-batching engine (``repro_torch.serving``) on the
CPU: its contract (each request's continuous-batched tokens equal its
isolated prefill + greedy decode), EOS, slot reuse, and token-for-token
agreement with ``repro.serving.ServingEngine`` on the same weights and
requests (reduced TinyLlama, float32).
"""
import functools

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

CACHE_LEN = 64


def _isolated_generate(model, params, prompt, n_new, cache_len):
    """Oracle: exact-length prefill + greedy decode, one request alone."""
    toks = torch.tensor([prompt], dtype=torch.int64)
    logits, state = model.prefill(params, {"inputs": toks},
                                  cache_len=cache_len)
    state["index"] = torch.tensor([len(prompt)], dtype=torch.int32)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(n_new - 1):
        logits, state = model.decode_step(params, state,
                                          torch.tensor([[out[-1]]]))
        out.append(int(torch.argmax(logits[0])))
    return out


@functools.cache
def _load(arch):
    jcfg = jget_config(arch).reduced()
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    return cfg, LM(cfg), params, (jcfg, jparams)


@pytest.fixture(scope="module", params=["tinyllama-1.1b", "gemma3-1b"])
def setup(request):
    return _load(request.param)


def _requests(cls, cfg, seed=0, lengths=(5, 16, 9, 12, 7),
              n_new=(4, 6, 5, 3, 6)):
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, size=n)]
               for n in lengths]
    return [cls(uid=i, prompt=p, max_new_tokens=k)
            for i, (p, k) in enumerate(zip(prompts, n_new))]


def test_continuous_batching_matches_isolated(setup):
    cfg, model, params, _ = setup
    engine = ServingEngine(model, params, max_batch=2, cache_len=CACHE_LEN)
    reqs = _requests(Request, cfg)
    for r in reqs:
        engine.submit(r)
    engine.run()
    for r in reqs:
        want = _isolated_generate(model, params, r.prompt, r.max_new_tokens,
                                  CACHE_LEN)
        assert r.done
        assert r.generated == want, (r.uid, r.generated, want)


def test_eos_stops_early(setup):
    cfg, model, params, _ = setup
    rng = np.random.default_rng(1)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab, size=8)]
    ref = _isolated_generate(model, params, prompt, 6, CACHE_LEN)
    eos = ref[1]
    engine = ServingEngine(model, params, max_batch=1, cache_len=CACHE_LEN)
    req = Request(uid=0, prompt=prompt, max_new_tokens=6, eos_id=eos)
    engine.submit(req)
    engine.run()
    assert req.done
    assert req.generated == ref[: ref.index(eos) + 1]


def test_slots_reused_under_queue_pressure(setup):
    cfg, model, params, _ = setup
    rng = np.random.default_rng(2)
    engine = ServingEngine(model, params, max_batch=2, cache_len=CACHE_LEN)
    reqs = [Request(uid=i, prompt=[int(t) for t in
                                   rng.integers(0, cfg.vocab, size=6)],
                    max_new_tokens=2) for i in range(6)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    assert all(len(r.generated) == 2 for r in reqs)
    assert not engine.active.any() and engine.slots == [None, None]


def test_buckets():
    assert [_bucket(n) for n in (1, 16, 17, 100, 128, 2000)] == [
        16, 16, 32, 128, 128, 2048]


def test_engine_tokens_equal_the_reference_engine():
    cfg, model, params, (jcfg, jparams) = _load("tinyllama-1.1b")
    lengths, n_new = (5, 16, 9, 40, 7, 3), (4, 6, 5, 3, 6, 2)
    reqs = _requests(Request, cfg, 3, lengths, n_new)
    jreqs = _requests(JRequest, cfg, 3, lengths, n_new)
    engine = ServingEngine(model, params, max_batch=2, cache_len=CACHE_LEN)
    jengine = JServingEngine(JLM(jcfg), jax.tree.map(jnp.asarray, jparams),
                             max_batch=2, cache_len=CACHE_LEN)
    for r, jr in zip(reqs, jreqs):
        engine.submit(r)
        jengine.submit(jr)
    engine.run()
    jengine.run()
    for r, jr in zip(reqs, jreqs):
        assert r.done and jr.done
        assert r.generated == jr.generated, (r.uid, r.generated, jr.generated)
