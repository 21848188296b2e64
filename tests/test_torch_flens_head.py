"""The FLeNS head (``repro_torch.optim.flens_head``) against the
reference's on the CPU: features of a reduced TinyLlama backbone (the
reference's parameters carried across), the head problem, and FLeNS,
FedAvg and FedNewton rounds on the same features.

Features are float32 sums in other orders than XLA's: held to 1e-4 of
their largest |value|. The rounds run on the reference's head problem
handed over as numpy (its iid permutation is a JAX draw), FLeNS with the
reference's per-round sketches injected (``test_torch_flens.injected``),
and are held to the FLeNS tests' tolerance: loss rtol 1e-9, gap rtol
1e-9 while above 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as jget_config
from repro.core.base import root_key as jax_root_key
from repro.models import lm as jlm
from repro.optim import extract_features as jextract
from repro.optim import flens_head_init as jhead_init
from repro.optim import flens_head_update as jhead_update
from repro.optim import head_problem as jhead_problem
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import make_optimizer, newton_solve, run_rounds
from repro_torch.models import lm as tlm
from repro_torch.optim import (
    extract_features,
    flens_head_init,
    flens_head_update,
    head_problem,
)

from _torch_threads import worker_threads
from test_torch_flens import ROUNDS, SEED, injected

torch.set_num_threads(worker_threads())

M_CLIENTS, N_PER_CLIENT, SEQ, K = 4, 24, 16, 32


@pytest.fixture(scope="module")
def features():
    """({pool: (reference features, port features)}, labels) of the
    example's private client data on a reduced backbone (d 128, vocab
    256); a pool the function does not know raises."""
    overrides = dict(d_model=128, vocab=256)
    jcfg = jget_config("tinyllama-1.1b").reduced(**overrides)
    cfg = get_config("tinyllama-1.1b").reduced(**overrides)
    jmodel, tmodel = jlm.LM(jcfg), tlm.LM(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(M_CLIENTS * N_PER_CLIENT, SEQ))
    labels = np.where((toks < 8).sum(axis=1) >= 2, 1.0, -1.0)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = interop.lm_params_from_numpy(params, cfg, device="cpu")
    out = {}
    for pool in ("mean", "last"):
        want = jax.jit(lambda p, t: jextract(jmodel, p, t, pool=pool))(
            jparams, jnp.asarray(toks, jnp.int32))
        got = extract_features(tmodel, tparams,
                               torch.tensor(toks, dtype=torch.int32),
                               pool=pool)
        out[pool] = (np.asarray(want), got)
    with pytest.raises(ValueError):
        extract_features(tmodel, tparams, torch.zeros(1, 2, dtype=torch.int32),
                         pool="max")
    return out, labels


def test_features_match_reference(features):
    feats, _ = features
    for pool, (want, got) in feats.items():
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4, (pool, err)


def test_head_problem_partitions_the_features(features):
    feats, labels = features
    got = feats["mean"][1]
    prob = head_problem(got, torch.tensor(labels), M_CLIENTS, lam=1e-3)
    assert prob.X.dtype == torch.float64 and prob.m == M_CLIENTS
    assert prob.dim == got.shape[1] and prob.lam == 1e-3
    rows = prob.X[prob.mask > 0]
    assert rows.shape == (len(labels), got.shape[1])
    # every feature row once, with its label (the split is a permutation)
    order = torch.argsort(rows[:, 0])
    want = torch.argsort(got[:, 0].double())
    assert torch.equal(rows[order], got.double()[want])
    assert torch.equal(prob.y[prob.mask > 0][order],
                       torch.tensor(labels)[want])


def _head_pair(features):
    feats, labels = features
    jfeats = jnp.asarray(feats["mean"][0])
    jp = jhead_problem(jfeats, jnp.asarray(labels), M_CLIENTS, lam=1e-3)
    tp = interop.problem_from_numpy(np.asarray(jp.X), np.asarray(jp.y),
                                    np.asarray(jp.mask), jp.lam, "logistic",
                                    device="cpu")
    jw0 = jnp.zeros((jp.dim,), jnp.float64)
    tw0 = torch.zeros(tp.dim, dtype=torch.float64)
    return (jp, jw0, jcore.newton_solve(jp, jw0, iters=40)), \
        (tp, tw0, newton_solve(tp, tw0, iters=40))


@pytest.mark.parametrize("name,kw", [("flens", dict(k=K)),
                                     ("fedavg", dict(lr=1.0, local_steps=5)),
                                     ("fednewton", {})])
def test_head_rounds_match_reference(features, name, kw):
    (jp, jw0, jw_star), (tp, tw0, tw_star) = _head_pair(features)
    np.testing.assert_allclose(tw_star.numpy(), np.asarray(jw_star),
                               rtol=0, atol=1e-8)
    jh = jcore.run_rounds(jcore.make_optimizer(name, **kw), jp, jw0, jw_star,
                          rounds=ROUNDS, seed=SEED)
    tkw = dict(kw, sketch=injected("srht")) if name == "flens" else kw
    th = run_rounds(make_optimizer(name, **tkw), tp, tw0, tw_star,
                    rounds=ROUNDS, seed=SEED)
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-9, atol=0)
    live = jh.gap > 1e-10
    np.testing.assert_allclose(th.gap[live], jh.gap[live], rtol=1e-9)
    assert th.gap[-1] < th.gap[0]
    assert th.uplink_floats == jh.uplink_floats


def test_head_init_and_update_match_reference(features):
    (jp, _, _), (tp, _, _) = _head_pair(features)
    jopt, js = jhead_init(jp, k=K)
    topt, ts = flens_head_init(tp, k=K, sketch=injected("srht"))
    assert ts["w"].dtype == torch.float64 and not ts["w"].any()
    key = jax.random.split(jax_root_key(SEED), ROUNDS)[0]
    js1 = jax.jit(lambda s, k: jhead_update(jopt, jp, s, k))(js, key)
    ts1 = flens_head_update(topt, tp, ts, None)  # the policy draws keys[0]
    for name in ("w", "loss"):
        np.testing.assert_allclose(ts1[name].numpy(), np.asarray(js1[name]),
                                   rtol=1e-10, atol=1e-14, err_msg=name)
