"""The port's right-sized caches (``cache_mode="rightsized"``: the
``dense_sb`` group kind and the ring caches of ``repro_torch.models.lm``)
against ``repro.models.lm`` on the CPU.

Configs: ``gemma3-1b@rightsized`` and ``gemma3-4b@rightsized`` at
``reduced()`` (2 layers, ``local_per_global`` 2, window 32: a ``dense_sb``
group of 0 super-blocks and a remainder ``dense`` group of 2),
``reduced(n_layers=6, window=8)`` (two super-blocks of 2 local units and
a global one, no remainder) and ``reduced(n_layers=8, window=8)`` (two
super-blocks and a remainder of 2), in float32, and the last of
gemma3-4b's in bfloat16. The reference's parameters are drawn once with
JAX, their zero leaves replaced by seeded numpy noise so those paths
carry weight, and carried across by ``lm_params_from_numpy``; the JAX
side is jitted.

Tolerances, each output's largest |error| over its largest |value|:
``TOL`` = 1e-4 in float32 (the matmuls sum in other orders than XLA's),
``BF16_TOL`` = 2e-2 in bfloat16 (the two sides round activations at
other places). A bfloat16 gradient is far from the float32 one on both
sides: the output projections' (``wo``, ``w_down``, ahead of gemma3's
post-norms) carry most of it, and the whole gradient as one vector is
2.06% of its norm from the reference's own float32 gradient at
``sb+rem`` (2.15% for the port's). So the bfloat16 gradients are held
against the reference's float32 gradient on the same bfloat16 weights:
the port's error, as one vector by its norm, within ``BF16_GRAD_MARGIN``
= 1.1 times the reference's bfloat16 error. Cache positions are held
exactly. The K and
V the two packages compute differ in their last bits (XLA's matmuls and
torch's sum in other orders), so the ring's layout is held bit-equal
inside the port, against the uniform twin's cache on restacked
parameters (slot p % S of the ring against slot p), and its values
against the reference's within ``TOL``.

The reference's prefill gives the remainder ``dense`` group a cache of
``cache_len`` slots where its ``init_decode_state`` gives it a ring of
``min(window, cache_len)``; the port's prefill gives it the ring (ROADMAP
section 3, record 6), which is held against the reference's full cache
slot p % S against slot p for every position it keeps. Decode is
teacher-forced with the reference's tokens, so one near-tie cannot
cascade.
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
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.tree import leaves

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

TOL = 1e-4
BF16_TOL = 2e-2
BF16_GRAD_MARGIN = 1.1
GEMMAS = ("gemma3-1b@rightsized", "gemma3-4b@rightsized")
# reduced() overrides: the zero-unit super-block group, super-blocks alone,
# super-blocks and a remainder
CUTS = {"reduced": (), "sb": (("n_layers", 6), ("window", 8)),
        "sb+rem": (("n_layers", 8), ("window", 8))}
PLANS = {"reduced": [("dense_sb", 0), ("dense", 2)], "sb": [("dense_sb", 2)],
         "sb+rem": [("dense_sb", 2), ("dense", 2)]}
CASES = [(arch, cut) for arch in GEMMAS for cut in CUTS]


def _close(got, want, tol=TOL, what="", norm=False):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:  # a group of 0 super-blocks
        return
    if norm:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    else:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _noisy(params, rng):
    def leaf(a):
        a = np.asarray(a)
        if not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(leaf, params)


def _cfgs(arch, cut, dtype="float32", **over):
    over = dict(CUTS[cut], **over)
    jover, tover = dict(over), dict(over)
    if dtype == "bfloat16":
        jover.update(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
        tover.update(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    return jget_config(arch).reduced(**jover), get_config(arch).reduced(**tover)


@functools.cache
def _model(arch, cut, dtype="float32", remat=False):
    """(jcfg, cfg, the reference's parameters as numpy, the same as the
    port's tensors)."""
    jcfg, cfg = _cfgs(arch, cut, dtype, remat=remat)
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


def _to_uniform(cfg, params):
    """The uniform twin of a right-sized model on the same weights: its
    config and the parameters restacked into one (L, ...) dense group, in
    layer order (each super-block's local units, then its global unit,
    then the remainder's units)."""
    ucfg = dataclasses.replace(cfg, cache_mode="uniform")
    sb = params["group0"]
    per = cfg.local_per_global

    def restack(loc, glob, *rest):
        blocks = torch.cat([loc, glob[:, None]], dim=1).flatten(0, 1)
        return torch.cat([blocks, *rest])
    rest = [params["group1"]] if "group1" in params else []
    group = jax.tree.map(restack, sb["loc"], sb["glob"], *rest)
    assert leaves(group)[0].shape[0] == cfg.n_layers
    assert sb["loc"]["ln1"]["scale"].shape[1] == per
    out = {name: a for name, a in params.items()
           if not name.startswith("group")}
    return ucfg, {**out, "group0": group}


def _uniform_layer(cfg, i, j=None):
    """The uniform twin's layer index of super-block ``i``'s local unit
    ``j`` (its global unit with ``j`` None)."""
    per = cfg.local_per_global
    return i * (per + 1) + (per if j is None else j)


# ---------------------------------------------------------------------------
# the group plan, the parameter tree, the decode state's shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,cut", CASES)
def test_group_plan_matches_the_reference(arch, cut):
    jcfg, cfg = _cfgs(arch, cut)
    got, want = tlm.LM(cfg).groups, jlm.LM(jcfg).groups
    assert [(g.kind, g.n) for g in got] == PLANS[cut]
    assert [(g.kind, g.n) for g in want] == PLANS[cut]
    for g, w in zip(got, want):
        if w.windows is not None:
            assert list(g.windows) == np.asarray(w.windows).tolist()
            np.testing.assert_array_equal(np.float32(g.thetas),
                                          np.asarray(w.thetas))
    assert [(g.kind, g.n) for g in tlm.LM(get_config(arch)).groups] == (
        [("dense_sb", 4), ("dense", 2)] if arch.startswith("gemma3-1b")
        else [("dense_sb", 5), ("dense", 4)])


@pytest.mark.parametrize("arch,cut,dtype",
                         [(a, c, "float32") for a, c in CASES]
                         + [(GEMMAS[1], "sb+rem", "bfloat16")])
def test_init_tree_matches_the_reference(arch, cut, dtype):
    """Names, shapes and dtypes of ``LM.init`` (the ``{"loc", "glob"}``
    super-block tree) and of the reference's tree through
    ``lm_params_from_numpy``, whose values cross unchanged."""
    jcfg, cfg, params, tparams = _model(arch, cut, dtype)
    want = _paths(params)
    got = _paths(tlm.LM(cfg).init(torch.Generator().manual_seed(0)))
    crossed = _paths(tparams)
    assert got.keys() == want.keys() == crossed.keys()
    assert any("['loc']" in path for path in want)
    for path, w in want.items():
        for tree in (got, crossed):
            assert tuple(tree[path].shape) == w.shape, path
            assert _dtype_name(tree[path]) == _dtype_name(w) == dtype, path
        np.testing.assert_array_equal(crossed[path].float().numpy(),
                                      np.asarray(w, np.float32))


def _state_shapes_match(jcfg, cfg, batch, cache_len):
    jmodel = jlm.LM(jcfg)  # its group plan's windows concrete, not traced
    want = _paths(jax.eval_shape(
        lambda: jmodel.init_decode_state(batch, cache_len)))
    got = _paths(tlm.LM(cfg).init_decode_state(batch, cache_len,
                                               device="meta"))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, (path, got[path].shape,
                                                   w.shape)
        assert _dtype_name(got[path]) == _dtype_name(w), path
    return got


@pytest.mark.parametrize("arch,cut", CASES + [
    ("recurrentgemma-2b@rightsized", None)])
@pytest.mark.parametrize("cache_len", [24, 64])
def test_init_decode_state_matches_the_reference(arch, cut, cache_len):
    """Every leaf's shape and dtype, and the values (zeros, pos -1): the
    local rings and the remainder's ring of min(window, cache_len) slots,
    griffin's attention's ring too."""
    if cut is None:
        jcfg = jget_config(arch).reduced(n_layers=5)
        cfg = get_config(arch).reduced(n_layers=5)
    else:
        jcfg, cfg = _cfgs(arch, cut)
    _state_shapes_match(jcfg, cfg, 3, cache_len)
    want = _paths(jlm.LM(jcfg).init_decode_state(3, cache_len, index=5))
    state = tlm.LM(cfg).init_decode_state(3, cache_len, index=5, device="cpu")
    got = _paths(state)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].float().numpy(),
                                      np.asarray(w, np.float32))
    ring = min(cfg.window, cache_len)
    k_slots = {path: leaf.shape[-3] for path, leaf in got.items()
               if path.endswith("['k']")}
    for path, slots in k_slots.items():
        assert slots == (cache_len if "['glob']" in path else ring), path


@pytest.mark.parametrize("arch,cache_len", [
    ("gemma3-1b@rightsized", 32_768), ("gemma3-4b@rightsized", 131_072),
    ("recurrentgemma-2b@rightsized", 32_768)])
def test_full_size_decode_state_shapes_match_the_reference(arch, cache_len):
    """The published configs at their contexts (shapes only): the right-
    sized state is a fraction of the uniform one."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    got = _state_shapes_match(jcfg, cfg, 4, cache_len)
    uniform = tlm.LM(dataclasses.replace(cfg, cache_mode="uniform"))
    size = sum(a.numel() * a.element_size() for a in got.values())
    usize = sum(a.numel() * a.element_size() for a in _paths(
        uniform.init_decode_state(4, cache_len, device="meta")).values())
    assert size < 0.2 * usize, (size, usize)


# ---------------------------------------------------------------------------
# serving: prefill's logits and caches, decode past the window
# ---------------------------------------------------------------------------

def _remainder_ring_close(ring, full, t, tol, what, norm=False):
    """A ring of S slots (the port's) against a full cache (the
    reference's prefill) of one group: slot p % S against slot p for every
    position p < t the ring keeps, and pos -1 elsewhere."""
    s = ring["k"].shape[-3]
    kept = range(max(0, t - s), t)
    pos = ring["pos"].numpy()
    want_pos = np.full(pos.shape, -1, np.int32)
    for p in kept:
        want_pos[..., p % s] = p
    np.testing.assert_array_equal(pos, want_pos, what)
    for name in ("k", "v"):
        got = np.stack([ring[name][:, :, p % s].float().numpy()
                        for p in kept], axis=2)
        want = np.stack([np.asarray(jnp.asarray(full[name], jnp.float32))
                         [:, :, p] for p in kept], axis=2)
        _close(got, want, tol, f"{what} {name}", norm)


def _caches_close(ts, js, t, tol, what, norm=False):
    """Every ``dense_sb`` leaf (pos exactly, k and v within ``tol``, by
    their largest error or with ``norm`` by their error's norm), and a
    remainder group's ring against the reference's full cache."""
    sb_got, sb_want = _paths(ts["groups"][0]), _paths(js["groups"][0])
    assert sb_got.keys() == sb_want.keys()
    for path, w in sb_want.items():
        assert tuple(sb_got[path].shape) == w.shape, path
        assert _dtype_name(sb_got[path]) == _dtype_name(w), path
        if path.endswith("['pos']"):
            np.testing.assert_array_equal(sb_got[path].numpy(), w, path)
        else:
            _close(sb_got[path], w, tol, f"{what} {path}", norm)
    if len(ts["groups"]) > 1:
        _remainder_ring_close(ts["groups"][1], js["groups"][1], t, tol,
                              f"{what} remainder", norm)


def _prompts(cfg):
    """A prompt shorter than the window and one longer (n_keep < t)."""
    return (5, 13) if cfg.window == 8 else (20, 40)


@pytest.mark.parametrize("arch,cut,dtype",
                         [(a, c, "float32") for a, c in CASES]
                         + [(GEMMAS[1], "sb+rem", "bfloat16")])
@pytest.mark.parametrize("which", [0, 1])
def test_prefill_and_decode_past_the_window(arch, cut, dtype, which):
    """Prefill logits and caches, then window + 6 teacher-forced decode
    steps (the rings wrap), logits at each step and the caches at the
    end; in bfloat16 the caches after decode are held by their error's
    norm (each leaf one vector: the keys the steps wrote come through
    every layer of both sides' bfloat16 roundings)."""
    jcfg, cfg, params, tp = _model(arch, cut, dtype)
    t = _prompts(cfg)[which]
    steps = cfg.window + 6
    cache_len = t + steps + 2
    jp, tol = _jp(params), _tol(dtype)
    toks = _tokens(cfg.vocab, (2, t), 5 + t)
    jm, tm = jlm.LM(jcfg), tlm.LM(cfg)
    jl, js = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"inputs": jnp.asarray(toks)}, cache_len=cache_len)
    with torch.no_grad():
        tl, ts = tm.prefill(tp, {"inputs": torch.from_numpy(toks)},
                            cache_len=cache_len)
        _close(tl, jl, tol, "prefill logits")
        _caches_close(ts, js, t, tol, "prefill")
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
        decode = jax.jit(jm.decode_step)
        for i in range(steps):
            jl, js = decode(jp, js, jnp.asarray(tok))
            tl, ts = tm.decode_step(tp, ts, torch.from_numpy(tok))
            _close(tl, jl, tol, f"decode {i} logits")
            tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
    assert int(ts["index"]) == int(js["index"]) == t + steps
    _caches_close(ts, js, t + steps, tol, "decode", dtype == "bfloat16")


# ---------------------------------------------------------------------------
# training: LM.loss and its gradients
# ---------------------------------------------------------------------------

@functools.cache
def _jax_value_and_grad(arch, cut, dtype, remat):
    model = jlm.LM(_model(arch, cut, dtype, remat)[0])
    return jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b),
                                      has_aux=True))


def _loss_batch(vocab):
    toks = _tokens(vocab, (2, 25), 6)
    mask = (np.random.default_rng(7).random((2, 24)) < 0.8).astype(np.float32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _vector_err(got: dict, want: dict) -> float:
    """The norm of the error over the norm of ``want``, all leaves one
    vector."""
    err2 = ref2 = 0.0
    for path, w in want.items():
        w = np.asarray(jnp.asarray(w, jnp.float32), np.float64)
        g = got[path]
        g = np.asarray(g.float().numpy() if isinstance(g, torch.Tensor)
                       else jnp.asarray(g, jnp.float32), np.float64)
        err2 += float(np.sum((g - w) ** 2))
        ref2 += float(np.sum(w * w))
    return (err2 / ref2) ** 0.5


@pytest.mark.parametrize("arch,cut,remat", [
    (GEMMAS[0], "reduced", False), (GEMMAS[0], "sb+rem", False),
    (GEMMAS[1], "sb+rem", True)])
def test_loss_and_gradients_match_the_reference(arch, cut, remat):
    """float32: the loss and CE within 1e-5, every gradient leaf within
    ``TOL``."""
    _, cfg, params, tp = _model(arch, cut, "float32", remat)
    batch = _loss_batch(cfg.vocab)
    (jloss, jaux), jgrads = _jax_value_and_grad(arch, cut, "float32", remat)(
        _jp(params), {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = ttrain.loss_and_grads(
        tlm.LM(cfg), tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(loss, jloss, 1e-5, "loss")
    _close(metrics["ce"], jaux["ce"], 1e-5, "ce")
    want, got = _paths(jgrads), _paths(grads)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert _dtype_name(got[path]) == _dtype_name(w), path
        _close(got[path], w, TOL, f"grad {path}")


@pytest.mark.parametrize("arch", GEMMAS[1:])
def test_bfloat16_loss_and_gradients_match_the_reference(arch):
    """bfloat16 with remat at ``sb+rem``: the loss and CE within
    ``BF16_TOL`` of the reference's bfloat16 ones, the gradients against
    the reference's float32 gradients on the same (bfloat16) weights,
    within ``BF16_GRAD_MARGIN`` times the reference's bfloat16 error."""
    _, cfg, params, tp = _model(arch, "sb+rem", "bfloat16", True)
    batch = _loss_batch(cfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = _jax_value_and_grad(arch, "sb+rem", "bfloat16",
                                                True)(_jp(params), jbatch)
    weights32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    _, truth = _jax_value_and_grad(arch, "sb+rem", "float32", True)(
        _jp(weights32), jbatch)
    loss, metrics, grads = ttrain.loss_and_grads(
        tlm.LM(cfg), tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(loss, jloss, BF16_TOL, "loss")
    _close(metrics["ce"], jaux["ce"], BF16_TOL, "ce")
    got, want, truth = _paths(grads), _paths(jgrads), _paths(truth)
    assert got.keys() == want.keys() == truth.keys()
    for path, w in want.items():
        assert _dtype_name(got[path]) == _dtype_name(w) == "bfloat16", path
    port, ref = _vector_err(got, truth), _vector_err(want, truth)
    assert port <= BF16_GRAD_MARGIN * ref, (port, ref)


def test_remat_gives_the_same_gradients():
    """Per-super-block recomputation changes no value."""
    _, cfg, _, tp = _model(GEMMAS[1], "sb+rem")
    toks = torch.from_numpy(_tokens(cfg.vocab, (2, 25), 8))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    plain = ttrain.loss_and_grads(tlm.LM(cfg), tp, batch)
    remat = ttrain.loss_and_grads(
        tlm.LM(dataclasses.replace(cfg, remat=True)), tp, batch)
    assert torch.equal(plain[0], remat[0])
    for g, w in zip(leaves(remat[2]), leaves(plain[2])):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# right-sized against uniform inside the port (the reference's
# tests/test_rightsized_cache.py contract)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GEMMAS)
@pytest.mark.parametrize("which", [0, 1])
def test_rightsized_equals_uniform_on_restacked_parameters(arch, which):
    """The same weights as one (L, ...) dense group and as super-blocks:
    prefill logits and the loss bit-equal, every ring's slot p % S
    bit-equal to the uniform cache's slot p, then window + 6 decode steps
    within ``TOL`` (the rings hold the same keys in another slot order, so
    the softmax sums in another order)."""
    _, cfg, _, tp = _model(arch, "sb+rem")
    ucfg, up = _to_uniform(cfg, tp)
    rm, um = tlm.LM(cfg), tlm.LM(ucfg)
    assert [g.kind for g in um.groups] == ["dense"]
    t = _prompts(cfg)[which]
    steps = cfg.window + 6
    cache_len = t + steps + 2
    toks = torch.from_numpy(_tokens(cfg.vocab, (2, t), 11 + t)).long()
    with torch.no_grad():
        rl, rs = rm.prefill(tp, {"inputs": toks}, cache_len=cache_len)
        ul, us = um.prefill(up, {"inputs": toks}, cache_len=cache_len)
        assert torch.equal(rl, ul)
        s = min(cfg.window, cache_len)
        kept = range(max(0, t - s), t)
        loc, glob = rs["groups"][0]["loc"], rs["groups"][0]["glob"]
        full = us["groups"][0]
        for i in range(loc["k"].shape[0]):
            for j in range(cfg.local_per_global):
                li = _uniform_layer(cfg, i, j)
                for p in kept:
                    for name in ("k", "v"):
                        assert torch.equal(loc[name][i, j][:, p % s],
                                           full[name][li][:, p])
                    assert bool((loc["pos"][i, j][:, p % s] == p).all())
            gi = _uniform_layer(cfg, i)
            for name in ("k", "v", "pos"):
                assert torch.equal(glob[name][i], full[name][gi])
        rem = rs["groups"][1]
        n_sb = loc["k"].shape[0] * (cfg.local_per_global + 1)
        for r in range(rem["k"].shape[0]):
            for p in kept:
                for name in ("k", "v"):
                    assert torch.equal(rem[name][r][:, p % s],
                                       full[name][n_sb + r][:, p])
        tok = rl.argmax(-1, keepdim=True)
        for i in range(steps):
            rl, rs = rm.decode_step(tp, rs, tok)
            ul, us = um.decode_step(up, us, tok)
            _close(rl, ul.numpy(), TOL, f"decode {i}")
            tok = ul.argmax(-1, keepdim=True)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    rloss = ttrain.loss_and_grads(rm, tp, batch)[0]
    uloss = ttrain.loss_and_grads(um, up, batch)[0]
    assert torch.equal(rloss, uloss)
