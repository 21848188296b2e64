"""The port's MoE LM family (``repro_torch.models.lm`` with the ``moe``
group kind) against ``repro.models.lm`` on the CPU: the group plans, the
parameter tree, prefill and teacher-forced decode
(``tests/test_torch_train_moe.py`` holds ``LM.loss`` and its gradients).

Configs: ``arctic-480b`` ``.reduced()`` (a moe group of 2; each unit's
dense MLP beside the MoE, no shared expert) and ``kimi-k2-1t-a32b``
``.reduced(n_layers=3)`` (its dense first layer, then a moe group of 2
with a shared expert); 4 experts, top-2, capacity factor 1.25, so
prompts drop assignments. Two head layouts of the full models ride on
them: arctic's group of 7 query heads on one KV head, kimi's head dim
112. The reference's parameters are drawn once with JAX, their zero
leaves replaced by seeded numpy noise so those paths carry weight, and
carried across by ``lm_params_from_numpy``; the JAX side is jitted.

Tolerances, each output's largest |error| over its largest |value|:
``TOL`` = 1e-4 in float32, ``BF16_TOL`` = 2e-2 in bfloat16; in float32
every gradient leaf is held to ``TOL``, in bfloat16 the gradients as one
vector by the norm of their error over their norm (a leaf's bfloat16
gradient sits at the rounding's noise floor, as in the recurrent
families' tests). The auxiliary loss is held to ``AUX_TOL`` = 1e-5 in
float32 (a sum over the experts), to ``BF16_TOL`` in bfloat16 (its
router sees the bfloat16 activations each side rounds its own way).
Every moe layer's routing is compared too: the (token, slot) choices
and keeps on which the port and the reference differ are counted, and
none may differ at these seeds, in bfloat16 as in float32 (a flip moves
an output by far more than the tolerance). Decode is teacher-forced
with the reference's tokens, so one near-tie cannot cascade.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

from _torch_threads import worker_threads
from test_torch_moe import _reference_dispatch

torch.set_num_threads(worker_threads())

# arch -> its reduced() overrides: kimi at 3 layers, so that its moe
# group stacks two units beside the dense first layer
ARCHS = {"arctic-480b": (), "kimi-k2-1t-a32b": (("n_layers", 3),)}
# the full models' head layouts at the reduced widths
LAYOUTS = {"arctic group of 7": ("arctic-480b", (("n_heads", 7),
                                                 ("n_kv_heads", 1))),
           "kimi head dim 112": ("kimi-k2-1t-a32b", (("n_layers", 3),
                                                     ("d_head", 112)))}
TOL = 1e-4
BF16_TOL = 2e-2
AUX_TOL = 1e-5


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


@functools.cache
def _model(arch, dtype="float32", remat=False, over=None):
    """(jcfg, cfg, the reference's parameters as numpy, the same as the
    port's tensors); ``over`` the reduced() overrides (ARCHS' default)."""
    over = dict(ARCHS[arch] if over is None else over, remat=remat)
    jover, tover = dict(over), dict(over)
    if dtype == "bfloat16":
        jover.update(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
        tover.update(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
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


def _reference_routes(jcfg, params, toks):
    """The reference's routing of every moe layer of a prefill of
    ``toks``, walking its units: [(ids (B T, k), keep (B T k,))]."""
    model = jlm.LM(jcfg)
    x = jcommon.embed(params["embed"], toks, jcfg)
    b, t = toks.shape
    capacity = min(max(4, int(jcfg.capacity_factor * jcfg.top_k * b * t
                              / jcfg.n_experts)), b * t * jcfg.top_k)
    routes = []
    for gi, g in enumerate(model.groups):
        for i in range(g.n):
            p = jax.tree.map(lambda a: a[i], params[f"group{gi}"])
            kw = dict(window=g.windows[i], theta=g.thetas[i])
            if g.kind == "dense":
                x = jlm._dense_unit_apply(p, x, jcfg, **kw)
                continue
            h = jattn.attn_full(p["attn"], jcommon.rmsnorm(p["ln1"], x),
                                jcfg, **kw)
            normed = jcommon.rmsnorm(p["ln2"], x + h)
            ids = jmoe._route(p["moe"]["router"],
                              normed.reshape(b * t, -1), jcfg)[0]
            routes.append((ids, _reference_dispatch(
                ids, jcfg.n_experts, capacity)[1]))
            x = jlm._moe_unit_apply(p, x, jcfg, **kw)[0]
    return routes


def _flips(routes, want) -> "tuple[int, int]":
    """(token, slot) choices and keeps on which the port's recorded routes
    and the reference's differ, over every moe layer."""
    assert len(routes) == len(want)
    choices = keeps = 0
    for r, (ids, keep) in zip(routes, want):
        choices += int((r["ids"].numpy() != np.asarray(ids)).sum())
        keeps += int((r["keep"].numpy().reshape(-1)
                      != np.asarray(keep)).sum())
    return choices, keeps


# ---------------------------------------------------------------------------
# the group plan and the parameter tree
# ---------------------------------------------------------------------------

def test_group_plans_and_the_full_models_build():
    arctic, kimi = (tlm.LM(get_config(a)) for a in ARCHS)
    assert [(g.kind, g.n) for g in arctic.groups] == [("moe", 35)]
    assert [(g.kind, g.n) for g in kimi.groups] == [("dense", 1),
                                                    ("moe", 60)]
    assert not arctic.recurrent and not kimi.recurrent
    assert [(g.kind, g.n) for g in tlm.LM(_model(
        "kimi-k2-1t-a32b")[1]).groups] == [("dense", 1), ("moe", 2)]


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_reference(arch, dtype):
    """Names, shapes and dtypes of ``LM.init`` and of the reference's tree
    through ``lm_params_from_numpy``, stacked (n, E, D, F) expert leaves
    included; arctic's units carry ``dense_mlp``, kimi's ``moe/shared``."""
    jcfg, cfg, params, tparams = _model(arch, dtype)
    want = _paths(params)
    got = _paths(tlm.LM(cfg).init(torch.Generator().manual_seed(0)))
    crossed = _paths(tparams)
    assert got.keys() == want.keys() == crossed.keys()
    moe_group = "['group0']" if arch == "arctic-480b" else "['group1']"
    assert want[f"{moe_group}['moe']['w_gate']"].shape == (
        2, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert (f"{moe_group}['dense_mlp']['w_up']" in want) == (
        arch == "arctic-480b")
    assert (f"{moe_group}['moe']['shared']['w_up']" in want) == (
        arch == "kimi-k2-1t-a32b")
    for path, w in want.items():
        assert _dtype_name(w) == dtype, path
        for tree in (got, crossed):
            assert tuple(tree[path].shape) == w.shape, path
            assert _dtype_name(tree[path]) == _dtype_name(w), path
        np.testing.assert_array_equal(crossed[path].float().numpy(),
                                      np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# serving: prefill's logits and caches, teacher-forced decode
# ---------------------------------------------------------------------------

def _prefill_and_decode(arch, dtype, over=None, steps=4, drops=True):
    jcfg, cfg, params, tp = _model(arch, dtype, over=over)
    jp, tol = _jp(params), _tol(dtype)
    length = 9
    toks = _tokens(cfg.vocab, (2, length), 5)
    jm, tm = jlm.LM(jcfg), tlm.LM(cfg)
    jl, js = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"inputs": jnp.asarray(toks)}, cache_len=48)
    with tmoe.record_routes() as routes:
        tl, ts = tm.prefill(tp, {"inputs": torch.from_numpy(toks)},
                            cache_len=48)
    want_routes = jax.jit(functools.partial(_reference_routes, jcfg))(
        jp, jnp.asarray(toks))
    assert _flips(routes, want_routes) == (0, 0)
    if drops:
        assert any(not bool(r["keep"].all()) for r in routes), "no drop"
    _close(tl, jl, tol, "prefill logits")

    def caches_close(step):
        got, want = _paths(ts["groups"]), _paths(js["groups"])
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert _dtype_name(got[path]) == _dtype_name(w), path
            if path.endswith("['pos']"):
                np.testing.assert_array_equal(got[path].numpy(), w)
            else:
                _close(got[path], w, tol, f"{step} {path}")
        assert int(ts["index"]) == int(js["index"])
    caches_close("prefill")
    js["index"] = jnp.asarray([length, length - 3], jnp.int32)
    ts["index"] = torch.tensor([length, length - 3], dtype=torch.int32)
    tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
    decode = jax.jit(jm.decode_step)
    for i in range(steps):
        jl, js = decode(jp, js, jnp.asarray(tok))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(tok))
        _close(tl, jl, tol, f"decode {i} logits")
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
    for name in ("k", "v", "pos"):
        for gc, jgc in zip(ts["groups"], js["groups"]):
            if name == "pos":
                np.testing.assert_array_equal(gc[name].numpy(), jgc[name])
            else:
                _close(gc[name], jgc[name], tol, f"decode {name}")
    np.testing.assert_array_equal(ts["index"].numpy(),
                                  [length + steps, length - 3 + steps])


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_teacher_forced_decode(arch, dtype):
    """A 9-token prefill of 2 rows (18 tokens a moe call: capacity 11 of
    each expert for 36 assignments, so some drop) with no route differing
    from the reference's, its logits and every cache leaf; then 4 decode
    steps with rows at different positions."""
    _prefill_and_decode(arch, dtype)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_full_model_head_layouts(layout):
    """arctic's 7 query heads on one KV head and kimi's head dim 112,
    through prefill and decode in float32."""
    arch, over = LAYOUTS[layout]
    _prefill_and_decode(arch, "float32", over=over, steps=2, drops=False)


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


def test_prefill_refuses_a_short_cache():
    _, cfg, _, tp = _model("arctic-480b")
    with pytest.raises(ValueError, match="cache_len 8 < prompt length 9"):
        tlm.LM(cfg).prefill(tp, {"inputs": torch.zeros(1, 9, dtype=torch.int64)},
                            cache_len=8)
