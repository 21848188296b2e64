"""The port's cross-attention LM families (``repro_torch.models.lm`` with
the ``vlm`` and ``dec`` group kinds and whisper's encoder) against
``repro.models.lm`` on the CPU.

Configs: ``whisper-tiny`` ``.reduced()`` (a 2-layer encoder over 32
frames, 2 ``dec`` units, d 256, 4 heads of 64 on 2 KV heads, GeGLU,
tied embeddings) and ``llama-3.2-vision-90b`` ``.reduced()`` (one
``vlm`` super-block of 2 self layers and a cross layer over 16 vision
tokens of 64, untied head) and ``.reduced(n_layers=6)`` (two
super-blocks). The reference's parameters are drawn once with JAX, their
zero leaves replaced by seeded numpy noise so those paths carry weight,
and carried across by ``lm_params_from_numpy``; the JAX side is jitted.

The vlm's gates: the reference starts ``gate`` and ``gate_mlp`` at zero,
and tanh(0) = 0 keeps the vision memory from every output (ROADMAP
section 3, record 5). Every vlm comparison here replaces them with
values drawn from the test's numpy seed, of magnitude 0.5 to 1.5, and
``test_the_memory_moves_the_logits`` shows the memory reaching the
logits then, and not at the reference's init.

Tolerances, each output's largest |error| over its largest |value|:
``TOL`` = 1e-4 in float32 (the products sum in other orders than
XLA's), ``BF16_TOL`` = 2e-2 in bfloat16 (the two sides round
activations at other places). Decode is teacher-forced with the
reference's tokens, so one near-tie cannot cascade; greedy generation
compares tokens and holds every step's top-2 logit margin above the
float32 error. ``LM.loss`` and its gradients are in
``test_torch_train_cross.py``.
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
from repro_torch.models import lm as tlm

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

# case -> (arch, its reduced() overrides)
CASES = {"whisper": ("whisper-tiny", ()),
         "vision": ("llama-3.2-vision-90b", ()),
         "vision6": ("llama-3.2-vision-90b", (("n_layers", 6),))}
TOL = 1e-4
BF16_TOL = 2e-2
GATES = ("gate", "gate_mlp")


def _close(got, want, tol=TOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _paths(tree):
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dtype_name(x):
    return (str(x.dtype).split(".")[-1] if isinstance(x, torch.Tensor)
            else np.dtype(x.dtype).name)


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else TOL


def _noisy(params, rng):
    """Zero leaves replaced by 0.1 N(0, 1) noise, then the vlm's gates by
    +-U(0.5, 1.5)."""
    def leaf(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path).split("'")[-2]
        if name in GATES:
            mag = rng.uniform(0.5, 1.5, a.shape)
            a = (mag * rng.choice([-1.0, 1.0], a.shape)).astype(a.dtype)
        elif not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, params)


def _configs(case, dtype="float32", remat=False):
    arch, over = CASES[case]
    over = dict(over, remat=remat)
    jover, tover = dict(over), dict(over)
    if dtype == "bfloat16":
        jover.update(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
        tover.update(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    return (jget_config(arch).reduced(**jover),
            get_config(arch).reduced(**tover))


@functools.cache
def _model(case, dtype="float32", remat=False):
    """(jcfg, cfg, the reference's parameters as numpy, the same as the
    port's tensors)."""
    jcfg, cfg = _configs(case, dtype, remat)
    params = _noisy(jlm.LM(jcfg).init(jax.random.PRNGKey(0)),
                    np.random.default_rng(0))
    return (jcfg, cfg, params,
            interop.lm_params_from_numpy(params, cfg, device="cpu"))


def _jp(params):
    return jax.tree.map(jnp.asarray, params)


def _batch(cfg, b, t, seed, *, memory_seed=None):
    """Token ids (B, T) and the family's memory input, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"inputs": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    mrng = rng if memory_seed is None else np.random.default_rng(memory_seed)
    if cfg.family == "vlm":
        batch["vision"] = mrng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    else:
        batch["audio_frames"] = mrng.standard_normal(
            (b, cfg.audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.cache
def _jit_prefill(jcfg, cache_len):
    return jax.jit(lambda p, b: jlm.LM(jcfg).prefill(p, b,
                                                     cache_len=cache_len))


@functools.cache
def _jit_decode(jcfg):
    return jax.jit(jlm.LM(jcfg).decode_step)


# ---------------------------------------------------------------------------
# the group plan and the parameter tree
# ---------------------------------------------------------------------------

def test_group_plans():
    plans = {"whisper-tiny": [("dec", 4)],
             "llama-3.2-vision-90b": [("vlm", 20)]}
    for arch, want in plans.items():
        assert [(g.kind, g.n) for g in tlm.LM(get_config(arch)).groups] == want
    for case, n in (("vision", 1), ("vision6", 2), ("whisper", 2)):
        cfg = _configs(case)[1]
        assert [(g.kind, g.n) for g in tlm.LM(cfg).groups] == [
            ("vlm" if cfg.family == "vlm" else "dec", n)]
    with pytest.raises(ValueError, match="multiple of cross_attn_every"):
        tlm.LM(get_config("llama-3.2-vision-90b").reduced(n_layers=4))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_reference(case, dtype):
    """Names, shapes and dtypes of ``LM.init`` (the vlm's two-level self
    stack, its (n,) gates, whisper's encoder stack) and of the reference's
    tree through ``lm_params_from_numpy``, which carries every value."""
    jcfg, cfg, params, tparams = _model(case, dtype)
    want = _paths(params)
    init = tlm.LM(cfg).init(torch.Generator().manual_seed(0))
    got = _paths(init)
    crossed = _paths(tparams)
    assert got.keys() == want.keys() == crossed.keys()
    for path, w in want.items():
        assert _dtype_name(w) == dtype, path
        for tree in (got, crossed):
            assert tuple(tree[path].shape) == w.shape, path
            assert _dtype_name(tree[path]) == _dtype_name(w), path
        np.testing.assert_array_equal(crossed[path].float().numpy(),
                                      np.asarray(w, np.float32))
    if cfg.family == "vlm":
        per, n = cfg.cross_attn_every, cfg.n_layers // (cfg.cross_attn_every
                                                        + 1)
        assert init["group0"]["self"]["attn"]["wq"].shape[:2] == (n, per)
        for name in GATES:  # zero at init, as the reference's
            assert init["group0"]["cross"][name].shape == (n,)
            assert not init["group0"]["cross"][name].any()
        assert init["vision_proj"].shape == (cfg.vision_dim, cfg.d_model)
    else:
        assert init["encoder"]["attn"]["wq"].shape[0] == cfg.encoder_layers


# ---------------------------------------------------------------------------
# whisper's encoder
# ---------------------------------------------------------------------------

@functools.cache
def _jit_encoder(jcfg):
    return jax.jit(lambda p, f: jlm.LM(jcfg)._encode_audio(p, f))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_the_reference(dtype):
    jcfg, cfg, params, tp = _model("whisper", dtype)
    frames = _batch(cfg, 3, 4, 1)["audio_frames"]
    want = _jit_encoder(jcfg)(_jp(params),
                              jnp.asarray(frames).astype(jcfg.dtype))
    with torch.no_grad():
        got = tlm.LM(cfg)._encode_audio(tp,
                                        torch.from_numpy(frames).to(cfg.dtype))
    assert got.dtype == cfg.dtype
    _close(got, want, _tol(dtype), "encoder")


def test_the_encoder_applies_rope_as_the_reference():
    """ROADMAP section 3, record 5: the reference's encoder passes
    ``theta=None``, which ``attn_full`` reads as ``cfg.rope_theta``, so
    its non-causal layers rotate q and k on top of the sinusoidal
    positions. The port follows it: its encoder equals the reference's,
    and differs from the same encoder with RoPE off (``rope_theta``
    None) by far more than the tolerance."""
    jcfg, cfg, params, tp = _model("whisper")
    frames = _batch(cfg, 2, 4, 2)["audio_frames"]
    want = np.asarray(_jit_encoder(jcfg)(_jp(params), jnp.asarray(frames)))
    x = torch.from_numpy(frames)
    with torch.no_grad():
        got = tlm.LM(cfg)._encode_audio(tp, x)
        no_rope = tlm.LM(dataclasses.replace(cfg, rope_theta=None))
        off = no_rope._encode_audio(tp, x)
    _close(got, want, TOL, "encoder")
    scale = np.abs(want).max()
    gap = float(np.abs(off.numpy() - want).max()) / scale
    assert gap > 100 * TOL, gap


# ---------------------------------------------------------------------------
# serving: prefill's logits and states, teacher-forced decode, generation
# ---------------------------------------------------------------------------

def _states_close(ts, js, tol, step):
    got, want = _paths(ts["groups"]), _paths(js["groups"])
    assert got.keys() == want.keys()
    assert {p.split("'")[-2] for p in want} == {"k", "v", "pos", "cross_k",
                                                "cross_v"}
    for path, w in want.items():
        assert _dtype_name(got[path]) == _dtype_name(w), path
        if path.endswith("['pos']"):
            np.testing.assert_array_equal(got[path].numpy(), w)
        else:
            _close(got[path], w, tol, f"{step} {path}")
    assert int(ts["index"]) == int(js["index"])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_teacher_forced_decode(case, dtype):
    """Prefill logits and every state leaf (self k, v, pos; cross_k,
    cross_v), then four decode steps on the reference's tokens, the
    states held again after them."""
    jcfg, cfg, params, tp = _model(case, dtype)
    jp, tol = _jp(params), _tol(dtype)
    batch = _batch(cfg, 2, 12, 5)
    jl, js = _jit_prefill(jcfg, 20)(jp, _j(batch))
    tl, ts = tlm.LM(cfg).prefill(tp, _t(batch), cache_len=20)
    _close(tl, jl, tol, "prefill logits")
    _states_close(ts, js, tol, "prefill")
    tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
    for i in range(4):
        jl, js = _jit_decode(jcfg)(jp, js, jnp.asarray(tok))
        tl, ts = tlm.LM(cfg).decode_step(tp, ts, torch.from_numpy(tok))
        _close(tl, jl, tol, f"decode {i} logits")
        tok = np.array(jnp.argmax(jl, axis=-1))[:, None]
    _states_close(ts, js, tol, "decode")


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_generation_matches_the_reference(case):
    """8 greedy tokens: the port's prefill + decode loop against the
    reference's prefill + ``decode_step`` loop, token for token, each
    step's top-2 margin above the float32 error."""
    jcfg, cfg, params, tp = _model(case)
    jp = _jp(params)
    batch = _batch(cfg, 3, 10, 6)
    jl, js = _jit_prefill(jcfg, 18)(jp, _j(batch))
    model = tlm.LM(cfg)
    with torch.no_grad():
        tl, ts = model.prefill(tp, _t(batch), cache_len=18)
    want, got = [], []
    for step in range(8):
        if step:
            jl, js = _jit_decode(jcfg)(jp, js, jnp.asarray(want[-1])[:, None])
            with torch.no_grad():
                tl, ts = model.decode_step(tp, ts, got[-1][:, None])
        top2 = np.sort(np.asarray(jl), axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3, step
        want.append(np.asarray(jnp.argmax(jl, axis=-1)))
        got.append(torch.argmax(tl, dim=-1))
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  np.stack(want, 1))


@pytest.mark.parametrize("case", list(CASES))
def test_init_decode_state_matches_the_reference(case):
    jcfg, cfg, _, _ = _model(case, "bfloat16")
    want = _paths(jlm.LM(jcfg).init_decode_state(3, 40, index=5)["groups"])
    state = tlm.LM(cfg).init_decode_state(3, 40, index=5, device="cpu")
    got = _paths(state["groups"])
    assert got.keys() == want.keys() and int(state["index"]) == 5
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert _dtype_name(got[path]) == _dtype_name(w), path
        np.testing.assert_array_equal(got[path].float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("case", ["whisper", "vision6"])
def test_the_memory_moves_the_logits(case):
    """Two memories give prefill logits that differ by far more than the
    tolerance, on both sides, with the test's gates; at the reference's
    own init the vision memory moves nothing, on both sides (its gates
    are zero), while whisper's encoder output always reaches the
    decoder."""
    jcfg, cfg, params, tp = _model(case)
    a, b = (_batch(cfg, 2, 9, 7, memory_seed=s) for s in (8, 9))
    ja, jb = (np.asarray(_jit_prefill(jcfg, 9)(_jp(params), _j(x))[0])
              for x in (a, b))
    with torch.no_grad():
        ta, tb = (tlm.LM(cfg).prefill(tp, _t(x))[0].numpy() for x in (a, b))
    scale = np.abs(ja).max()
    assert np.abs(ja - jb).max() > 100 * TOL * scale
    assert np.abs(ta - tb).max() > 100 * TOL * scale
    _close(ta, ja, TOL)
    _close(tb, jb, TOL)
    init = jlm.LM(jcfg).init(jax.random.PRNGKey(0))
    tinit = interop.lm_params_from_numpy(jax.tree.map(np.asarray, init), cfg,
                                         device="cpu")
    ja, jb = (np.asarray(_jit_prefill(jcfg, 9)(init, _j(x))[0])
              for x in (a, b))
    with torch.no_grad():
        ta, tb = (tlm.LM(cfg).prefill(tinit, _t(x))[0].numpy()
                  for x in (a, b))
    if cfg.family == "vlm":
        assert np.array_equal(ja, jb) and np.array_equal(ta, tb)
    else:
        assert np.abs(ja - jb).max() > 100 * TOL * np.abs(ja).max()
        assert np.abs(ta - tb).max() > 100 * TOL * np.abs(ja).max()


def test_a_missing_memory_raises():
    _, cfg, _, tp = _model("vision")
    model = tlm.LM(cfg)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(KeyError, match="vision"):
        model.prefill(tp, {"inputs": toks})
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="'vlm' group attends over a memory"):
        model._backbone(tp, x)
