"""Language-model assembly, the counterpart of ``repro.models.lm``.

A model is a sequence of layer groups; each group is a homogeneous stack
of units whose parameters are stacked along a leading layer axis, the
reference's (L, ...) layout, and run by a Python loop over the layers.
Per-layer metadata (gemma3's 5 local : 1 global windows and thetas) is
host ints and floats.

The group kinds ``dense``, ``moe`` (attention and a mixture of experts,
with arctic's dense MLP beside it), ``ssd`` (mamba2), ``rec`` and
``griffin`` (recurrentgemma's (rec, rec, attn) super-block), ``vlm``
(llama-3.2-vision's super-block of ``cross_attn_every`` self layers and
one tanh-gated cross-attention layer over the projected vision tokens)
and ``dec`` (whisper's decoder: self attention, cross attention over the
encoder's output, MLP; the encoder is a stack of ``enc`` units, dense
units run non-causal) are ported for serving (``init``, ``prefill``,
``init_decode_state``, ``decode_step``) and for training (``loss``,
whose backbone builds no cache and, with ``cfg.remat``, recomputes each
unit in the backward as the reference's ``jax.checkpoint`` does; a
griffin, vlm or dense_sb super-block is one unit). The loss adds 0.01
times the moe layers' auxiliary losses. A recurrent group's decode state
is its float32 recurrent state and its conv's last K-1 inputs, with a KV
cache for griffin's attention; a vlm or dec group's holds its
self-attention caches and its cross attention's K and V, computed once
at prefill. The memory (the vision tokens, the encoder's output) is an
argument of the backbone and the group runners; ``loss`` and
``prefill`` make it from the batch's ``"vision"`` or ``"audio_frames"``.

Under ``cfg.cache_mode == "rightsized"`` a sliding-window attention
layer keeps a ring of ``min(window, cache_len)`` slots, position p at
slot p % S (the reference's ``ring_cache``): gemma3's layers run as
``dense_sb`` super-blocks (``local_per_global`` local units, each with
its ring, then one global unit with a full cache), and a dense or moe
group whose every window is > 0 (gemma3's remainder layers) and
griffin's attention take rings too. Prefill writes the same rings
``init_decode_state`` allocates (``_cache_slots``), where the
reference's prefill gives the remainder group and griffin full caches
(ROADMAP section 3, record 6).

Under a mesh (``sharding.ctx.use_mesh``) every kind serves in the
reference's layout (``_OnMesh``): ``prefill``, ``init_decode_state``
and ``decode_step`` take token ids (and the memory's inputs) and return
logits of the global batch on every rank, while each rank holds its
shard of the parameters (``rules.serving_shard``: each leaf's block
under ``rules.serving_param_spec``) and of the decode state (under
``rules.state_spec``; ``_mesh_states``). The activations and the memory
are the rank's batch rows, every weight's FSDP dim is all-gathered over
``data`` as its unit runs, and the layers split their heads, MLP width
and vocab over ``model`` (``models.common``, ``models.attention``: the
cross layers' and whisper's encoder's too), mamba2's SSD heads and the
RG-LRU's width too (``models.ssd``, ``models.rglru``). Each cache is
cut by its own length (``_seqs``): a right-sized ring's
``min(window, cache_len)`` slots over the sequence's axes apart from
the global caches' ``cache_len``; the cross K and V are whole over
``model``.

Every kind trains over a mesh too (``loss``, in the reference's
``train_4k`` layout): each rank holds its shard of the parameters under
``rules.param_spec`` (``rules.training_shard``; the gradients and
AdamW's moments in the same layout), runs its rows of the global batch
(and of the memory: the projected vision tokens, whisper's encoder run
once a step on the rank's heads), gathers each unit's FSDP weights
inside the unit's call (under remat, again in its recomputation), and a
backward through the collectives' transposes
(``sharding.tensor_parallel``; the recurrent blocks and the cross layers
sum what each rank reads in part) gives each leaf its block of the
global loss's gradient. Every kind raises under a mesh with a ``pod``
axis.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.common import (
    ModelConfig,
    chunked_cross_entropy,
    dense_init,
    embed,
    embedding_init,
    lm_cross_entropy,
    mesh_cross_entropy,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
)
from repro_torch.sharding import rules
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.ctx import get_mesh
from repro_torch.tree import leaves, tree_map

RECURRENT = ("ssd", "rec", "griffin")  # kinds with a recurrent state


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    kind: str  # dense | moe | ssd | rec | griffin | vlm | enc | dec | dense_sb
    n: int  # units in the group
    windows: tuple = ()  # per-unit window (0 = full attention)
    thetas: tuple = ()  # per-unit rope theta


def build_groups(cfg: ModelConfig) -> "list[GroupSpec]":
    """The reference's group plan for every family (pure data)."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return [GroupSpec("ssd", L)]
    if cfg.family == "hybrid":
        n_super = L // 3
        rem = L - 3 * n_super
        gs = [GroupSpec("griffin", n_super)]
        if rem:
            gs.append(GroupSpec("rec", rem))
        return gs
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        if L % (per + 1) != 0:
            raise ValueError(
                f"vlm layer count {L} must be a multiple of "
                f"cross_attn_every+1 ({per + 1})")
        return [GroupSpec("vlm", L // (per + 1))]
    if cfg.family == "audio":
        return [GroupSpec("dec", L)]
    if (cfg.local_per_global and cfg.cache_mode == "rightsized"
            and cfg.family == "dense"):
        per = cfg.local_per_global + 1
        n_super = L // per
        rem = L - n_super * per
        gs = [GroupSpec("dense_sb", n_super)]
        if rem:
            gs.append(GroupSpec("dense", rem, (cfg.window,) * rem,
                                (float(cfg.rope_theta),) * rem))
        return gs
    if cfg.local_per_global:
        pat = cfg.local_per_global
        win, th = [], []
        for i in range(L):
            is_global = (i % (pat + 1)) == pat
            win.append(0 if is_global else cfg.window)
            th.append(cfg.rope_theta_global if is_global else cfg.rope_theta)
        windows, thetas = tuple(win), tuple(float(t) for t in th)
    else:
        windows = (cfg.window or 0,) * L
        thetas = (float(cfg.rope_theta),) * L
    if cfg.family == "moe":
        gs = []
        k = cfg.first_k_dense
        if k:
            gs.append(GroupSpec("dense", k, windows[:k], thetas[:k]))
        gs.append(GroupSpec("moe", L - k, windows[k:], thetas[k:]))
        return gs
    return [GroupSpec("dense", L, windows, thetas)]


# ---------------------------------------------------------------------------
# the dense unit
# ---------------------------------------------------------------------------

def _dense_unit_init(gen: torch.Generator, cfg: ModelConfig, *lead: int) -> dict:
    """Dense units stacked on the axes ``lead`` ((n,), or a vlm group's
    (n, per))."""
    dev, d = gen.device, cfg.d_model
    p = {
        "ln1": rmsnorm_init((*lead, d), cfg, dev),
        "attn": attn.attention_init(gen, cfg, lead=lead),
        "ln2": rmsnorm_init((*lead, d), cfg, dev),
        "mlp": mlp_init(gen, cfg, lead=lead),
    }
    if cfg.qk_norm:  # gemma3 sandwich norms
        p["ln1_post"] = rmsnorm_init((*lead, d), cfg, dev)
        p["ln2_post"] = rmsnorm_init((*lead, d), cfg, dev)
    return p


def _mlp_half(p: dict, x: torch.Tensor, h: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """The unit after its attention output ``h``: residual, MLP, residual."""
    if "ln1_post" in p:
        h = rmsnorm(p["ln1_post"], h)
    x = x + h
    h = mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg)
    if "ln2_post" in p:
        h = rmsnorm(p["ln2_post"], h)
    return x + h


def _dense_unit_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                      window: int, theta: float, causal: bool = True):
    """One unit over a full sequence; returns (x, k, v), the K and V its
    attention used (prefill caches them)."""
    h, k, v = attn.attn_full_kv(p["attn"], rmsnorm(p["ln1"], x), cfg,
                                causal=causal, window=window, theta=theta)
    return _mlp_half(p, x, h, cfg), k, v


def _dense_unit_train(p: dict, x: torch.Tensor, cfg: ModelConfig, window: int,
                      theta: float, causal: bool = True) -> torch.Tensor:
    """One unit over a full sequence, its output alone (training, and
    whisper's encoder, which caches no K and V)."""
    h = attn.attn_full(p["attn"], rmsnorm(p["ln1"], x), cfg, causal=causal,
                       window=window, theta=theta)
    return _mlp_half(p, x, h, cfg)


def _dense_unit_decode(p: dict, x: torch.Tensor, cache: dict,
                       index: torch.Tensor, cfg: ModelConfig, *,
                       window: int, theta: float, seq=None):
    h, cache = attn.attn_decode(p["attn"], rmsnorm(p["ln1"], x), cache,
                                index, cfg, window=window, theta=theta,
                                seq=seq)
    return _mlp_half(p, x, h, cfg), cache


# ---------------------------------------------------------------------------
# the moe unit: attention, then the MoE (plus arctic's dense MLP) on the
# same normed input
# ---------------------------------------------------------------------------

def _moe_unit_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    """``n`` stacked moe units."""
    dev = gen.device
    p = {
        "ln1": rmsnorm_init((n, cfg.d_model), cfg, dev),
        "attn": attn.attention_init(gen, cfg, lead=(n,)),
        "ln2": rmsnorm_init((n, cfg.d_model), cfg, dev),
        "moe": moe_mod.moe_init(gen, cfg, lead=(n,)),
    }
    if cfg.moe_dense_residual:  # arctic: a dense MLP beside the MoE
        p["dense_mlp"] = mlp_init(gen, cfg, lead=(n,))
    return p


def _moe_half(p: dict, x: torch.Tensor, h: torch.Tensor, cfg: ModelConfig):
    """The unit after its attention output ``h``: (x, aux); the MoE's
    output, then the dense MLP's, then the residual."""
    x = x + h
    normed = rmsnorm(p["ln2"], x)
    mo, aux, _ = moe_mod.moe_apply(p["moe"], normed, cfg)
    if "dense_mlp" in p:
        mo = mo + mlp_apply(p["dense_mlp"], normed, cfg)
    return x + mo, aux


def _moe_unit_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    window: int, theta: float):
    """One unit over a full sequence: (x, k, v, aux), with the K and V its
    attention used."""
    h, k, v = attn.attn_full_kv(p["attn"], rmsnorm(p["ln1"], x), cfg,
                                window=window, theta=theta)
    x, aux = _moe_half(p, x, h, cfg)
    return x, k, v, aux


def _moe_unit_train(p: dict, x: torch.Tensor, cfg: ModelConfig, window: int,
                    theta: float):
    """One unit over a full sequence: (x, aux) (training)."""
    h = attn.attn_full(p["attn"], rmsnorm(p["ln1"], x), cfg, window=window,
                       theta=theta)
    return _moe_half(p, x, h, cfg)


def _moe_unit_decode(p: dict, x: torch.Tensor, cache: dict,
                     index: torch.Tensor, cfg: ModelConfig, *,
                     window: int, theta: float, seq=None):
    h, cache = attn.attn_decode(p["attn"], rmsnorm(p["ln1"], x), cache,
                                index, cfg, window=window, theta=theta,
                                seq=seq)
    return _moe_half(p, x, h, cfg)[0], cache


# ---------------------------------------------------------------------------
# the recurrent units: ssd (mamba2), rec and griffin (recurrentgemma)
# ---------------------------------------------------------------------------

def _ssd_unit_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    return {"ln1": rmsnorm_init((n, cfg.d_model), cfg, gen.device),
            "ssd": ssd_mod.ssd_init(gen, cfg, lead=(n,))}


def _rec_unit_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    dev = gen.device
    return {"ln1": rmsnorm_init((n, cfg.d_model), cfg, dev),
            "rec": rg.rglru_init(gen, cfg, lead=(n,)),
            "ln2": rmsnorm_init((n, cfg.d_model), cfg, dev),
            "mlp": mlp_init(gen, cfg, lead=(n,))}


def _griffin_unit_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    return {"rec0": _rec_unit_init(gen, cfg, n),
            "rec1": _rec_unit_init(gen, cfg, n),
            "attn": _dense_unit_init(gen, cfg, n)}


def _ssd_unit_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    want_state: bool = False):
    """One mamba2 unit; with ``want_state`` returns (x, ssm state, conv
    state)."""
    out = ssd_mod.ssd_block_apply(p["ssd"], rmsnorm(p["ln1"], x), cfg,
                                  return_state=want_state)
    if want_state:
        h, s, c = out
        return x + h, s, c
    return x + out


def _rec_mlp(p: dict, x: torch.Tensor, h: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    x = x + h
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg)


def _rec_unit_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    want_state: bool = False):
    """One recurrent unit; with ``want_state`` returns (x, h, conv state)."""
    out = rg.rglru_block_apply(p["rec"], rmsnorm(p["ln1"], x), cfg,
                               return_state=want_state)
    if want_state:
        h, s, c = out
        return _rec_mlp(p, x, h, cfg), s, c
    return _rec_mlp(p, x, out, cfg)


def _griffin_unit_apply(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """One (rec, rec, attn) super-block over a full sequence; returns
    (x, (h0, conv0, h1, conv1), k, v)."""
    x, h0, c0 = _rec_unit_apply(p["rec0"], x, cfg, want_state=True)
    x, h1, c1 = _rec_unit_apply(p["rec1"], x, cfg, want_state=True)
    x, k, v = _dense_unit_apply(p["attn"], x, cfg, window=cfg.window,
                                theta=cfg.rope_theta)
    return x, (h0, c0, h1, c1), k, v


def _griffin_unit_train(p: dict, x: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    x = _rec_unit_apply(p["rec0"], x, cfg)
    x = _rec_unit_apply(p["rec1"], x, cfg)
    return _dense_unit_train(p["attn"], x, cfg, cfg.window, cfg.rope_theta)


def _rec_unit_decode(p: dict, x: torch.Tensor, h: torch.Tensor,
                     conv: torch.Tensor, cfg: ModelConfig):
    out, h, conv = rg.rglru_decode_step(p["rec"], rmsnorm(p["ln1"], x), cfg,
                                        state=h, conv_state=conv)
    return _rec_mlp(p, x, out, cfg), h, conv


# ---------------------------------------------------------------------------
# right-sized caches: gemma3's (local x per, global) super-block and rings
# ---------------------------------------------------------------------------

def _dense_sb_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    """``n`` stacked super-blocks: ``loc``, the ``local_per_global`` local
    dense units (n, per, ...), then ``glob``, the global unit (n, ...)."""
    return {"loc": _dense_unit_init(gen, cfg, n, cfg.local_per_global),
            "glob": _dense_unit_init(gen, cfg, n)}


def _theta_global(cfg: ModelConfig) -> float:
    return cfg.rope_theta_global or cfg.rope_theta


def _sb_unit_train(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One super-block over a full sequence (training): its local units
    with ``cfg.window`` and ``cfg.rope_theta``, then its global unit with
    no window and the global theta."""
    for pl in _units(p["loc"], cfg.local_per_global):
        x = _dense_unit_train(pl, x, cfg, cfg.window, cfg.rope_theta)
    return _dense_unit_train(p["glob"], x, cfg, None, _theta_global(cfg))


def _cache_slots(cfg: ModelConfig, g: GroupSpec, cache_len: int) -> int:
    """Slots of a group's attention caches (a ``dense_sb`` group's local
    rings): ``min(window, cache_len)`` for a right-sized sliding window
    (``dense_sb`` locals, griffin's attention, a dense or moe group whose
    every window is > 0), else ``cache_len``."""
    ring = cfg.cache_mode == "rightsized" and bool(cfg.window) and (
        g.kind in ("dense_sb", "griffin")
        or (g.kind in ("dense", "moe") and all(w > 0 for w in g.windows)))
    return min(cfg.window, cache_len) if ring else cache_len


def _sb_state(cfg: ModelConfig, n: int, batch: int, cache_len: int,
              device) -> dict:
    """A ``dense_sb`` group's zeroed state: ``loc``, the local units'
    rings (n, per, B, min(window, cache_len), ...), and ``glob``, the
    global units' caches of ``cache_len`` slots."""
    per = cfg.local_per_global
    loc = attn.make_cache(cfg, n * per, batch, min(cfg.window, cache_len),
                          device)
    return {"loc": {name: a.unflatten(0, (n, per)) for name, a in loc.items()},
            "glob": attn.make_cache(cfg, n, batch, cache_len, device)}


def _cache_put(cache: dict, k: torch.Tensor, v: torch.Tensor,
               seq: "attn.SeqShard | None" = None) -> None:
    """Write a prefill's K and V (B, T, Hkv, Dh) into one layer's cache of
    S slots ({"k", "v": (B, S, Hkv, Dh), "pos": (B, S)}, views): the last
    min(T, S) positions, position p at slot p % S (the first T slots when
    S >= T; a ring shorter than T keeps the last S, the reference's
    ``ring_cache``); the other slots keep pos -1. On a mesh the cache is
    the block of slots [``seq.offset``, ``seq.offset`` + its length) of
    S = ``seq.slots``, and takes the kept positions whose slot falls
    there (a ring's block may hold a wrapped mix of them)."""
    t, local = k.shape[1], cache["k"].shape[1]
    s, off = (local, 0) if seq is None else (seq.slots, seq.offset)
    lo = max(0, t - s)
    wrap = min(t, lo - lo % s + s)
    # two runs of positions, each at consecutive slots from p0 % s: the
    # block's local slot of position p is p - base
    for p0, p1 in ((lo, wrap), (wrap, t)):
        base = p0 - p0 % s + off
        a, b = max(p0, base), min(p1, base + local)
        if a >= b:
            continue
        cache["k"][:, a - base:b - base] = k[:, a:b]
        cache["v"][:, a - base:b - base] = v[:, a:b]
        cache["pos"][:, a - base:b - base] = torch.arange(
            a, b, dtype=torch.int32, device=k.device)


# ---------------------------------------------------------------------------
# cross attention: the vlm super-block, whisper's encoder and decoder
# ---------------------------------------------------------------------------

def _stack_units(n: int, draw) -> dict:
    """``n`` units drawn one at a time by ``draw()`` (the tree of one
    unit) and written into stacked (n, ...) leaves: one unit's float32
    draws exist at a time, not the whole stack's (the four self-layer
    MLPs of one llama-3.2-vision super-block are 11.3 GB in float32)."""
    stacked = None
    for i in range(n):
        unit = draw()
        if stacked is None:
            stacked = tree_map(lambda a: a.new_empty((n, *a.shape)), unit)
        for dst, src in zip(leaves(stacked), leaves(unit)):
            dst[i] = src
    return stacked


def _vlm_unit_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    """``n`` stacked vlm super-blocks: ``self``, dense units (n, per, ...),
    and ``cross``, the cross-attention layer with its MLP and its two
    scalar gates (n,), zero at init as the reference's (so the memory
    reaches no output until training moves them)."""
    per, d, dev = cfg.cross_attn_every, cfg.d_model, gen.device

    def unit():
        return {"self": _dense_unit_init(gen, cfg, per),
                "cross": {"ln": rmsnorm_init((d,), cfg, dev),
                          "attn": attn.attention_init(gen, cfg, d_kv_in=d),
                          "gate": torch.zeros((), dtype=cfg.param_dtype,
                                              device=dev),
                          "ln2": rmsnorm_init((d,), cfg, dev),
                          "mlp": mlp_init(gen, cfg),
                          "gate_mlp": torch.zeros((), dtype=cfg.param_dtype,
                                                  device=dev)}}
    return _stack_units(n, unit)


def _enc_unit_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    """``n`` stacked encoder units: dense units, run non-causal."""
    return _dense_unit_init(gen, cfg, n)


def _dec_unit_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    """``n`` stacked decoder units: causal self attention, cross attention
    over the encoder's output, MLP, each after its norm."""
    d, dev = cfg.d_model, gen.device
    return {"ln1": rmsnorm_init((n, d), cfg, dev),
            "self_attn": attn.attention_init(gen, cfg, lead=(n,)),
            "ln2": rmsnorm_init((n, d), cfg, dev),
            "cross_attn": attn.attention_init(gen, cfg, lead=(n,), d_kv_in=d),
            "ln3": rmsnorm_init((n, d), cfg, dev),
            "mlp": mlp_init(gen, cfg, lead=(n,))}


def sinusoidal_positions(t: int, d: int, dtype, device="cpu") -> torch.Tensor:
    """Whisper's (T, D) positions in float32, cast to ``dtype``: sines in
    the even columns, cosines in the odd. An odd ``d`` past 1 raises, as
    the reference's does (its cosines have one column too many)."""
    if d % 2 and d > 1:
        raise ValueError(f"sinusoidal positions need an even width, got {d}")
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    # the reference's float32 scalar -log(10000) / d
    step = -torch.log(torch.tensor(10000.0, device=device)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * step)
    pe = torch.zeros((t, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[:d // 2])
    return pe.to(dtype)


def _gated(gate: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """tanh(gate) in float32, cast to h's dtype, times h."""
    return torch.tanh(gate.float()).to(h.dtype) * h


def _cross_apply(cr: dict, x: torch.Tensor, mkv: dict,
                 cfg: ModelConfig) -> torch.Tensor:
    """A vlm super-block's cross layer: gated cross attention over the
    memory's K and V, then its gated MLP, each a residual."""
    x = x + _gated(cr["gate"], attn.attn_cross(cr["attn"],
                                               rmsnorm(cr["ln"], x), mkv, cfg))
    return x + _gated(cr["gate_mlp"],
                      mlp_apply(cr["mlp"], rmsnorm(cr["ln2"], x), cfg))


def _vlm_unit_train(p: dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """One vlm super-block over a full sequence (training): its self
    layers, causal with no window, then the cross layer over ``memory``'s
    K and V."""
    for ps in _units(p["self"], cfg.cross_attn_every):
        x = _dense_unit_train(ps, x, cfg, None, cfg.rope_theta)
    mkv = attn.cross_kv(p["cross"]["attn"], memory, cfg, whole=False)
    return _cross_apply(p["cross"], x, mkv, cfg)


def _dec_unit_apply(p: dict, x: torch.Tensor, mkv: dict, cfg: ModelConfig):
    """One decoder unit over a full sequence; returns (x, k, v), the K and
    V its self attention used."""
    h, k, v = attn.attn_full_kv(p["self_attn"], rmsnorm(p["ln1"], x), cfg,
                                causal=True, theta=cfg.rope_theta)
    return _dec_tail(p, x + h, mkv, cfg), k, v


def _dec_tail(p: dict, x: torch.Tensor, mkv: dict,
              cfg: ModelConfig) -> torch.Tensor:
    """A decoder unit after its self attention: cross attention, MLP."""
    x = x + attn.attn_cross(p["cross_attn"], rmsnorm(p["ln2"], x), mkv, cfg)
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln3"], x), cfg)


def _dec_unit_train(p: dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """One decoder unit over a full sequence (training), its cross K and
    V from ``memory``."""
    mkv = attn.cross_kv(p["cross_attn"], memory, cfg, whole=False)
    h = attn.attn_full(p["self_attn"], rmsnorm(p["ln1"], x), cfg,
                       theta=cfg.rope_theta)
    return _dec_tail(p, x + h, mkv, cfg)


def _cross_state(cfg: ModelConfig, n: int, batch: int, s: int,
                 device) -> dict:
    """Zeroed cross K and V of ``n`` layers over a memory of ``s`` tokens:
    (n, B, S, Hkv, Dh) each in ``cfg.dtype``."""
    shape = (n, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {"cross_k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _vlm_state(cfg: ModelConfig, n: int, batch: int, cache_len: int,
               s: int, device) -> dict:
    """A vlm group's zeroed state: its self layers' caches (n, per, ...)
    and its cross layers' K and V."""
    c = attn.make_cache(cfg, n * cfg.cross_attn_every, batch, cache_len,
                        device)
    c = {name: a.unflatten(0, (n, cfg.cross_attn_every))
         for name, a in c.items()}
    return {**c, **_cross_state(cfg, n, batch, s, device)}


def _dec_state(cfg: ModelConfig, n: int, batch: int, cache_len: int,
               s: int, device) -> dict:
    return {**attn.make_cache(cfg, n, batch, cache_len, device),
            **_cross_state(cfg, n, batch, s, device)}


_UNIT_INIT = {"dense": _dense_unit_init, "dense_sb": _dense_sb_init,
              "moe": _moe_unit_init, "ssd": _ssd_unit_init,
              "rec": _rec_unit_init, "griffin": _griffin_unit_init,
              "vlm": _vlm_unit_init, "enc": _enc_unit_init,
              "dec": _dec_unit_init}
CROSS = ("vlm", "dec")  # kinds that attend over a memory
# a recurrent unit or a super-block over a full sequence, its output alone
# (training)
_UNIT_TRAIN = {"ssd": _ssd_unit_apply, "rec": _rec_unit_apply,
               "griffin": _griffin_unit_train, "dense_sb": _sb_unit_train}


def _rec_state(cfg: ModelConfig, n: int, batch: int, device) -> dict:
    """Zeroed states of ``n`` recurrent units: h (n, B, D) float32, conv
    (n, B, K-1, D) in ``cfg.dtype``."""
    return {"h": torch.zeros((n, batch, cfg.d_model), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((n, batch, cfg.rglru_conv - 1, cfg.d_model),
                                dtype=cfg.dtype, device=device)}


def _griffin_state(cfg: ModelConfig, n: int, batch: int, cache_len: int,
                   device) -> dict:
    """Two rec units' states and the attention's cache of ``cache_len``
    slots (the caller passes ``_cache_slots``)."""
    r0, r1 = (_rec_state(cfg, n, batch, device) for _ in range(2))
    return {"h0": r0["h"], "conv0": r0["conv"], "h1": r1["h"],
            "conv1": r1["conv"],
            **attn.make_cache(cfg, n, batch, cache_len, device)}


def _layer(tree, i: int):
    """Unit ``i`` of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {name: _layer(sub, i) for name, sub in tree.items()}
    return tree[i]


def _units(tree, n: int) -> list:
    """The ``n`` units of a stacked parameter tree, as views from one
    ``unbind`` a leaf: its backward stacks the units' gradients into one
    (L, ...) tensor, where a view per unit would give each unit's
    gradient a full-size zero tensor of its own."""
    if isinstance(tree, dict):
        subs = {name: _units(sub, n) for name, sub in tree.items()}
        return [{name: sub[i] for name, sub in subs.items()}
                for i in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# serving over a mesh
# ---------------------------------------------------------------------------

# leaves whose ``model`` block a rank keeps: the projections (a cross
# layer's and whisper's encoder's too), the MLPs' (dense, a vlm cross
# layer's, arctic's dense_mlp, the shared expert's, the experts'), the
# recurrent blocks' (mamba2's w_in and w_out; the RG-LRU's w_x, w_a, w_i,
# w_out and its gelu gate, which shares the MLP's name w_gate and its
# (data, model) spec) and the vocab's; every other leaf is gathered whole
# on use
_MODEL_BLOCK_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                       "w_in", "w_x", "w_a", "w_i", "w_out", "table",
                       "lm_head")
_NOT_ON_MESH = "ROADMAP.md queue 1, 'the pod axis over a mesh'"
_EXPERTS = ("w_gate", "w_up", "w_down")


def _meta(*shape) -> torch.Tensor:
    return torch.empty(shape, device="meta")


_UNIT = object()  # ``_OnMesh.weights``' layer: the tree is one unit's


def _sharded(spec, axis: str) -> bool:
    """Whether a spec shards some dim over ``axis``."""
    return any(ax == axis or (isinstance(ax, tuple) and axis in ax)
               for ax in spec)


def _experts_on_decode(lay: tp.Layout, path: tuple, spec: tuple,
                       shard: torch.Tensor):
    """The cut from an expert weight gathered whole over ``data`` (its
    ``rules.param_spec`` shard's FSDP dim) to the rank's block of the
    decode branch's layout (``moe.moe_param_spec``, the serving one): each
    dim that layout shards over ``data`` narrowed to the rank's block."""
    sizes = lay.sizes
    glob = [n * math.prod(sizes[a] for a in _spec_axes(spec, d))
            for d, n in enumerate(shard.shape)]
    want = moe_mod.moe_param_spec(lay.mesh, path, _meta(*glob),
                                  branch="decode")
    cuts = [(d, glob[d] // sizes["data"]) for d in range(len(want))
            if _sharded((want[d],), "data")]

    def narrow(x):
        for d, n in cuts:
            x = x.narrow(d, lay.coord["data"] * n, n)
        return x
    return narrow


def _spec_axes(spec, d: int) -> tuple:
    axes = spec[d] if d < len(spec) else None
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(eq=False)
class _OnMesh:
    """One call of a model over a mesh: the rank's
    ``tensor_parallel.Layout``, the specs of the global parameter tree
    (under ``rules.serving_param_spec``, or ``rules.param_spec`` for
    ``train``; None where no weight is read) and the global batch, whose
    rows [row0, row0 + rows) are the rank's (``rules.batch_spec``: over
    ``data``, every row where the batch does not divide; ``row_group``
    gathers the blocks, None where the rows are whole)."""

    lay: tp.Layout
    specs: "dict | None"
    batch: int
    train: bool = False

    def __post_init__(self):
        spec = rules.batch_spec(self.lay.mesh, (), _meta(self.batch))
        self.row0, self.rows, self.row_group = self.lay.block(
            spec, 0, self.batch)

    def take_rows(self, a: torch.Tensor) -> torch.Tensor:
        return a[self.row0:self.row0 + self.rows]

    def gather_rows(self, a: torch.Tensor) -> torch.Tensor:
        return tp.gather(a, self.row_group, 0)

    def unit(self, params: dict, name: str, branch: "str | None" = None):
        """Unit i of the stacked tree ``params[name]`` (a group's,
        ``"group{gi}"``, or whisper's ``"encoder"``) -> its weights as
        ``weights`` gives them."""
        return lambda i: self.weights(params[name], self.specs[name],
                                      path=(name,), layer=i, branch=branch)

    def unit_of(self, name: str, branch: "str | None" = None):
        """A unit of the stacked tree named ``name`` (its leaves already
        the unit's: ``_units``' views of the rank's shard) -> its weights
        as ``weights`` gives them (a training step's units gather inside
        their recomputation)."""
        return lambda p: self.weights(p, self.specs[name], path=(name,),
                                      layer=_UNIT, branch=branch)

    def leaf(self, params: dict, name: str):
        """The top-level tree ``params[name]`` as ``weights`` gives it."""
        return self.weights(params[name], self.specs[name], path=(name,))

    def weights(self, tree, specs, *, path: tuple, layer=None,
                branch: "str | None" = None):
        """The rank's weights of ``tree`` (unit ``layer`` of a stacked
        group's, ``_UNIT`` where ``tree`` is the unit's already, or
        top-level leaves) as a layer reads them: each FSDP dim
        all-gathered over ``data`` (one collective for all of them,
        ``tensor_parallel.unshard_all``), the ``model`` blocks of
        ``_MODEL_BLOCK_LEAVES`` kept, every other leaf whole. The experts
        arrive in the layout of ``moe_apply``'s branch
        (``moe.moe_param_spec``): on the decode branch the serving
        layout's ``data`` block is kept, and the training layout's
        FSDP dim is gathered and its F dim cut to the ``data`` block. The
        gathered copies live as long as the layer's call.

        Each leaf's gradient comes back to the rank's shard as the
        gradient of the global loss: a gather over ``data`` is
        reduce-scattered where the batch's rows are split over ``data``
        (each rank read the weight on its own rows); a leaf with no
        ``data`` dim is summed over ``data`` there; a leaf an attention
        with split heads reads whole (``wk`` and ``wv`` whose heads do
        not divide, the biases, the q and k norms: each rank uses the
        part its heads read) is summed over ``model``. The MoE's leaves
        are left to ``moe_apply``, which sums its router, experts and
        shared expert over the axes that read them alike, and the
        recurrent blocks' whole leaves to ``ssd_block_apply`` and
        ``rglru_block_apply``, which sum them over ``model`` where each
        rank reads them on its SSD heads or its block of the width."""
        items, paths, sums = [], [], {}
        rows_split = self.row_group is not None

        def walk(node, spec, at, split_heads):
            if isinstance(node, dict):
                if "wq" in node:
                    split_heads = _sharded(spec["wq"], "model")
                for name, sub in node.items():
                    walk(sub, spec[name], at + (name,), split_heads)
                return
            if layer is not None:
                if spec and spec[0] is not None:
                    raise NotImplementedError(
                        f"{'/'.join(at)}: its layer axis is sharded over "
                        f"{spec[0]}; a model over a mesh takes whole layers")
                node = node if layer is _UNIT else node[layer]
                spec = spec[1:]
            in_moe = "moe" in at[len(path):]
            expert = len(at) >= 2 and at[-2] == "moe" and at[-1] in _EXPERTS
            # the axes whose gathers sum the gradient: each data rank
            # read the weight on its own rows (the MoE sums its own)
            keep = ()
            reduce = ("data",) if rows_split and not in_moe else ()
            if at[-1] in _MODEL_BLOCK_LEAVES:
                keep = (("model", "data") if expert and branch == "decode"
                        and not self.train else ("model",))
            narrow = None
            if expert and branch == "decode" and self.train:
                # param_spec's FSDP dim gathered (each data rank's F block
                # of the gradient summed into its D block), then the
                # rank's data block of F kept
                reduce = ("data",)
                narrow = _experts_on_decode(self.lay, at, spec, node)
            axes = tuple(
                a for a, partial in (
                    ("data", rows_split and not in_moe
                     and not _sharded(spec, "data")),
                    ("model", split_heads and not _sharded(spec, "model")))
                if partial)
            if axes:
                sums.setdefault(axes, []).append(len(items))
            items.append([node, spec, keep, reduce, narrow])
            paths.append(at[len(path):])
        walk(tree, specs, path, False)
        for axes, idx in sums.items():
            got = tp.replicated_inputs([items[i][0] for i in idx],
                                       self.lay.group(axes))
            for i, x in zip(idx, got):
                items[i][0] = x
        out: dict = {}
        for at, item, x in zip(paths, items,
                               tp.unshard_all([it[:4] for it in items],
                                              self.lay)):
            if item[4] is not None:
                x = item[4](x)
            if not at:
                return x
            node = out
            for name in at[:-1]:
                node = node.setdefault(name, {})
            node[at[-1]] = x
        return out

    def top(self, params: dict):
        """(the embedding, the final norm, the unembedding table (V, D)
        or the rank's vocab block of it), as ``weights`` gives them."""
        table = (self.leaf(params, "lm_head").T if "lm_head" in params
                 else None)
        emb = self.leaf(params, "embed")
        return emb, self.leaf(params, "final_norm"), (
            emb["table"] if table is None else table)

    def seq(self, slots: int) -> attn.SeqShard:
        """The sequence shard of the rank's block of a cache (or a ring)
        of ``slots`` slots under ``rules.state_spec``, whose rows must be
        the rank's rows of the batch: its offset, ``slots`` and the group
        of the other blocks (None where the guard keeps it whole)."""
        spec = rules.state_spec(self.lay.mesh, ("k",),
                                _meta(1, self.batch, slots, 1, 1),
                                batch=self.batch)
        row0, rows, _ = self.lay.block(spec, 1, self.batch)
        if (row0, rows) != (self.row0, self.rows):
            raise NotImplementedError(
                f"the cache's rows [{row0}, {row0 + rows}) are not the "
                f"batch's [{self.row0}, {self.row0 + self.rows}) on this "
                f"mesh {self.lay.sizes}")
        off, _, group = self.lay.block(spec, 2, slots)
        return attn.SeqShard(off, slots, group)

    def moe_branch(self, t: int) -> str:
        """The branch ``moe_apply`` takes on this call's (batch, t), which
        takes the rank's batch rows: a batch that does not divide over
        the batch axes raises, as the reference's ``shard_map`` does."""
        branch = moe_mod.moe_branch(self.lay.mesh, self.batch, t)
        n_batch = self.lay.size(("pod", "data"))
        if branch != "one" and n_batch > 1 and self.rows * n_batch != self.batch:
            raise ValueError(
                f"a moe unit over a mesh takes a batch that divides over "
                f"(pod, data) = {n_batch}; got {self.batch} rows")
        return branch


def _with_weights(fn, weights, p, *args):
    """``fn`` on the weights ``weights`` makes of the shard ``p``."""
    return fn(weights(p), *args)


def _check_shard(params, want, train: bool, path=()) -> None:
    """Raise unless ``params`` has ``want``'s leaves at their shapes."""
    if isinstance(want, dict):
        if not isinstance(params, dict) or set(params) != set(want):
            raise ValueError(f"{'/'.join(path) or 'params'}: keys "
                             f"{sorted(params) if isinstance(params, dict) else params}"
                             f" != {sorted(want)}")
        for name in want:
            _check_shard(params[name], want[name], train, path + (name,))
        return
    if tuple(params.shape) != tuple(want.shape):
        rule, shard = (("param_spec", "training_shard") if train
                       else ("serving_param_spec", "serving_shard"))
        raise ValueError(
            f"{'/'.join(path)}: shape {tuple(params.shape)} is not this "
            f"rank's shard {tuple(want.shape)} under rules.{rule} (pass "
            f"rules.{shard}(mesh, params))")


class LM:
    """Model wrapper for one ModelConfig (the dense, dense_sb, moe, ssd,
    rec, griffin, vlm and dec group kinds, and whisper's encoder)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.groups = build_groups(cfg)
        self._mesh_specs: dict = {}  # (id(mesh), train) -> (mesh, specs, shards)

    # -- a model over a mesh -------------------------------------------------
    def _check_mesh(self, mesh, train: bool = False) -> tp.Layout:
        """This rank's layout on ``mesh``; raise where the model cannot run
        over it (a ``pod`` axis)."""
        if "pod" in axis_sizes(mesh):
            raise NotImplementedError(
                f"{self.cfg.arch_id}: {'training' if train else 'serving'} "
                f"over a mesh with a 'pod' axis is not ported "
                f"({_NOT_ON_MESH})")
        return tp.layout(mesh)

    def _specs(self, mesh, train: bool):
        """(the specs of the global parameter tree on ``mesh`` under
        ``rules.param_spec`` (``train``) or ``rules.serving_param_spec``,
        the rank's shard of it on the meta device), made once a mesh."""
        key = (id(mesh), train)
        if key not in self._mesh_specs or self._mesh_specs[key][0] is not mesh:
            from repro_torch.launch.input_specs import param_shapes

            rule = rules.param_spec if train else rules.serving_param_spec
            shapes = param_shapes(self.cfg)
            self._mesh_specs[key] = (mesh, rules.tree_specs(mesh, shapes, rule),
                                     rules.shard_tree(mesh, shapes, rule))
        return self._mesh_specs[key][1:]

    def param_specs(self):
        """The specs of the global parameter tree under ``rules.param_spec``
        on the active mesh (None without one): the layout of a training
        step's parameters, gradients and AdamW moments, which
        ``adamw_update`` reads for the gradient's norm."""
        mesh = get_mesh()
        return None if mesh is None else self._specs(mesh, True)[0]

    def _on_mesh(self, params: dict, batch: int,
                 train: bool = False) -> "_OnMesh | None":
        """The call's ``_OnMesh`` under the active mesh (None without one),
        after checking that ``params`` is this rank's shard (serving's, or
        training's for ``train``)."""
        mesh = get_mesh()
        if mesh is None:
            return None
        lay = self._check_mesh(mesh, train)
        specs, shards = self._specs(mesh, train)
        _check_shard(params, shards, train)
        return _OnMesh(lay, specs, batch, train)

    @property
    def recurrent(self) -> bool:
        """Whether a group carries a recurrent state (ssd, rec, griffin):
        its prefill must see the prompt's real tokens only."""
        return any(g.kind in RECURRENT for g in self.groups)

    @property
    def exact_prefill(self) -> bool:
        """Whether a prompt must be prefilled at its own length, unpadded:
        a recurrent state would absorb padding, and a right-sized ring
        shorter than a padded prompt would keep the padding and drop the
        prompt's last real keys."""
        return self.recurrent or self.cfg.cache_mode == "rightsized"

    # -- init ----------------------------------------------------------------
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters on the generator's device, drawn from it in
        the reference's order: the embedding, the untied head, the vision
        projection, the encoder, the groups."""
        cfg, dev = self.cfg, gen.device
        params: dict = {"embed": embedding_init(gen, cfg),
                        "final_norm": rmsnorm_init((cfg.d_model,), cfg, dev)}
        if not cfg.tied_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                           cfg.d_model, cfg.param_dtype)
        if cfg.family == "vlm":
            params["vision_proj"] = dense_init(
                gen, (cfg.vision_dim, cfg.d_model), cfg.vision_dim,
                cfg.param_dtype)
        if cfg.family == "audio":
            params["encoder"] = _enc_unit_init(gen, cfg, cfg.encoder_layers)
            params["enc_final_norm"] = rmsnorm_init((cfg.d_model,), cfg, dev)
        for gi, g in enumerate(self.groups):
            params[f"group{gi}"] = _UNIT_INIT[g.kind](gen, cfg, g.n)
        return params

    def _table(self, params: dict) -> torch.Tensor:
        return (params["lm_head"].T if "lm_head" in params
                else params["embed"]["table"])

    # -- the memory of the non-token modality -----------------------------------
    def _encode_audio(self, params: dict, frames: torch.Tensor,
                      on: "_OnMesh | None" = None) -> torch.Tensor:
        """Whisper's encoder over frame embeddings (B, S, D): sinusoidal
        positions added, then its units, non-causal, each with rope at
        ``cfg.rope_theta`` (the reference's ``theta=None`` falls back to
        it: ROADMAP section 3, record 5), then the final norm. No unit is
        recomputed in the backward, as in the reference. On a mesh the
        frames are the rank's rows and each unit's weights the rank's
        (``on.unit_of``: gathered over ``data`` as the unit runs): its
        heads and MLP width, summed over ``model``."""
        cfg = self.cfg
        x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                          frames.dtype, frames.device)
        units = _units(params["encoder"], cfg.encoder_layers)
        if on is None:
            norm = params["enc_final_norm"]
        else:
            weights = on.unit_of("encoder")
            units = (weights(p) for p in units)
            norm = on.leaf(params, "enc_final_norm")
        for p in units:
            x = _dense_unit_train(p, x, cfg, None, None, causal=False)
        return rmsnorm(norm, x)

    def _inject_memory(self, params: dict, batch: dict,
                       on: "_OnMesh | None" = None):
        """The memory a cross-attention group attends over, from the batch:
        the vlm's ``batch["vision"]`` (B, vision_tokens, vision_dim) cast
        to ``cfg.dtype`` and projected by ``vision_proj``, whisper's
        encoder over ``batch["audio_frames"]`` (B, audio_frames, d_model)
        cast to ``cfg.dtype``; None for the other families. On a mesh the
        batch is the global one and the memory the rank's rows of it
        (``vision_proj`` gathered whole over ``data``)."""
        cfg = self.cfg
        rows = (lambda a: a) if on is None else on.take_rows
        if cfg.family == "vlm":
            proj = (params["vision_proj"] if on is None
                    else on.leaf(params, "vision_proj"))
            return rows(batch["vision"]).to(cfg.dtype) @ proj
        if cfg.family == "audio":
            return self._encode_audio(
                params, rows(batch["audio_frames"]).to(cfg.dtype), on)
        return None

    # -- full-sequence forward ------------------------------------------------
    def _backbone(self, params: dict, x: torch.Tensor, *,
                  memory: "torch.Tensor | None" = None,
                  cache_len: "int | None" = None):
        """Run all groups over full sequences, a vlm or dec group attending
        over ``memory`` (``_inject_memory``). Returns (features, the moe
        layers' auxiliary losses summed in float32 in layer order, the
        decode state of each group, its KV caches with ``cache_len``
        slots); with ``cache_len`` None no state is built (training,
        features) and the last item is None. The aux is 0 without a moe
        group, and in a prefill (the reference discards it there)."""
        caches = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, g in enumerate(self.groups):
            gp = params[f"group{gi}"]
            if g.kind in CROSS and memory is None:
                raise ValueError(
                    f"{self.cfg.arch_id}: the {g.kind!r} group attends over a "
                    f"memory; pass the batch's "
                    f"{'vision' if g.kind == 'vlm' else 'audio_frames'} "
                    f"through loss or prefill")
            if cache_len is None:
                x, aux = self._run_group_train(g, gp, x, aux, memory)
                continue
            b, t, _ = x.shape
            if g.kind not in ("ssd", "rec") and cache_len < t:
                raise ValueError(f"cache_len {cache_len} < prompt length {t}")
            cache = self._group_state(
                g, b, cache_len, x.device,
                None if memory is None else memory.shape[1])
            x = self._run_group_full(g, functools.partial(_layer, gp), x,
                                     cache, memory)
            caches.append(cache)
        return (rmsnorm(params["final_norm"], x), aux,
                None if cache_len is None else caches)

    def _run_group_train(self, g: GroupSpec, gp: dict, x: torch.Tensor,
                         aux: torch.Tensor, memory=None, weights=None):
        """The group's units without caches: (x, ``aux`` plus each moe
        unit's aux in turn). With ``cfg.remat`` and autograd recording,
        each unit keeps only its input for the backward and runs again
        there (the reference's per-unit ``jax.checkpoint``; a griffin, vlm
        or dense_sb super-block is one unit, a vlm or dec unit's cross K
        and V are recomputed with it), so its attention's forward kernel
        launches twice in a training step. On a mesh ``gp`` is the rank's
        shard and ``weights`` (``_OnMesh.unit_of``) makes a unit's weights
        of its shard inside the unit's call: under remat its FSDP gathers
        run again in the recomputation, and no unit's gathered weights
        outlive it."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i, p in enumerate(_units(gp, g.n)):
            if g.kind in ("dense", "moe"):
                fn = _dense_unit_train if g.kind == "dense" else _moe_unit_train
                args = (p, x, self.cfg, g.windows[i], g.thetas[i])
            elif g.kind in CROSS:
                fn = _vlm_unit_train if g.kind == "vlm" else _dec_unit_train
                args = (p, x, memory, self.cfg)
            else:
                fn, args = _UNIT_TRAIN[g.kind], (p, x, self.cfg)
            if weights is not None:
                fn, args = _with_weights, (fn, weights, *args)
            x = (checkpoint(fn, *args, use_reentrant=False) if remat
                 else fn(*args))
            if g.kind == "moe":
                x, unit_aux = x
                aux = aux + unit_aux
        return x, aux

    def _run_group_full(self, g: GroupSpec, unit, x: torch.Tensor,
                        cache: dict, memory=None, seqs=(None, None)):
        """A group over a full sequence, unit i's weights ``unit(i)``: its
        states and its K and V written into ``cache`` (on a mesh the
        rank's shard, ``seqs`` the sequence shards of its caches,
        ``_seqs``); returns x."""
        if g.kind in CROSS:
            return self._run_cross_full(g, unit, x, memory, cache, seqs[1])
        if g.kind == "dense_sb":
            return self._run_sb_full(g, unit, x, cache, seqs)
        cfg = self.cfg
        for i in range(g.n):
            p = unit(i)
            if g.kind == "ssd":
                x, cache["ssm"][i], cache["conv"][i] = _ssd_unit_apply(
                    p, x, cfg, want_state=True)
                continue
            if g.kind == "rec":
                x, cache["h"][i], cache["conv"][i] = _rec_unit_apply(
                    p, x, cfg, want_state=True)
                continue
            if g.kind == "griffin":
                x, states, k, v = _griffin_unit_apply(p, x, cfg)
                for name, s in zip(("h0", "conv0", "h1", "conv1"), states):
                    cache[name][i] = s
            else:
                fn = _dense_unit_apply if g.kind == "dense" else _moe_unit_apply
                x, k, v = fn(p, x, cfg, window=g.windows[i],
                             theta=g.thetas[i])[:3]
            # the K and V attention used: the reference recomputes the
            # same values from the unit's input (attn_cache_from)
            _cache_put(_layer(cache, i), k, v, seqs[0])
        return x

    def _run_sb_full(self, g: GroupSpec, unit, x: torch.Tensor, cache: dict,
                     seqs) -> torch.Tensor:
        """A ``dense_sb`` group over a full sequence: each local unit's K
        and V in its ring (sequence shard ``seqs[0]``), each global unit's
        in its cache's first T slots (``seqs[1]``)."""
        cfg = self.cfg
        ring, full = seqs
        for i in range(g.n):
            p = unit(i)
            for j in range(cfg.local_per_global):
                x, k, v = _dense_unit_apply(_layer(p["loc"], j), x, cfg,
                                            window=cfg.window,
                                            theta=cfg.rope_theta)
                _cache_put({name: a[i, j] for name, a in cache["loc"].items()},
                           k, v, ring)
            x, k, v = _dense_unit_apply(p["glob"], x, cfg, window=None,
                                        theta=_theta_global(cfg))
            _cache_put(_layer(cache["glob"], i), k, v, full)
        return x

    def _run_cross_full(self, g: GroupSpec, unit, x: torch.Tensor,
                        memory: torch.Tensor, cache: dict,
                        seq=None) -> torch.Tensor:
        """A vlm or dec group over a full sequence: the self layers' K and
        V in the caches' first T slots (sequence shard ``seq``) and each
        cross layer's K and V of ``memory``."""
        cfg = self.cfg
        for i in range(g.n):
            p = unit(i)
            if g.kind == "vlm":
                for j in range(cfg.cross_attn_every):
                    x, k, v = _dense_unit_apply(_layer(p["self"], j), x, cfg,
                                                window=None,
                                                theta=cfg.rope_theta)
                    _cache_put({name: cache[name][i, j]
                                for name in ("k", "v", "pos")}, k, v, seq)
                mkv = attn.cross_kv(p["cross"]["attn"], memory, cfg)
                x = _cross_apply(p["cross"], x, mkv, cfg)
            else:
                mkv = attn.cross_kv(p["cross_attn"], memory, cfg)
                x, k, v = _dec_unit_apply(p, x, mkv, cfg)
                _cache_put({name: cache[name][i] for name in ("k", "v", "pos")},
                           k, v, seq)
            cache["cross_k"][i] = mkv["k"]
            cache["cross_v"][i] = mkv["v"]
        return x

    # -- training loss --------------------------------------------------------
    def loss(self, params: dict, batch: dict):
        """batch {"inputs", "labels": (B, T) token ids, optional "mask"
        (B, T), and the vlm's "vision" or whisper's "audio_frames"} ->
        (total, {"ce", "aux"}): the next-token CE in float32
        (``chunked_cross_entropy`` when ``cfg.logits_chunk`` is set), and
        the auxiliary loss, the float32 sum of the moe layers' Switch
        losses (0 without a moe group); total = ce + 0.01 aux.

        Under a mesh (``_loss_mesh``): ``batch`` is the global batch and
        ``params`` the rank's training shard (``rules.training_shard``:
        each leaf's block under ``rules.param_spec``); total, ce and aux
        are the global batch's on every rank, and a backward gives each
        leaf of the shard its block of the global loss's gradient. A
        ``pod`` axis raises ``NotImplementedError`` naming ROADMAP queue
        1's "the pod axis over a mesh"."""
        cfg = self.cfg
        on = self._on_mesh(params, batch["inputs"].shape[0], train=True)
        if on is not None:
            return self._loss_mesh(params, batch, on)
        memory = self._inject_memory(params, batch)
        x = embed(params["embed"], batch["inputs"], cfg)
        feats, aux, _ = self._backbone(params, x, memory=memory)
        labels = batch["labels"]
        mask = batch.get("mask")
        table = self._table(params)
        if cfg.logits_chunk:
            ce = chunked_cross_entropy(feats, table, labels, cfg.logits_chunk,
                                       mask)
        else:
            ce = lm_cross_entropy(feats, table, labels, mask)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def _loss_mesh(self, params: dict, batch: dict, on: _OnMesh):
        """``loss`` in the reference's ``train_4k`` layout: the rank's rows
        of the batch (over ``data``), and of the memory, through its
        units, each gathering its FSDP weights over ``data`` on use and
        splitting its heads, MLP width, SSD heads or RG-LRU width (and on
        the moe units its experts, on ``moe_apply``'s branch of the
        global batch) over ``model``; the vocab-parallel CE
        (``mesh_cross_entropy``) summed over the batch's rows on every
        rank."""
        cfg = self.cfg
        t = batch["inputs"].shape[1]
        memory = self._inject_memory(params, batch, on)
        emb, norm, table = on.top(params)
        x = embed(emb, on.take_rows(batch["inputs"]), cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, g in enumerate(self.groups):
            branch = on.moe_branch(t) if g.kind == "moe" else None
            x, aux = self._run_group_train(
                g, params[f"group{gi}"], x, aux, memory,
                weights=on.unit_of(f"group{gi}", branch))
        feats = rmsnorm(norm, x)
        mask = batch.get("mask")
        ce = mesh_cross_entropy(
            feats, table, on.take_rows(batch["labels"]),
            None if mask is None else on.take_rows(mask), vocab=cfg.vocab,
            chunk=cfg.logits_chunk, model=on.lay.model,
            model_index=on.lay.model_index, rows=on.row_group)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # -- prefill --------------------------------------------------------------
    def prefill(self, params: dict, batch: dict, *,
                cache_len: "int | None" = None):
        """batch {"inputs": (B, T) token ids, and the vlm's "vision" or
        whisper's "audio_frames"} -> (last-position logits (B, vocab),
        decode state with KV caches of ``cache_len`` slots). An ``ssd``
        group needs T to be at most ``cfg.ssm_chunk`` or a multiple of it
        (``ssd_scan``).

        Under a mesh: ``batch`` holds the global batch's token ids (and
        memory inputs) and the logits are the global batch's on every
        rank; ``params`` is the rank's serving shard and the state its
        shard under ``rules.state_spec``, with the global ``cache_len``
        beside the index."""
        tokens = batch["inputs"]
        t = tokens.shape[1]
        on = self._on_mesh(params, tokens.shape[0])
        if on is not None:
            return self._prefill_mesh(params, batch, cache_len or t, on)
        memory = self._inject_memory(params, batch)
        x = embed(params["embed"], tokens, self.cfg)
        feats, _, caches = self._backbone(params, x, memory=memory,
                                          cache_len=cache_len or t)
        logits = unembed(self._table(params), feats[:, -1:, :])
        state = {"groups": caches,
                 "index": torch.tensor(t, dtype=torch.int32,
                                       device=tokens.device)}
        return logits[:, 0], state

    def _mesh_states(self, batch: int, cache_len: int, device,
                     memory_len: "int | None" = None) -> list:
        """Each group's zeroed state shard under ``rules.state_spec``: the
        global state's leaves made on the meta device, cut to the rank's
        block (every ``pos`` -1, every other leaf 0)."""
        glob = [self._group_state(g, batch, cache_len, "meta", memory_len)
                for g in self.groups]
        states = [tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                                 device=device), g)
                  for g in rules.shard_tree(get_mesh(), glob,
                                            rules.state_spec, batch=batch)]
        for st in states:
            for cache in (st, *(c for c in st.values() if isinstance(c, dict))):
                if "pos" in cache:
                    cache["pos"].fill_(-1)
        return states

    def _seqs(self, g: GroupSpec, cache_len: int,
              on: "_OnMesh | None") -> tuple:
        """(the sequence shard of group ``g``'s attention caches of
        ``_cache_slots`` slots (a ``dense_sb`` group's local rings), that
        of its caches of ``cache_len`` slots (a ``dense_sb`` group's
        global ones)) on the mesh; (None, None) without one."""
        if on is None:
            return None, None
        return on.seq(_cache_slots(self.cfg, g, cache_len)), on.seq(cache_len)

    def _prefill_mesh(self, params: dict, batch: dict, cache_len: int,
                      on: _OnMesh):
        cfg = self.cfg
        tokens = batch["inputs"]
        t = tokens.shape[1]
        if cache_len < t:
            raise ValueError(f"cache_len {cache_len} < prompt length {t}")
        emb, norm, table = on.top(params)
        x = embed(emb, on.take_rows(tokens), cfg)
        memory = self._inject_memory(params, batch, on)
        caches = self._mesh_states(
            on.batch, cache_len, x.device,
            None if memory is None else memory.shape[1])
        for gi, g in enumerate(self.groups):
            branch = on.moe_branch(t) if g.kind == "moe" else None
            x = self._run_group_full(g, on.unit(params, f"group{gi}", branch),
                                     x, caches[gi], memory,
                                     self._seqs(g, cache_len, on))
        feats = rmsnorm(norm, x)
        logits = unembed(table, feats[:, -1:, :], vocab=cfg.vocab)[:, 0]
        return on.gather_rows(logits), {
            "groups": caches, "cache_len": cache_len,
            "index": torch.tensor(t, dtype=torch.int32, device=tokens.device)}

    # -- zeroed decode state ----------------------------------------------------
    def init_decode_state(self, batch: int, cache_len: int, *, index=None,
                          device: "str | torch.device" = "cuda") -> dict:
        """The zeroed decode state of ``batch`` rows and caches of
        ``cache_len`` slots; under a mesh the rank's shard of it under
        ``rules.state_spec``, with the global ``cache_len`` beside the
        index."""
        dev = resolve_device(device)
        index = torch.as_tensor(cache_len if index is None else index,
                                dtype=torch.int32, device=dev).clone()
        mesh = get_mesh()
        if mesh is not None:
            self._check_mesh(mesh)
            return {"groups": self._mesh_states(batch, cache_len, dev),
                    "cache_len": cache_len, "index": index}
        return {"groups": [self._group_state(g, batch, cache_len, dev)
                           for g in self.groups], "index": index}

    def _group_state(self, g: GroupSpec, batch: int, cache_len: int,
                     dev, memory_len: "int | None" = None) -> dict:
        """A group's zeroed decode state of ``batch`` rows; a vlm or dec
        group's cross K and V over ``memory_len`` memory tokens (the
        config's vision tokens or audio frames by default)."""
        cfg = self.cfg
        if g.kind == "ssd":
            return ssd_mod.make_ssd_state(cfg, g.n, batch, dev)
        if g.kind == "rec":
            return _rec_state(cfg, g.n, batch, dev)
        if g.kind == "griffin":
            return _griffin_state(cfg, g.n, batch,
                                  _cache_slots(cfg, g, cache_len), dev)
        if g.kind == "dense_sb":
            return _sb_state(cfg, g.n, batch, cache_len, dev)
        if g.kind == "vlm":
            return _vlm_state(cfg, g.n, batch, cache_len,
                              memory_len or cfg.vision_tokens, dev)
        if g.kind == "dec":
            return _dec_state(cfg, g.n, batch, cache_len,
                              memory_len or cfg.audio_frames, dev)
        return attn.make_cache(cfg, g.n, batch,
                               _cache_slots(cfg, g, cache_len), dev)

    # -- decode step --------------------------------------------------------------
    def decode_step(self, params: dict, state: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, vocab), new state). The caches and
        recurrent states of ``state`` are updated in place and carried
        into the new state; its index is ``state["index"] + 1``. A cross
        layer reads its K and V from the state. Under a mesh, tokens and
        logits are the global batch's, ``state`` the rank's shard (as
        ``prefill`` and ``init_decode_state`` make it; each cache written
        by the rank that owns its slot ``index % slots``) and its index
        the global batch's."""
        cfg = self.cfg
        on = self._on_mesh(params, tokens.shape[0])
        index = state["index"]
        if on is None:
            emb, norm, table = (params["embed"], params["final_norm"],
                                self._table(params))
            idx, seq, vocab = index, None, None
        else:
            if "cache_len" not in state:
                raise ValueError("decode over a mesh takes the state that "
                                 "prefill or init_decode_state made under it")
            idx = on.take_rows(index) if index.ndim else index
            emb, norm, table = on.top(params)
            tokens, vocab = on.take_rows(tokens), cfg.vocab
        x = embed(emb, tokens, cfg)
        for gi, g in enumerate(self.groups):
            gc = state["groups"][gi]
            unit = (functools.partial(_layer, params[f"group{gi}"])
                    if on is None else on.unit(
                        params, f"group{gi}",
                        on.moe_branch(1) if g.kind == "moe" else None))
            seq, full = self._seqs(g, state.get("cache_len"), on)
            for i in range(g.n):
                p = unit(i)
                if g.kind == "ssd":
                    h, gc["ssm"][i], gc["conv"][i] = ssd_mod.ssd_decode_step(
                        p["ssd"], rmsnorm(p["ln1"], x), cfg,
                        ssm_state=gc["ssm"][i], conv_state=gc["conv"][i])
                    x = x + h
                elif g.kind == "rec":
                    x, gc["h"][i], gc["conv"][i] = _rec_unit_decode(
                        p, x, gc["h"][i], gc["conv"][i], cfg)
                elif g.kind == "griffin":
                    x, gc["h0"][i], gc["conv0"][i] = _rec_unit_decode(
                        p["rec0"], x, gc["h0"][i], gc["conv0"][i], cfg)
                    x, gc["h1"][i], gc["conv1"][i] = _rec_unit_decode(
                        p["rec1"], x, gc["h1"][i], gc["conv1"][i], cfg)
                    x, _ = _dense_unit_decode(
                        p["attn"], x, _layer(gc, i), idx, cfg,
                        window=cfg.window, theta=cfg.rope_theta, seq=seq)
                elif g.kind == "dense_sb":
                    for j in range(cfg.local_per_global):
                        ring = {name: a[i, j] for name, a in gc["loc"].items()}
                        x, _ = _dense_unit_decode(
                            _layer(p["loc"], j), x, ring, idx, cfg,
                            window=cfg.window, theta=cfg.rope_theta, seq=seq)
                    x, _ = _dense_unit_decode(
                        p["glob"], x, _layer(gc["glob"], i), idx, cfg,
                        window=None, theta=_theta_global(cfg), seq=full)
                elif g.kind == "vlm":
                    for j in range(cfg.cross_attn_every):
                        self_cache = {name: gc[name][i, j]
                                      for name in ("k", "v", "pos")}
                        x, _ = _dense_unit_decode(
                            _layer(p["self"], j), x, self_cache, idx, cfg,
                            window=None, theta=cfg.rope_theta, seq=full)
                    mkv = {"k": gc["cross_k"][i], "v": gc["cross_v"][i]}
                    x = _cross_apply(p["cross"], x, mkv, cfg)
                elif g.kind == "dec":
                    h, _ = attn.attn_decode(
                        p["self_attn"], rmsnorm(p["ln1"], x), _layer(gc, i),
                        idx, cfg, theta=cfg.rope_theta, seq=full)
                    mkv = {"k": gc["cross_k"][i], "v": gc["cross_v"][i]}
                    x = _dec_tail(p, x + h, mkv, cfg)
                else:
                    fn = (_dense_unit_decode if g.kind == "dense"
                          else _moe_unit_decode)
                    x, _ = fn(p, x, _layer(gc, i), idx, cfg,
                              window=g.windows[i], theta=g.thetas[i],
                              seq=seq)
        logits = unembed(table, rmsnorm(norm, x), vocab=vocab)[:, 0]
        new = {"groups": state["groups"], "index": index + 1}
        if on is None:
            return logits, new
        return on.gather_rows(logits), {**new,
                                        "cache_len": state["cache_len"]}
