"""Language-model assembly, the counterpart of ``repro.models.lm``.

A model is a sequence of layer groups; each group is a homogeneous stack
of units whose parameters are stacked along a leading layer axis, the
reference's (L, ...) layout, and run by a Python loop over the layers.
Per-layer metadata (gemma3's 5 local : 1 global windows and thetas) is
host ints and floats.

The ``dense`` group kind is ported for serving (``init``, ``prefill``,
``init_decode_state``, ``decode_step``) and for training (``loss``, whose
backbone builds no cache and, with ``cfg.remat``, recomputes each unit
in the backward as the reference's ``jax.checkpoint`` does). The other
kinds raise ``NotImplementedError`` naming the ROADMAP item that brings
them.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    ModelConfig,
    chunked_cross_entropy,
    dense_init,
    embed,
    embedding_init,
    lm_cross_entropy,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
)

# group kinds of later slices -> what ROADMAP (queue 1, item 3: the other
# LM families) calls them
_LATER = {"moe": "moe", "ssd": "ssd", "rec": "rglru/griffin",
          "griffin": "rglru/griffin", "vlm": "vlm", "dec": "audio",
          "enc": "audio", "dense_sb": "dense_sb (right-sized caches)"}


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

def _dense_unit_init(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    """``n`` stacked dense units."""
    dev = gen.device
    p = {
        "ln1": rmsnorm_init((n, cfg.d_model), cfg, dev),
        "attn": attn.attention_init(gen, cfg, lead=(n,)),
        "ln2": rmsnorm_init((n, cfg.d_model), cfg, dev),
        "mlp": mlp_init(gen, cfg, lead=(n,)),
    }
    if cfg.qk_norm:  # gemma3 sandwich norms
        p["ln1_post"] = rmsnorm_init((n, cfg.d_model), cfg, dev)
        p["ln2_post"] = rmsnorm_init((n, cfg.d_model), cfg, dev)
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
                      theta: float) -> torch.Tensor:
    """One unit over a full sequence, its output alone (training)."""
    return _dense_unit_apply(p, x, cfg, window=window, theta=theta)[0]


def _dense_unit_decode(p: dict, x: torch.Tensor, cache: dict,
                       index: torch.Tensor, cfg: ModelConfig, *,
                       window: int, theta: float):
    h, cache = attn.attn_decode(p["attn"], rmsnorm(p["ln1"], x), cache,
                                index, cfg, window=window, theta=theta)
    return _mlp_half(p, x, h, cfg), cache


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


class LM:
    """Model wrapper for one ModelConfig (serving path, dense kind)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.groups = build_groups(cfg)
        for g in self.groups:
            if g.kind != "dense":
                raise NotImplementedError(
                    f"{cfg.arch_id}: the {g.kind!r} group kind comes with "
                    f"ROADMAP queue 1, item 3 (the other LM families: "
                    f"{_LATER[g.kind]}); the port has 'dense'")

    # -- init ----------------------------------------------------------------
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters on the generator's device, drawn from it."""
        cfg = self.cfg
        params: dict = {"embed": embedding_init(gen, cfg),
                        "final_norm": rmsnorm_init((cfg.d_model,), cfg,
                                                   gen.device)}
        if not cfg.tied_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                           cfg.d_model, cfg.param_dtype)
        for gi, g in enumerate(self.groups):
            params[f"group{gi}"] = _dense_unit_init(gen, cfg, g.n)
        return params

    def _table(self, params: dict) -> torch.Tensor:
        return (params["lm_head"].T if "lm_head" in params
                else params["embed"]["table"])

    # -- full-sequence forward ------------------------------------------------
    def _backbone(self, params: dict, x: torch.Tensor, *,
                  cache_len: "int | None" = None):
        """Run all groups over full sequences. Returns (features, the KV
        cache of each group with ``cache_len`` slots); with ``cache_len``
        None no cache is built (training, features) and the second item
        is None."""
        caches = []
        for gi, g in enumerate(self.groups):
            gp = params[f"group{gi}"]
            if cache_len is None:
                x = self._run_group_train(g, gp, x)
            else:
                x, cache = self._run_group_full(g, gp, x, cache_len=cache_len)
                caches.append(cache)
        return (rmsnorm(params["final_norm"], x),
                None if cache_len is None else caches)

    def _run_group_train(self, g: GroupSpec, gp: dict,
                         x: torch.Tensor) -> torch.Tensor:
        """The group's units without caches. With ``cfg.remat`` and
        autograd recording, each unit keeps only its input for the
        backward and runs again there (the reference's per-unit
        ``jax.checkpoint``), so its attention's forward kernel launches
        twice in a training step."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i, p in enumerate(_units(gp, g.n)):
            args = (p, x, self.cfg, g.windows[i], g.thetas[i])
            x = (checkpoint(_dense_unit_train, *args, use_reentrant=False)
                 if remat else _dense_unit_train(*args))
        return x

    def _run_group_full(self, g: GroupSpec, gp: dict, x: torch.Tensor, *,
                        cache_len: int):
        b, t, _ = x.shape
        if cache_len < t:
            raise ValueError(f"cache_len {cache_len} < prompt length {t}")
        cache = attn.make_cache(self.cfg, g.n, b, cache_len, x.device)
        cache["pos"][:, :, :t] = torch.arange(t, dtype=torch.int32,
                                              device=x.device)
        for i in range(g.n):
            x, k, v = _dense_unit_apply(_layer(gp, i), x, self.cfg,
                                        window=g.windows[i],
                                        theta=g.thetas[i])
            # the K and V attention used: the reference recomputes the
            # same values from the unit's input (attn_cache_from)
            cache["k"][i, :, :t] = k
            cache["v"][i, :, :t] = v
        return x, cache

    # -- training loss --------------------------------------------------------
    def loss(self, params: dict, batch: dict):
        """batch {"inputs", "labels": (B, T) token ids, optional "mask"
        (B, T)} -> (total, {"ce", "aux"}): the next-token CE in float32
        (``chunked_cross_entropy`` when ``cfg.logits_chunk`` is set), and
        the auxiliary loss, 0 for the dense kind; total = ce + 0.01 aux."""
        cfg = self.cfg
        x = embed(params["embed"], batch["inputs"], cfg)
        feats, _ = self._backbone(params, x)
        labels = batch["labels"]
        mask = batch.get("mask")
        table = self._table(params)
        if cfg.logits_chunk:
            ce = chunked_cross_entropy(feats, table, labels, cfg.logits_chunk,
                                       mask)
        else:
            ce = lm_cross_entropy(feats, table, labels, mask)
        aux = torch.zeros((), dtype=torch.float32, device=feats.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # -- prefill --------------------------------------------------------------
    def prefill(self, params: dict, batch: dict, *,
                cache_len: "int | None" = None):
        """batch {"inputs": (B, T) token ids} -> (last-position logits
        (B, vocab), decode state with caches of ``cache_len`` slots)."""
        tokens = batch["inputs"]
        t = tokens.shape[1]
        x = embed(params["embed"], tokens, self.cfg)
        feats, caches = self._backbone(params, x, cache_len=cache_len or t)
        logits = unembed(self._table(params), feats[:, -1:, :])
        state = {"groups": caches,
                 "index": torch.tensor(t, dtype=torch.int32,
                                       device=tokens.device)}
        return logits[:, 0], state

    # -- zeroed decode state ----------------------------------------------------
    def init_decode_state(self, batch: int, cache_len: int, *, index=None,
                          device: "str | torch.device" = "cuda") -> dict:
        dev = resolve_device(device)
        states = [attn.make_cache(self.cfg, g.n, batch, cache_len, dev)
                  for g in self.groups]
        index = cache_len if index is None else index
        return {"groups": states,
                "index": torch.as_tensor(index, dtype=torch.int32,
                                         device=dev).clone()}

    # -- decode step --------------------------------------------------------------
    def decode_step(self, params: dict, state: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, vocab), new state). The caches of
        ``state`` are updated in place and carried into the new state;
        its index is ``state["index"] + 1``."""
        cfg = self.cfg
        index = state["index"]
        x = embed(params["embed"], tokens, cfg)
        for gi, g in enumerate(self.groups):
            gp, gc = params[f"group{gi}"], state["groups"][gi]
            for i in range(g.n):
                x, _ = _dense_unit_decode(_layer(gp, i), x, _layer(gc, i),
                                          index, cfg, window=g.windows[i],
                                          theta=g.thetas[i])
        x = rmsnorm(params["final_norm"], x)
        logits = unembed(self._table(params), x)[:, 0]
        return logits, {"groups": state["groups"], "index": index + 1}
