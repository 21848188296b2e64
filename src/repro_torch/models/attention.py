"""Grouped-query attention with RoPE, sliding windows, KV caches and
cross attention.

The counterpart of ``repro.models.attention`` for serving and training:

  * ``attn_full``   — full-sequence self-attention (prefill, and the
                      training forward: no cache, rope and the
                      projections differentiable), through the
                      ``flash_attention`` op (the CUDA kernels on the
                      card, the backward kernel for its gradient)
  * ``attn_decode`` — one-token step against a cache
  * ``attn_cross``  — cross attention over a memory's precomputed K and
                      V (``cross_kv``): the vlm's vision tokens,
                      whisper's encoder output; non-causal, no rope,
                      plain float32 products as the reference's einsums

Caches store the absolute position of each slot per batch row (``pos``,
-1 = empty), so every row may sit at its own decode index.

On a mesh (``sharding.ctx.use_mesh``) ``attn_full_kv``,
``attn_decode``, ``cross_kv`` and ``attn_cross`` take the rank's
``model`` block of the heads of ``wq``/``wo`` (and of ``wk``/``wv``
where their heads divide, else the whole of them): a prefill projects
and attends over the rank's heads (the flash kernel on those heads
alone), sums ``wo``'s partial outputs over ``model`` and returns K and V
of every KV head for the cache; a decode step is sequence-parallel over
the cache's slots, as the reference's: q replicated over ``model``,
each rank's slots scored, the softmax's max and sum and the
probability-weighted V summed over the cache's sequence shards
(``SeqShard``, whose ``slots`` is the cache's own length: a right-sized
ring's ``min(window, cache_len)``), a sliding window's mask read from
each slot's global position; cross attention runs the rank's q heads
over the memory's K and V, which every rank holds whole. In training
(``attn_full``) the rank's heads run through the flash kernels' forward
and backward, the input's cotangent summed over ``model`` and ``wo``'s
partial outputs summed forward; no K and V are gathered, a cross
layer's neither (its q heads read the KV heads of the rank's block
alone), and its backward sums the cotangents of its queries' input and
of the memory over ``model``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import (
    ModelConfig,
    dense_init,
    residual_out_init,
    rmsnorm,
)
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.ctx import get_mesh

NEG_INF = -2.0**30  # large-negative instead of -inf: masked softmax stays NaN-free


def attention_init(gen: torch.Generator, cfg: ModelConfig, lead=(), *,
                   d_kv_in: "int | None" = None) -> dict:
    """QKV and output projections; ``lead`` prepends stacking axes;
    ``d_kv_in`` is the width K and V are projected from (a cross
    attention's memory; default ``d_model``)."""
    h, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    d_kv = d_kv_in or d
    dt, dev = cfg.param_dtype, gen.device
    p = {
        "wq": dense_init(gen, (*lead, d, h, dh), d, dt),
        "wk": dense_init(gen, (*lead, d_kv, hkv, dh), d_kv, dt),
        "wv": dense_init(gen, (*lead, d_kv, hkv, dh), d_kv, dt),
        "wo": residual_out_init(gen, (*lead, h, dh, d), h * dh, cfg),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h, dh), dtype=dt, device=dev)
        p["bk"] = torch.zeros((*lead, hkv, dh), dtype=dt, device=dev)
        p["bv"] = torch.zeros((*lead, hkv, dh), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.zeros((*lead, dh), dtype=dt, device=dev)}
        p["k_norm"] = {"scale": torch.zeros((*lead, dh), dtype=dt, device=dev)}
    return p


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x (..., T, H, Dh), positions (T,) or (B, T).
    Angles in float32 from ``theta ** -(arange(half) / half)``; the two
    halves are rotated."""
    dh = x.shape[-1]
    half = dh // 2
    freq_exp = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    inv_freq = float(theta) ** (-freq_exp)  # float32 pow, no host-to-device copy
    angles = positions[..., None].float() * inv_freq  # (..., T, half)
    if angles.ndim == 2:  # (T, half) -> broadcast over batch
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :]  # (B?, T, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bthk") as one matmul."""
    d, heads, dh = w.shape
    return (x @ w.to(x.dtype).reshape(d, heads * dh)).unflatten(-1, (heads, dh))


def _qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
         q_heads: slice = slice(None), kv_heads: slice = slice(None)):
    """q, k, v of the projections' heads; the (whole) biases' rows
    ``q_heads`` and ``kv_heads`` are those heads'. On a mesh x is read by
    every rank of ``model``, each projecting its own heads: its cotangent
    is summed over ``model`` (``tensor_parallel.replicated_input``)."""
    heads = _heads(params, cfg)
    if heads.lay is not None:
        x = tp.replicated_input(x, heads.lay.model)
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"][q_heads].to(x.dtype)
        k = k + params["bk"][kv_heads].to(x.dtype)
        v = v + params["bv"][kv_heads].to(x.dtype)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return q, k, v


def _out(params: dict, o: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bthk,hkd->btd") as one matmul."""
    h, dh, d = params["wo"].shape
    return o.flatten(-2) @ params["wo"].to(dtype).reshape(h * dh, d)


class Heads(NamedTuple):
    """The heads a rank's projections hold: q heads [q0, q0 + hq) of
    ``wq`` and ``wo``, KV heads [k0, k0 + hk) of ``wk`` and ``wv``;
    ``lay`` the rank's ``tensor_parallel.Layout`` (None: whole
    projections, no collective; else ``wq``'s heads are split, and
    ``wk``'s too where hk < Hkv)."""

    lay: object
    q0: int
    hq: int
    k0: int
    hk: int


def _heads(params: dict, cfg: ModelConfig) -> Heads:
    """The heads of the rank's projections: fewer than the config's are
    its ``model`` block (``rules.serving_param_spec``; ``wk``/``wv`` stay
    whole where their heads do not divide over ``model``)."""
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    hq, hk = params["wq"].shape[-2], params["wk"].shape[-2]
    mesh = get_mesh()
    if mesh is None or (hq == h and hk == hkv):
        return Heads(None, 0, h, 0, hkv)
    lay = tp.layout(mesh)
    m = lay.model_index
    return Heads(lay, m * hq if hq < h else 0, hq, m * hk if hk < hkv else 0,
                 hk)


def _kv_of_q_heads(k: torch.Tensor, heads: Heads, cfg: ModelConfig):
    """The KV heads (B, T, ., Dh) of ``k`` (heads [k0, k0 + hk)) that the
    rank's q heads read, q head j reading KV head j // (H / Hkv): a run
    of heads each read by a group of q heads, one head read by all, or
    else one KV head a q head."""
    group = cfg.n_heads // cfg.n_kv_heads
    first = heads.q0 // group
    last = (heads.q0 + heads.hq - 1) // group
    if (heads.q0 % group == 0 and heads.hq % group == 0) or first == last:
        return k[:, :, first - heads.k0:last + 1 - heads.k0]
    ids = torch.arange(heads.q0, heads.q0 + heads.hq, device=k.device)
    return k[:, :, ids // group - heads.k0]


def attn_full_kv(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 causal: bool = True, window: "int | None" = None,
                 theta: "float | None" = None, want_kv: bool = True):
    """``attn_full`` that also returns the rotated K and the V it
    attended over, (B, T, Hkv, Dh) each: prefill caches them. On a mesh
    the kernel runs on the rank's q heads and the KV heads they read,
    and K and V come back with every KV head (all-gathered over
    ``model`` where ``wk`` holds a block of them; not without
    ``want_kv``, as in training, where the rank's own are returned)."""
    t = x.shape[1]
    theta = cfg.rope_theta if theta is None else theta
    positions = torch.arange(t, device=x.device)
    heads = _heads(params, cfg)
    q, k, v = _qkv(params, x, cfg, slice(heads.q0, heads.q0 + heads.hq),
                   slice(heads.k0, heads.k0 + heads.hk))
    if theta is not None:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    if heads.lay is None:
        o = kops.flash_attention(q, k.contiguous(), v.contiguous(),
                                 causal=causal, window=window)
        return _out(params, o, x.dtype), k, v
    o = kops.flash_attention(q, _kv_of_q_heads(k, heads, cfg).contiguous(),
                             _kv_of_q_heads(v, heads, cfg).contiguous(),
                             causal=causal, window=window)
    out = tp.sum_over(_out(params, o, x.dtype), heads.lay.model)
    if want_kv and heads.hk < cfg.n_kv_heads:
        k, v = tp.gather_fused([k, v], heads.lay.model, [2, 2])
    return out, k, v


def attn_full(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True, window: "int | None" = None,
              theta: "float | None" = None) -> torch.Tensor:
    """Full-sequence self-attention (prefill, training). x (B, T, D)."""
    return attn_full_kv(params, x, cfg, causal=causal, window=window,
                        theta=theta, want_kv=False)[0]


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def make_cache(cfg: ModelConfig, n_layers: int, batch: int, length: int,
               device, dtype=None) -> dict:
    """Stacked (per-layer) attention cache with per-row absolute slot
    positions: k, v (L, B, S, Hkv, Dh), pos (L, B, S) int32, -1 = empty."""
    dtype = dtype or cfg.dtype
    shape = (n_layers, batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((n_layers, batch, length), -1, dtype=torch.int32,
                          device=device),
    }


class SeqShard(NamedTuple):
    """A cache's sequence shard on a mesh: slots [offset, offset + S) of
    ``slots`` (S the local cache's), the other shards on the ranks of
    ``group`` (None: the whole sequence is here)."""

    offset: int
    slots: int
    group: object


def _write_slot(cache: torch.Tensor, rows, slot, value, seq: SeqShard):
    """Row r's value into slot ``slot[r]`` of the rank's shard (slot
    offset ``seq.offset``), on the rank that owns it; elsewhere the slot
    keeps its value (clamped in range, so no row syncs the host)."""
    s = cache.shape[1]
    local = slot - seq.offset
    owned = (local >= 0) & (local < s)
    local = local.clamp(0, s - 1)
    mask = owned.reshape(-1, *([1] * (value.ndim - 1)))
    cache[rows, local] = torch.where(mask, value, cache[rows, local])


def attn_decode(params: dict, x: torch.Tensor, layer_cache: dict,
                index: torch.Tensor, cfg: ModelConfig, *,
                window: "int | None" = None, theta: "float | None" = None,
                seq: "SeqShard | None" = None):
    """One decode step. x (B, 1, D); ``layer_cache`` one layer's
    {"k", "v": (B, S, Hkv, Dh), "pos": (B, S)}; ``index`` a scalar or
    (B,) tensor of absolute positions (rows may differ). Returns
    (out (B, 1, D), layer_cache).

    The cache is written in place (an index write at slot index % S of
    each row, the values the reference's one-hot ``where`` writes), so
    the returned cache is the one passed in.

    On a mesh, x holds the rank's batch rows and ``seq`` places the
    cache's slots: q, K and V of the new token come from the rank's
    heads, all-gathered over ``model`` (q is replicated there); the rank
    that owns slot index % slots writes it; the softmax runs over the
    slots of every shard of ``seq.group`` (its max and sum reduced over
    it, then the rounded probabilities times V summed over it).
    """
    b = x.shape[0]
    theta = cfg.rope_theta if theta is None else theta
    idx = torch.as_tensor(index, device=x.device).to(torch.int64).reshape(-1)
    idx = idx.expand(b)
    pos = idx[:, None]  # (B, 1) positions for rope
    heads = _heads(params, cfg)
    q, k_new, v_new = _qkv(params, x, cfg, slice(heads.q0, heads.q0 + heads.hq),
                           slice(heads.k0, heads.k0 + heads.hk))
    if theta is not None:
        q = rope(q, pos, theta)
        k_new = rope(k_new, pos, theta)
    if heads.lay is not None and heads.hk < cfg.n_kv_heads:
        # every KV head a block of the rank's: so are its q heads
        q, k_new, v_new = tp.gather_fused([q, k_new, v_new],
                                          heads.lay.model, [2, 2, 2])
    elif heads.lay is not None:
        q = tp.gather(q, heads.lay.model, 2)

    k, v, pos_arr = layer_cache["k"], layer_cache["v"], layer_cache["pos"]
    rows = torch.arange(b, device=x.device)
    if seq is None or seq.slots == k.shape[1]:
        slot = torch.remainder(idx, k.shape[1])
        k[rows, slot] = k_new[:, 0].to(k.dtype)
        v[rows, slot] = v_new[:, 0].to(v.dtype)
        pos_arr[rows, slot] = idx.to(pos_arr.dtype)
    else:
        slot = torch.remainder(idx, seq.slots)
        _write_slot(k, rows, slot, k_new[:, 0].to(k.dtype), seq)
        _write_slot(v, rows, slot, v_new[:, 0].to(v.dtype), seq)
        _write_slot(pos_arr, rows, slot, idx.to(pos_arr.dtype), seq)
    seq_group = None if seq is None else seq.group

    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    group = cfg.n_heads // hkv
    scale = dh**-0.5
    # q * scale is rounded to x's dtype, then to the cache's, as the
    # reference does. The reference accumulates both products in float32
    # (preferred_element_type); a bfloat16 torch.matmul would round its
    # output to bfloat16, so the operands are upcast to float32 instead:
    # the products of bfloat16 values are exact in float32, and float32
    # matmuls run without TF32 unless a caller enables it.
    qs = (q * scale).to(k.dtype).float().reshape(b, hkv, group, dh)
    logits = qs @ k.float().permute(0, 2, 3, 1)  # (B, Hkv, G, S)
    valid = (pos_arr >= 0) & (pos_arr <= idx[:, None])  # (B, S)
    if window is not None and window > 0:
        valid &= pos_arr > (idx[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    if seq_group is None:
        probs = torch.softmax(logits, dim=-1)
    else:
        top = tp.max_over(logits.amax(dim=-1, keepdim=True), seq_group)
        e = torch.exp(logits - top)
        probs = e / tp.sum_over(e.sum(dim=-1, keepdim=True), seq_group)
    o = probs.to(v.dtype).float() @ v.float().transpose(1, 2)  # (B, Hkv, G, Dh)
    o = tp.sum_over(o, seq_group)
    o = o.reshape(b, 1, cfg.n_heads, dh).to(x.dtype)
    if heads.lay is None:
        return _out(params, o, x.dtype), layer_cache
    out = _out(params, o[:, :, heads.q0:heads.q0 + heads.hq], x.dtype)
    return tp.sum_over(out, heads.lay.model), layer_cache


# ---------------------------------------------------------------------------
# cross attention (vlm, whisper's decoder)
# ---------------------------------------------------------------------------

def cross_kv(params: dict, memory: torch.Tensor, cfg: ModelConfig, *,
             whole: bool = True) -> dict:
    """K and V of a memory (B, S, Dm), {"k", "v": (B, S, Hkv, Dh)} in the
    memory's dtype, with the bias and ``k_norm`` where the layer has them
    (no rope). Computed once a prefill; decode reads them from its state.
    On a mesh ``wk`` and ``wv`` may hold the rank's block of the KV
    heads: K and V of those heads, all-gathered over ``model`` with
    ``whole`` (the serving state keeps them whole there), else left as
    the rank's block (training: the rank's q heads read those heads
    alone); the memory's cotangent is summed over ``model`` (each rank's
    heads read a part of it)."""
    heads = _heads(params, cfg)
    kv = slice(heads.k0, heads.k0 + heads.hk)
    if heads.lay is not None:
        memory = tp.replicated_input(memory, heads.lay.model)
    k = _proj(memory, params["wk"])
    v = _proj(memory, params["wv"])
    if "bk" in params:
        k = k + params["bk"][kv].to(memory.dtype)
        v = v + params["bv"][kv].to(memory.dtype)
    if "k_norm" in params:
        k = rmsnorm(params["k_norm"], k)
    if whole and heads.lay is not None and heads.hk < cfg.n_kv_heads:
        k, v = tp.gather_fused([k, v], heads.lay.model, [2, 2])
    return {"k": k, "v": v}


def attn_cross(params: dict, x: torch.Tensor, memory_kv: dict,
               cfg: ModelConfig) -> torch.Tensor:
    """Cross attention of queries x (B, T, D) over ``memory_kv``
    (``cross_kv``'s K and V): non-causal, no rope, no query bias. As the
    reference: ``q * scale`` is rounded in x's dtype, then it, K and V
    are upcast to float32 for both products and the softmax, and the
    output is cast back to x's dtype. Each query group's T rows are one
    matrix (B, Hkv, G T, Dh), so neither product broadcasts K or V over
    the group. On a mesh the rank's q heads attend over the KV heads they
    read (of ``memory_kv``'s: every KV head, or the rank's block of them)
    and ``wo``'s partial outputs are summed over ``model``, x's cotangent
    too in the backward."""
    b, t, _ = x.shape
    dh = cfg.head_dim
    heads = _heads(params, cfg)
    if heads.lay is not None:
        x = tp.replicated_input(x, heads.lay.model)
    q = _proj(x, params["wq"])
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
    k, v = memory_kv["k"], memory_kv["v"]
    if heads.lay is not None:
        # K and V of every KV head, or of the rank's block (cross_kv's)
        held = (heads._replace(k0=0, hk=cfg.n_kv_heads)
                if k.shape[2] == cfg.n_kv_heads else heads)
        k, v = _kv_of_q_heads(k, held, cfg), _kv_of_q_heads(v, held, cfg)
    hkv = k.shape[2]
    group = heads.hq // hkv
    qs = (q * dh**-0.5).float().reshape(b, t, hkv, group, dh)
    qs = qs.permute(0, 2, 3, 1, 4).reshape(b, hkv, group * t, dh)
    logits = qs @ k.float().permute(0, 2, 3, 1)  # (B, Hkv, G T, S)
    probs = torch.softmax(logits, dim=-1)
    del logits
    o = probs @ v.float().transpose(1, 2)  # (B, Hkv, G T, Dh)
    o = o.reshape(b, hkv, group, t, dh).permute(0, 3, 1, 2, 4)
    o = o.reshape(b, t, heads.hq, dh).to(x.dtype)
    if heads.lay is None:
        return _out(params, o, x.dtype)
    return tp.sum_over(_out(params, o, x.dtype), heads.lay.model)
