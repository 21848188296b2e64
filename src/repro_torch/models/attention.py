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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import (
    ModelConfig,
    dense_init,
    residual_out_init,
    rmsnorm,
)

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


def _qkv(params: dict, x: torch.Tensor, cfg: ModelConfig):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return q, k, v


def _out(params: dict, o: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bthk,hkd->btd") as one matmul."""
    h, dh, d = params["wo"].shape
    return o.flatten(-2) @ params["wo"].to(dtype).reshape(h * dh, d)


def attn_full_kv(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 causal: bool = True, window: "int | None" = None,
                 theta: "float | None" = None):
    """``attn_full`` that also returns the rotated K and the V it
    attended over, (B, T, Hkv, Dh) each: prefill caches them."""
    t = x.shape[1]
    theta = cfg.rope_theta if theta is None else theta
    positions = torch.arange(t, device=x.device)
    q, k, v = _qkv(params, x, cfg)
    if theta is not None:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    o = kops.flash_attention(q, k.contiguous(), v.contiguous(), causal=causal,
                             window=window)
    return _out(params, o, x.dtype), k, v


def attn_full(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True, window: "int | None" = None,
              theta: "float | None" = None) -> torch.Tensor:
    """Full-sequence self-attention (prefill). x (B, T, D)."""
    return attn_full_kv(params, x, cfg, causal=causal, window=window,
                        theta=theta)[0]


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


def attn_decode(params: dict, x: torch.Tensor, layer_cache: dict,
                index: torch.Tensor, cfg: ModelConfig, *,
                window: "int | None" = None, theta: "float | None" = None):
    """One decode step. x (B, 1, D); ``layer_cache`` one layer's
    {"k", "v": (B, S, Hkv, Dh), "pos": (B, S)}; ``index`` a scalar or
    (B,) tensor of absolute positions (rows may differ). Returns
    (out (B, 1, D), layer_cache).

    The cache is written in place (an index write at slot index % S of
    each row, the values the reference's one-hot ``where`` writes), so
    the returned cache is the one passed in.
    """
    b = x.shape[0]
    theta = cfg.rope_theta if theta is None else theta
    idx = torch.as_tensor(index, device=x.device).to(torch.int64).reshape(-1)
    idx = idx.expand(b)
    pos = idx[:, None]  # (B, 1) positions for rope
    q, k_new, v_new = _qkv(params, x, cfg)
    if theta is not None:
        q = rope(q, pos, theta)
        k_new = rope(k_new, pos, theta)

    k, v, pos_arr = layer_cache["k"], layer_cache["v"], layer_cache["pos"]
    rows = torch.arange(b, device=x.device)
    slot = torch.remainder(idx, k.shape[1])
    k[rows, slot] = k_new[:, 0].to(k.dtype)
    v[rows, slot] = v_new[:, 0].to(v.dtype)
    pos_arr[rows, slot] = idx.to(pos_arr.dtype)

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
    probs = torch.softmax(logits, dim=-1)
    o = probs.to(v.dtype).float() @ v.float().transpose(1, 2)  # (B, Hkv, G, Dh)
    o = o.reshape(b, 1, cfg.n_heads, dh).to(x.dtype)
    return _out(params, o, x.dtype), layer_cache


# ---------------------------------------------------------------------------
# cross attention (vlm, whisper's decoder)
# ---------------------------------------------------------------------------

def cross_kv(params: dict, memory: torch.Tensor, cfg: ModelConfig) -> dict:
    """K and V of a memory (B, S, Dm), {"k", "v": (B, S, Hkv, Dh)} in the
    memory's dtype, with the bias and ``k_norm`` where the layer has them
    (no rope). Computed once a prefill; decode reads them from its state."""
    k = _proj(memory, params["wk"])
    v = _proj(memory, params["wv"])
    if "bk" in params:
        k = k + params["bk"].to(memory.dtype)
        v = v + params["bv"].to(memory.dtype)
    if "k_norm" in params:
        k = rmsnorm(params["k_norm"], k)
    return {"k": k, "v": v}


def attn_cross(params: dict, x: torch.Tensor, memory_kv: dict,
               cfg: ModelConfig) -> torch.Tensor:
    """Cross attention of queries x (B, T, D) over ``memory_kv``
    (``cross_kv``'s K and V): non-causal, no rope, no query bias. As the
    reference: ``q * scale`` is rounded in x's dtype, then it, K and V
    are upcast to float32 for both products and the softmax, and the
    output is cast back to x's dtype. Each query group's T rows are one
    matrix (B, Hkv, G T, Dh), so neither product broadcasts K or V over
    the group."""
    b, t, _ = x.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    group = cfg.n_heads // hkv
    q = _proj(x, params["wq"])
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
    k, v = memory_kv["k"], memory_kv["v"]
    qs = (q * dh**-0.5).float().reshape(b, t, hkv, group, dh)
    qs = qs.permute(0, 2, 3, 1, 4).reshape(b, hkv, group * t, dh)
    logits = qs @ k.float().permute(0, 2, 3, 1)  # (B, Hkv, G T, S)
    probs = torch.softmax(logits, dim=-1)
    del logits
    o = probs @ v.float().transpose(1, 2)  # (B, Hkv, G T, Dh)
    o = o.reshape(b, hkv, group, t, dh).permute(0, 3, 1, 2, 4)
    o = o.reshape(b, t, cfg.n_heads, dh).to(x.dtype)
    return _out(params, o, x.dtype)
