"""Plain PyTorch versions of the kernels' functions.

Each function keeps the exact op order of its JAX counterpart in
``repro.kernels.ref`` (butterfly stages h = 1, 2, 4, ... with pairs
(a + b, a - b); the 1/sqrt(n) normalization computed in the input
dtype; gather then sqrt(n/k) forward; scale, scatter, FWHT, signs,
slice for the transpose; the codecs' top-k mask and int8 round trip in
the input dtype), so results are bit-equal to it. They are the
CPU path of ``repro_torch.kernels.ops`` and the oracle the CUDA kernels
are held against on the card. ``mha_blocked`` keeps the reference's
blocking and op order too, but its sums run in PyTorch's order, so it
matches the reference to float32 rounding, not bitwise.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# The two scale factors follow the reference's rounding: each step is
# rounded to ``dtype``. Each is computed in Python float64 and then
# rounded, which gives the correctly rounded result in float32 and
# narrower types too (53 >= 2p + 2 bits). ``torch.sqrt`` and the
# reciprocal are not used: on the CPU PyTorch's float64 reciprocal of
# sqrt(32) is one ulp off the correctly rounded value. The factors are
# 0-dim CPU tensors, which PyTorch applies to a tensor on any device as
# scalars, with no host-to-device copy.

def _rounded(v: float, dtype: torch.dtype) -> float:
    return torch.tensor(v, dtype=dtype).item()


def norm_factor(n: int, dtype: torch.dtype) -> torch.Tensor:
    """1/sqrt(n), with sqrt(n) and the quotient each rounded to ``dtype``."""
    return torch.tensor(1.0 / _rounded(math.sqrt(n), dtype), dtype=dtype)


def subsample_scale(n: int, k: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(n/k): the ratio rounded to ``dtype``, then the root."""
    return torch.tensor(math.sqrt(_rounded(n / k, dtype)), dtype=dtype)


def fwht(x: torch.Tensor, *, normalize: bool = False) -> torch.Tensor:
    """Walsh-Hadamard transform along the last axis (length power of two).

    log2(n) butterfly stages of pairwise add/sub; ``normalize`` scales
    by 1/sqrt(n) so the transform is orthonormal.
    """
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT length must be a power of two, got {n}")
    orig_shape = x.shape
    y = x.reshape(-1, n)
    h = 1
    while h < n:
        y = y.reshape(y.shape[0], n // (2 * h), 2, h)
        a = y[:, :, 0, :]
        b = y[:, :, 1, :]
        y = torch.stack([a + b, a - b], dim=2)
        h *= 2
    y = y.reshape(orig_shape)
    if normalize:
        y = y * norm_factor(n, x.dtype)
    return y


def hadamard_matrix(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Dense (unnormalized) Hadamard matrix of size n (power of two)."""
    if n & (n - 1):
        raise ValueError(f"Hadamard size must be a power of two, got {n}")
    h = torch.ones((1, 1), dtype=dtype, device=device)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], dim=1), torch.cat([h, -h], dim=1)])
    return h


def srht_apply(x: torch.Tensor, signs: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """sqrt(n/k) * P * H_n * D restricted to the first dim coordinates.

    x (..., dim) -> (..., k) with n = signs.shape[-1] (a power of two,
    >= dim) and k = rows.shape[-1].

    Batched operators: with ``signs`` (G, n) and ``rows`` (G, k), x is
    (G, ..., dim) and operator g acts on every row under index g, as
    ``repro.kernels.ref.srht_apply`` does under ``jax.vmap``; each slice
    is bit-equal to the one-operator call on it.
    """
    n = signs.shape[-1]
    k = rows.shape[-1]
    pad = n - x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    if signs.ndim == 1:
        xp = xp * signs
        h = fwht(xp, normalize=True)
        scale = subsample_scale(n, k, h.dtype)
        return torch.index_select(h, -1, rows) * scale
    inner = (1,) * (x.ndim - 2)
    xp = xp * signs.reshape(signs.shape[:1] + inner + (n,))
    h = fwht(xp, normalize=True)
    scale = subsample_scale(n, k, h.dtype)
    idx = rows.reshape(rows.shape[:1] + inner + (k,))
    return torch.gather(h, -1, idx.expand(h.shape[:-1] + (k,))) * scale


def srht_apply_rows(a: torch.Tensor, signs: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """S_g @ a_g along the rows of a (G, n_rows, M), one operator a client
    (``signs`` (G, n), ``rows`` (G, k)) -> (G, k, M), contiguous:
    ``srht_apply`` on a's contiguous transpose, transposed back (the
    reference's ``sketch_sqrt_rows`` under ``jax.vmap``)."""
    at = a.transpose(-1, -2).contiguous()
    return srht_apply(at, signs, rows).transpose(-1, -2).contiguous()


def srht_apply_t(y: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """Transpose SRHT: y (..., k) -> (..., dim). The scaled k entries are
    scattered into the padded domain (``rows`` are distinct), the
    inverse ordering of ``srht_apply``."""
    n = signs.shape[-1]
    k = rows.shape[-1]
    scale = subsample_scale(n, k, y.dtype)
    z = torch.zeros(y.shape[:-1] + (n,), dtype=y.dtype, device=y.device)
    z[..., rows] = y * scale
    h = fwht(z, normalize=True)
    h = h * signs
    return h[..., :dim]


# ---------------------------------------------------------------------------
# Transport codec inner loops, one payload per row of (rows, P)
# ---------------------------------------------------------------------------

def topk_mask(x: torch.Tensor, kept: int) -> torch.Tensor:
    """Keep the ``kept`` largest |x| of each row (last axis), zero the
    rest. Ties go to the lowest index, as ``jax.lax.top_k`` breaks them:
    ``torch.topk`` documents no tie order, so the selection is a stable
    descending sort of |x|."""
    order = torch.sort(torch.abs(x), dim=-1, descending=True,
                       stable=True).indices
    idx = order[..., :kept]
    return torch.zeros_like(x).scatter(-1, idx, torch.gather(x, -1, idx))


def qint8_roundtrip(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantize -> dequantize of each row (last axis) with
    caller-supplied stochastic-rounding noise ``u ~ U[0,1)`` of x's
    shape: scale = max(max|x| / 127, tiny), q = clip(floor(x/scale + u),
    -127, 127), out = q * scale. ``tiny`` is the input dtype's, so an
    all-zero row decodes to zeros, not 0/0."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # divide by a tensor on x's device: PyTorch's CUDA division by a host
    # scalar multiplies by its reciprocal, which can differ in the last bit
    scale = torch.clamp(amax / torch.full_like(amax, 127.0),
                        min=torch.finfo(x.dtype).tiny)
    q = torch.clamp(torch.floor(x / scale + u), -127, 127)
    return q * scale


# ---------------------------------------------------------------------------
# Attention: the naive oracle and the blocked online-softmax contract
# ---------------------------------------------------------------------------

MASK_VALUE = -2.0**30  # large-negative, not -inf: masked blocks stay NaN-free


def _no_window(window) -> bool:
    return window is None or window <= 0


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: "int | None" = None, q_offset: int = 0,
        scale: "float | None" = None) -> torch.Tensor:
    """Naive grouped-query attention. q (B, Tq, H, D), k and v
    (B, Tk, Hkv, D); ``window`` keeps the last ``window`` keys (``None``
    is no window; unlike ``mha_blocked`` a window <= 0 is taken as
    given); ``q_offset`` is the absolute position of q[0]. Rows with no
    visible key return 0."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if h % hkv != 0:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({hkv}) for grouped-query attention")
    group = h // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf = q.float() * scale
    kf = torch.repeat_interleave(k.float(), group, dim=2)
    vf = torch.repeat_interleave(v.float(), group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # fully masked rows give NaN from softmax(-inf): zero them
    probs = torch.where(torch.isnan(probs), 0.0, probs)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


def mha_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: "int | None" = None,
                q_offset: int = 0, scale: "float | None" = None,
                block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """Online-softmax blocked attention, the contract of the
    ``flash_attention`` op (``repro.kernels.ref.mha_blocked``).

    q is cast to float32 and multiplied by ``scale`` before the dot;
    masked logits are -2^30 and the running max starts at -inf; a
    ``window`` of ``None`` or <= 0 means no window; the denominator is
    clamped at 1e-30. A row that sees no key at all therefore returns
    the sum of v over all ``tk`` keys divided by ``nk * block_k`` (every
    block adds exp(0) = 1 per key, padded keys included), not 0 as
    ``mha`` does: the op's result depends on ``block_k`` for such rows
    only.
    """
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    block_q = min(block_q, tq)
    block_k = min(block_k, tk)
    pad_q = (-tq) % block_q
    pad_k = (-tk) % block_k
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q)) if pad_q else q
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k)) if pad_k else k
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k)) if pad_k else v
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_k

    qf = (qp.float() * scale).reshape(b, nq, block_q, hkv, group, d)
    qf = qf.permute(0, 1, 3, 4, 2, 5)  # (b, nq, hkv, g, bq, d)
    kf = kp.float().reshape(b, nk, block_k, hkv, d)
    vf = vp.float().reshape(b, nk, block_k, hkv, d)
    dev = q.device
    qpos = q_offset + torch.arange(nq * block_q, device=dev).reshape(nq, block_q)

    acc = torch.zeros((b, nq, hkv, group, block_q, d), dtype=torch.float32,
                      device=dev)
    mx = torch.full((b, nq, hkv, group, block_q), float("-inf"), device=dev)
    denom = torch.zeros((b, nq, hkv, group, block_q), device=dev)
    for ki in range(nk):
        kpos = ki * block_k + torch.arange(block_k, device=dev)
        msk = (kpos < tk).expand(nq, block_q, block_k)
        if causal:
            msk = msk & (kpos[None, None, :] <= qpos[..., None])
        if not _no_window(window):
            msk = msk & (kpos[None, None, :] > qpos[..., None] - window)
        logits = torch.einsum("bnhgqd,bshd->bnhgqs", qf, kf[:, ki])
        logits = torch.where(msk[None, :, None, None], logits, MASK_VALUE)
        new_mx = torch.maximum(mx, logits.amax(dim=-1))
        alpha = torch.exp(mx - new_mx)
        p = torch.exp(logits - new_mx[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bnhgqs,bshd->bnhgqd",
                                                    p, vf[:, ki])
        mx = new_mx
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * block_q, h, d)
    return out[:, :tq].to(q.dtype)


def mha_blocked_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, *, causal: bool = True,
                     window: "int | None" = None, q_offset: int = 0,
                     scale: "float | None" = None, block_q: int = 512,
                     block_k: int = 1024):
    """(dq, dk, dv): ``torch.autograd.grad`` of ``mha_blocked`` at (q, k,
    v) against the output gradient ``do``, the derivative the reference
    takes of its ``mha_blocked`` in training. The plain version of the
    flash-attention backward kernel, and the CPU path's gradient."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = mha_blocked(*leaves, causal=causal, window=window,
                          q_offset=q_offset, scale=scale, block_q=block_q,
                          block_k=block_k)
        return torch.autograd.grad(out, leaves, do)
