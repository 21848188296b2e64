"""Plain PyTorch versions of the kernels' functions.

Each function keeps the exact op order of its JAX counterpart in
``repro.kernels.ref`` (butterfly stages h = 1, 2, 4, ... with pairs
(a + b, a - b); the 1/sqrt(n) normalization computed in the input
dtype; gather then sqrt(n/k) forward; scale, scatter, FWHT, signs,
slice for the transpose; the codecs' top-k mask and int8 round trip in
the input dtype), so results are bit-equal to it. They are the
CPU path of ``repro_torch.kernels.ops`` and the oracle the CUDA kernels
are held against on the card.
"""
from __future__ import annotations

import math

import torch


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
    """
    n = signs.shape[-1]
    k = rows.shape[-1]
    pad = n - x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    xp = xp * signs
    h = fwht(xp, normalize=True)
    scale = subsample_scale(n, k, h.dtype)
    return torch.index_select(h, -1, rows) * scale


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
