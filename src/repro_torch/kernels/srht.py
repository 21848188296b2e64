"""The fused SRHT on Hopper: wrappers of the CUDA kernels.

Replace ``srht_apply_pallas`` (``repro/kernels/srht.py:98``) and
``srht_apply_t_pallas`` (``repro/kernels/srht.py:130``). The kernels are
``srht_fwd_kernel`` and ``srht_t_kernel`` in ``csrc/srht.cu``: one pass
per row (pad, sign flip, butterfly, gather) forward, and (scatter,
butterfly, sign flip, truncate) for the transpose. Rows longer than
``SINGLE_PASS_N`` go through a scratch buffer in three steps (padded and
sign-flipped or scattered low stages, the strided high stages, then the
gather or the sign flip and truncation). The plain versions are
``repro_torch.kernels.ref.srht_apply``/``srht_apply_t``.

``rows`` must hold k distinct indices in [0, n), as the sketch samplers
draw them; the kernels do not check them on the device.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.fwht import (
    SINGLE_PASS_N,
    check_input,
    check_length,
    stream_of,
)

# launches of each kernel (incremented only where it is launched)
LAUNCHES = {"srht_apply": 0, "srht_apply_t": 0}


def _check_operator(x: torch.Tensor, signs: torch.Tensor,
                    rows: torch.Tensor, dim: int) -> tuple[int, int]:
    check_input(signs, "signs")
    if signs.dtype != x.dtype or signs.device != x.device:
        raise TypeError(f"signs ({signs.dtype}, {signs.device}) must match "
                        f"the input ({x.dtype}, {x.device})")
    if signs.ndim != 1 or rows.ndim != 1:
        raise ValueError("signs and rows must be 1-D")
    if rows.dtype != torch.int64 or rows.device != x.device:
        raise TypeError(f"rows must be int64 on {x.device}, got "
                        f"{rows.dtype} on {rows.device}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    n, k = signs.shape[0], rows.shape[0]
    check_length(n)
    if not 1 <= k <= n or not 1 <= dim <= n:
        raise ValueError(f"need 1 <= k <= n and 1 <= dim <= n, got "
                         f"k={k} dim={dim} n={n}")
    return n, k


@functools.lru_cache(maxsize=256)
def _factors(n: int, k: int, dtype: torch.dtype) -> tuple[float, float]:
    """The plain versions' 1/sqrt(n) and sqrt(n/k), rounded to dtype
    (cached: computing them costs more host time than a small launch)."""
    return (float(ref.norm_factor(n, dtype)),
            float(ref.subsample_scale(n, k, dtype)))


def _launch(op: str, suffix: str, x, signs, rows, out, nrows, dim, n, k):
    norm, scale = _factors(n, k, x.dtype)
    lib = _build.library()
    with torch.cuda.device(x.device):
        if n <= SINGLE_PASS_N:
            err = getattr(lib, f"repro_{op}_{suffix}")(
                x.data_ptr(), signs.data_ptr(), rows.data_ptr(),
                out.data_ptr(), nrows, dim, n, k, norm, scale, stream_of(x))
        else:
            scratch = torch.empty(nrows * n, dtype=x.dtype, device=x.device)
            err = getattr(lib, f"repro_{op}_large_{suffix}")(
                x.data_ptr(), signs.data_ptr(), rows.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), nrows, dim, n, k, norm,
                scale, stream_of(x))
    _build.check(lib, err, op)
    LAUNCHES[op] += 1


def srht_apply_cuda(x: torch.Tensor, signs: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """Fused S @ x: x (..., dim) -> (..., k) on the card; bit-equal to
    ``ref.srht_apply``."""
    suffix = check_input(x, "x")
    dim = x.shape[-1]
    n, k = _check_operator(x, signs, rows, dim)
    out = torch.empty(x.shape[:-1] + (k,), dtype=x.dtype, device=x.device)
    nrows = x.numel() // dim
    if nrows:
        _launch("srht_apply", suffix, x, signs, rows, out, nrows, dim, n, k)
    return out


def srht_apply_t_cuda(y: torch.Tensor, signs: torch.Tensor,
                      rows: torch.Tensor, dim: int) -> torch.Tensor:
    """Fused S^T @ y: y (..., k) -> (..., dim) on the card; bit-equal to
    ``ref.srht_apply_t``."""
    suffix = check_input(y, "y")
    n, k = _check_operator(y, signs, rows, dim)
    if y.shape[-1] != k:
        raise ValueError(f"y has {y.shape[-1]} entries per row, rows has {k}")
    out = torch.empty(y.shape[:-1] + (dim,), dtype=y.dtype, device=y.device)
    nrows = y.numel() // k
    if nrows:
        _launch("srht_apply_t", suffix, y, signs, rows, out, nrows, dim, n, k)
    return out
