"""The fused SRHT on Hopper: wrappers of the CUDA kernels.

Replace ``srht_apply_pallas`` (``repro/kernels/srht.py:98``) and
``srht_apply_t_pallas`` (``repro/kernels/srht.py:130``). The kernels are
in ``csrc/srht.cu``, one launch per call. Forward:
``srht_fwd_warp_kernel`` for rows of n <= 32 (in a warp's registers);
``srht_fwd_reg_kernel`` for 32 < n <= ``SINGLE_PASS_N`` (a chunk of rows
copied into shared memory by one bulk copy, padded and sign-flipped on
the way into registers, the stages in registers and by shuffles with one
shared-memory exchange from n = 1024, the gather a lookup in the inverse
of ``rows`` staged for one coalesced store). Transpose:
``srht_t_warp_kernel`` (n <= 1024: the scaled scatter as a lookup in the
inverse of ``rows``, stages in registers and by shuffles) or
``srht_t_kernel`` (scatter, shared-memory butterfly, sign flip,
truncate). ``fwht.kernel_route`` states the rule. Rows longer than
``SINGLE_PASS_N`` go through a scratch buffer in three steps (padded and
sign-flipped or scattered low stages, the strided high stages, then the
gather or the sign flip and truncation). The plain versions are
``repro_torch.kernels.ref.srht_apply``/``srht_apply_t``.

The forward op also takes G operators at once (``signs`` (G, n),
``rows`` (G, k), x (G, ..., dim)), as FedNS and FedNDES sketch each
client's data axis with its own operator: one launch for all of them,
counted once, on every forward route (the kernels take the rows of one
operator, ``group``, and row r uses operator r / group). The transpose
takes one operator; 2-D ``signs`` or ``rows`` raise there.

The main path's transpose calls are a few rows, where the host's launch
path is the whole time, so that path does only what a launch needs: the
checks compare attributes, the launch function (of the extension module
``repro_srht``, not ctypes) is bound once, and the stream handle is read
raw.

``rows`` must hold k distinct indices in [0, n); the kernels do not
check that on the device. ``signs`` may hold any values. Where all are
+1 or -1, as the sketch samplers draw them, ``srht_fwd_reg_kernel``
takes each sign from its bit in shared memory; otherwise it multiplies
by the sign as read, so every route computes the plain version's
function.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.fwht import (
    SINGLE_PASS_N,
    check_input,
    check_length,
    device_guard,
    stream_of,
)

# launches of each kernel (incremented only where it is launched)
LAUNCHES = {"srht_apply": 0, "srht_apply_t": 0}


def check_operators(x: torch.Tensor, signs: torch.Tensor,
                    rows: torch.Tensor) -> None:
    """The batched form's shapes: signs (G, n), rows (G, k) and x
    (G, ..., dim), one G; raises for anything else."""
    g = signs.shape[0]
    if (signs.ndim, rows.ndim) != (2, 2) or rows.shape[0] != g or (
            x.ndim < 2 or x.shape[0] != g):
        raise ValueError(
            f"batched operators need signs (G, n), rows (G, k) and x "
            f"(G, ..., dim) with one G; got signs {tuple(signs.shape)}, "
            f"rows {tuple(rows.shape)}, x {tuple(x.shape)}")


def _check_operator(x: torch.Tensor, signs: torch.Tensor,
                    rows: torch.Tensor, dim: int,
                    batched: bool = False) -> tuple[int, int]:
    """n and k of the operator; with ``batched``, 2-D ``signs`` (G, n)
    and ``rows`` (G, k) are G operators, one for each index of x's
    leading axis (which must be G)."""
    check_input(signs, "signs")
    index = x.get_device()
    if signs.dtype != x.dtype or signs.get_device() != index:
        raise TypeError(f"signs ({signs.dtype}, {signs.device}) must match "
                        f"the input ({x.dtype}, {x.device})")
    if rows.dtype != torch.int64 or rows.get_device() != index:
        raise TypeError(f"rows must be int64 on {x.device}, got "
                        f"{rows.dtype} on {rows.device}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if batched and (signs.ndim == 2 or rows.ndim == 2):
        check_operators(x, signs, rows)
    elif signs.ndim != 1 or rows.ndim != 1:
        raise ValueError(f"signs and rows must be 1-D; got "
                         f"{tuple(signs.shape)} and {tuple(rows.shape)}")
    n, k = signs.shape[-1], rows.shape[-1]
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


@functools.cache
def _entry(op: str, suffix: str, long_rows: bool):
    """The launch function of op for a dtype suffix, bound on first use."""
    return getattr(_build.module(),
                   f"repro_{op}{'_large' if long_rows else ''}_{suffix}")


def _launch(op, suffix, x, signs, rows, out, sizes, n, k):
    """Launch op's kernel; ``sizes`` are the entry point's arguments
    between the pointers and n: (nrows, dim), or (nrows, group, dim) for
    the forward op."""
    norm, scale = _factors(n, k, x.dtype)
    long_rows = n > SINGLE_PASS_N
    fn = _entry(op, suffix, long_rows)
    with device_guard(x):
        if long_rows:
            scratch = torch.empty(sizes[0] * n, dtype=x.dtype, device=x.device)
            err = fn(x.data_ptr(), signs.data_ptr(), rows.data_ptr(),
                     out.data_ptr(), scratch.data_ptr(), *sizes, n, k,
                     norm, scale, stream_of(x))
        else:
            err = fn(x.data_ptr(), signs.data_ptr(), rows.data_ptr(),
                     out.data_ptr(), *sizes, n, k, norm, scale, stream_of(x))
    if err:
        _build.check(_build.library(), err, op)
    LAUNCHES[op] += 1


def srht_apply_cuda(x: torch.Tensor, signs: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """Fused S @ x: x (..., dim) -> (..., k) on the card; bit-equal to
    ``ref.srht_apply``. With ``signs`` (G, n) and ``rows`` (G, k), x is
    (G, ..., dim) and operator g acts on the rows under index g: one
    launch for all G operators, on every route."""
    suffix = check_input(x, "x")
    dim = x.shape[-1]
    n, k = _check_operator(x, signs, rows, dim, batched=True)
    out = x.new_empty(x.shape[:-1] + (k,))
    nrows = x.numel() // dim
    if nrows:
        group = nrows // signs.shape[0] if signs.ndim == 2 else nrows
        _launch("srht_apply", suffix, x, signs, rows, out,
                (nrows, group, dim), n, k)
    return out


def srht_apply_t_cuda(y: torch.Tensor, signs: torch.Tensor,
                      rows: torch.Tensor, dim: int) -> torch.Tensor:
    """Fused S^T @ y: y (..., k) -> (..., dim) on the card; bit-equal to
    ``ref.srht_apply_t``."""
    suffix = check_input(y, "y")
    n, k = _check_operator(y, signs, rows, dim)
    if y.shape[-1] != k:
        raise ValueError(f"y has {y.shape[-1]} entries per row, rows has {k}")
    out = y.new_empty(y.shape[:-1] + (dim,))
    nrows = y.numel() // k
    if nrows:
        _launch("srht_apply_t", suffix, y, signs, rows, out, (nrows, dim),
                n, k)
    return out
