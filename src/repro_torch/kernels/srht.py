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
``rows`` (G, k), x (G, ..., dim)): one launch for all of them, counted
once, on every forward route (the kernels take the rows of one
operator, ``group``, and row r uses operator r / group). The transpose
takes one operator; 2-D ``signs`` or ``rows`` raise there.

FedNS and FedNDES sketch each client's data axis with its own operator:
A (G, n_rows, M) along its rows, S_g @ A_g -> (G, k, M). ``srht_apply_rows``
does that without a copy of A: ``srht_rows_kernel`` reads each client's
rows in place, slab by slab, runs the low four butterfly stages of each
16-row leaf block of each column in registers and, for the k kept
outputs only, sums the leaves and slabs in the plain transform's tree
order (bit-equal to it; ``fwht.rows_route`` states which (n, k) it
takes). Other (n, k) go through A's contiguous transpose and the batched
forward kernel above. Either way the launch counts under ``srht_apply``.

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
function (``srht_rows_kernel`` always multiplies, and skips the padding:
signs past n_rows are not read, so they must be finite there).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.fwht import (
    ROWS_LEAF,
    ROWS_MAX_LOG_P,
    ROWS_MAX_SMEM,
    SINGLE_PASS_N,
    check_input,
    check_length,
    device_guard,
    rows_geometry,
    rows_route,
    rows_smem,
    stream_of,
)

# launches of each op's kernels (incremented only where one is launched);
# srht_rows_kernel's launches count under srht_apply too, the op whose
# function it computes
LAUNCHES = {"srht_apply": 0, "srht_apply_t": 0, "srht_apply_rows": 0}


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


def check_rows(a: torch.Tensor, signs: torch.Tensor,
               rows: torch.Tensor) -> None:
    """``srht_apply_rows``'s shapes: a (G, n_rows, M), signs (G, n) and
    rows (G, k), one G; raises for anything else."""
    if a.ndim != 3:
        raise ValueError(f"srht_apply_rows needs a (G, n_rows, M), got "
                         f"{tuple(a.shape)}")
    check_operators(a, signs, rows)


def srht_rows_kernel(a: torch.Tensor, signs: torch.Tensor,
                     rows: torch.Tensor, *,
                     log_p: "int | None" = None) -> torch.Tensor:
    """``srht_rows_kernel`` on the card, whatever the route: S_g @ a_g for
    a (G, n_rows, M) -> (G, k, M), bit-equal to
    ``ref.srht_apply_rows``. ``log_p`` sets the slab (16 * 2^log_p rows;
    default ``fwht.rows_geometry``'s); raises where the kernel cannot take
    the shape."""
    check_rows(a, signs, rows)
    return _rows_kernel(a, signs, rows, log_p)


def _rows_kernel(a, signs, rows, log_p):
    """``srht_rows_kernel`` with a's rank and G already checked."""
    suffix = check_input(a, "a")
    g, n_rows, m_feat = a.shape
    n, k = _check_operator(a, signs, rows, n_rows, batched=True)
    if log_p is None:
        log_p = rows_geometry(n, n_rows, m_feat, k, a.element_size())[0]
    if not 0 <= log_p <= ROWS_MAX_LOG_P or ROWS_LEAF << log_p > n:
        raise ValueError(f"srht_rows_kernel: slabs of {ROWS_LEAF} * "
                         f"2^{log_p} rows need 0 <= log_p <= "
                         f"{ROWS_MAX_LOG_P} and at most n = {n} rows")
    smem = rows_smem(log_p, n_rows, m_feat, k, a.element_size())
    if smem > ROWS_MAX_SMEM:
        raise ValueError(f"srht_rows_kernel: (n_rows, M, k) = ({n_rows}, "
                         f"{m_feat}, {k}) needs {smem} bytes of shared "
                         f"memory, more than a block has ({ROWS_MAX_SMEM})")
    out = a.new_empty((g, k, m_feat))
    if g == 0 or m_feat == 0:
        return out
    if signs.data_ptr() % 16:  # the signs of a slab come by a bulk copy
        signs = signs.clone()
    norm, scale = _factors(n, k, a.dtype)
    fn = _entry("srht_apply_rows", suffix, False)
    with device_guard(a):
        err = fn(a.data_ptr(), signs.data_ptr(), rows.data_ptr(),
                 out.data_ptr(), g, n_rows, m_feat, n, k, log_p, norm, scale,
                 stream_of(a))
    if err:
        _build.check(_build.library(), err, "srht_apply_rows")
    LAUNCHES["srht_apply"] += 1
    LAUNCHES["srht_apply_rows"] += 1
    return out


def srht_apply_rows_cuda(a: torch.Tensor, signs: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """S_g @ a_g along the rows of a (G, n_rows, M) -> (G, k, M)
    (contiguous) on the card, bit-equal to ``ref.srht_apply_rows``, by
    ``fwht.rows_route``: ``srht_rows_kernel`` reads a in place; any other
    (n, k) takes a's contiguous transpose through ``srht_apply_cuda``.
    One counted ``srht_apply`` launch either way. a's rank and G are
    checked by ``ops.srht_apply_rows`` (``check_rows``)."""
    n_rows, m_feat = a.shape[1:]
    n, k = signs.shape[-1], rows.shape[-1]
    if rows_route(n, n_rows, m_feat, k, a.element_size()) == "srht_rows_kernel":
        return _rows_kernel(a, signs, rows, None)
    at = a.transpose(1, 2).contiguous()
    return srht_apply_cuda(at, signs, rows).transpose(1, 2).contiguous()
