"""Walsh-Hadamard transform on Hopper: wrapper of the CUDA kernel.

Replaces ``fwht_pallas`` (``repro/kernels/fwht.py:51``). The kernel is
``fwht_reg_kernel`` in ``csrc/srht.cu``: a thread holds 16 values of a
row, loaded and stored as 16-byte vectors, and runs the stages in
registers and by warp shuffles, nine bits of the index a phase; a row of
n <= ``REG_PHASE_N`` needs one phase, a longer one crosses shared memory
once between phases. A row longer than ``SINGLE_PASS_N`` takes two
passes: the low stages by that kernel on chunks of ``LOW_PASS_N`` (more
for rows past 2^26), then ``fwht_strided_kernel`` along the strided
axis, a lane holding one column's values in registers (all of them to
``STRIDED_REG_ROWS`` rows, in phases with a shared-memory exchange
past that), so any power-of-two length works. ``kernel_route`` states
which kernels serve which length.
The plain version is ``repro_torch.kernels.ref.fwht``.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.kernels import _build, ref

# the longest row the kernels transform in one pass: one row of n doubles
# must fit in a block's shared memory (kMaxN in csrc/srht.cu); longer
# rows take the two-pass path
SINGLE_PASS_N = 1 << 14
# the longest row fwht_reg_kernel transforms without shared memory: 16
# values a thread x 32 lanes (kLogRegs + 5 bits in csrc/srht.cu)
REG_PHASE_N = 1 << 9
# the longest row of the register transpose path (kWarpTMaxN)
WARP_T_MAX_N = 1 << 10
# the longest row of the warp forward path (kWarpN); longer rows to
# SINGLE_PASS_N take srht_fwd_reg_kernel
WARP_N = 32
# the chunk of the low pass of a longer plain transform (kLogLowN), while
# one strided pass of at most 2^14 stages covers the rest
LOW_PASS_N = 1 << 12
# the most rows of a strided pass a lane holds whole in its registers
# (1 << kLogRegs); past that the pass exchanges through shared memory
STRIDED_REG_ROWS = 16


def _low_pass_log(n: int) -> int:
    """log2 of the low pass's chunk for a plain transform of n > 2^14."""
    log_n, log_max = n.bit_length() - 1, SINGLE_PASS_N.bit_length() - 1
    return min(max(log_n - log_max, LOW_PASS_N.bit_length() - 1), log_max)

# launches of the kernel (incremented only where it is launched)
LAUNCHES = {"fwht": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_NO_GUARD = contextlib.nullcontext()


def kernel_route(op: str, n: int) -> str:
    """The CUDA kernel that transforms rows of length ``n`` (a power of
    two) for ``op``, in either dtype: the rule of the launchers in
    ``csrc/srht.cu``."""
    if op == "fwht":
        if n > SINGLE_PASS_N:
            log_lo = _low_pass_log(n)
            route = f"fwht_reg_kernel<2^{log_lo}> + fwht_strided_kernel"
            if n >> log_lo > STRIDED_REG_ROWS:
                route += " (shared-memory exchange)"
            return route
        if n > REG_PHASE_N:
            return "fwht_reg_kernel (shared-memory exchange)"
        return "fwht_reg_kernel"
    if op not in ("srht_apply", "srht_apply_t"):
        raise KeyError(f"no CUDA kernel route for op {op!r}")
    if n > SINGLE_PASS_N:
        return f"{op} long-row path"
    if op == "srht_apply":
        if n <= WARP_N:
            return "srht_fwd_warp_kernel"
        if n > REG_PHASE_N:
            return "srht_fwd_reg_kernel (shared-memory exchange)"
        return "srht_fwd_reg_kernel"
    return "srht_t_warp_kernel" if n <= WARP_T_MAX_N else "srht_t_kernel"


def check_input(x: torch.Tensor, name: str) -> str:
    """Validate a tensor handed to a kernel; returns its dtype suffix."""
    if not x.is_cuda:
        raise RuntimeError(
            f"{name} is on {x.device}; the CUDA kernel takes a CUDA tensor "
            f"(impl='ref' runs the plain version anywhere)")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name} has dtype {x.dtype}; the kernel takes "
                        f"float32 or float64")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return _SUFFIX[x.dtype]


def check_length(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"FWHT length must be a power of two, got {n}")
    if n >= 1 << 31:
        raise ValueError(f"FWHT length {n} does not fit the kernels' int")


def stream_of(x: torch.Tensor) -> int:
    """The raw handle of the current stream of x's card."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def device_guard(x: torch.Tensor):
    """Make x's card current for a launch: ``torch.cuda.device`` where
    another card is current, else a context that does nothing."""
    index = x.get_device()
    if torch._C._cuda_getDevice() == index:
        return _NO_GUARD
    return torch.cuda.device(index)


@functools.lru_cache(maxsize=64)
def _norm(n: int, dtype: torch.dtype) -> float:
    """``ref.norm_factor`` as a float (cached: computing it costs more host
    time than a small launch)."""
    return float(ref.norm_factor(n, dtype))


def fwht_cuda(x: torch.Tensor, *, normalize: bool = False) -> torch.Tensor:
    """WHT along the last axis of a CUDA tensor x (..., n), n a power of
    two; bit-equal to ``ref.fwht``."""
    suffix = check_input(x, "x")
    n = x.shape[-1]
    check_length(n)
    if x.data_ptr() % 16:  # the kernel loads 16-byte vectors
        x = x.clone()
    out = torch.empty_like(x)
    nrows = x.numel() // n
    if nrows == 0:
        return out
    norm = _norm(n, x.dtype) if normalize else 1.0
    with device_guard(x):
        err = getattr(_build.module(), f"repro_fwht_{suffix}")(
            x.data_ptr(), out.data_ptr(), nrows, n, norm, stream_of(x))
    if err:
        _build.check(_build.library(), err, "fwht")
    LAUNCHES["fwht"] += 1
    return out
