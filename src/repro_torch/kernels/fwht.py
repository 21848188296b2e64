"""Walsh-Hadamard transform on Hopper: wrapper of the CUDA kernel.

Replaces ``fwht_pallas`` (``repro/kernels/fwht.py:51``). The kernel is
``fwht_kernel`` in ``csrc/srht.cu``; it shares its shared-memory
butterfly with the two SRHT kernels. A row longer than
``SINGLE_PASS_N`` takes two passes (the low stages in shared-memory
chunks, then ``fwht_strided_kernel`` along the strided axis), so any
power-of-two length works. The plain version is
``repro_torch.kernels.ref.fwht``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# the longest row the kernels transform in one pass: one row of n doubles
# must fit in a block's shared memory (kMaxN in csrc/srht.cu); longer
# rows take the two-pass path
SINGLE_PASS_N = 1 << 14

# launches of the kernel (incremented only where it is launched)
LAUNCHES = {"fwht": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


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
    return torch.cuda.current_stream(x.device).cuda_stream


def fwht_cuda(x: torch.Tensor, *, normalize: bool = False) -> torch.Tensor:
    """WHT along the last axis of a CUDA tensor x (..., n), n a power of
    two; bit-equal to ``ref.fwht``."""
    suffix = check_input(x, "x")
    n = x.shape[-1]
    check_length(n)
    out = torch.empty_like(x)
    nrows = x.numel() // n
    if nrows == 0:
        return out
    norm = float(ref.norm_factor(n, x.dtype)) if normalize else 1.0
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = getattr(lib, f"repro_fwht_{suffix}")(
            x.data_ptr(), out.data_ptr(), nrows, n, norm, stream_of(x))
    _build.check(lib, err, "fwht")
    LAUNCHES["fwht"] += 1
    return out
