"""The transport codecs' inner loops on Hopper: wrappers of the CUDA kernels.

Replace ``topk_mask_pallas`` (``repro/kernels/codec_kernels.py:85``) and
``qint8_roundtrip_pallas`` (``repro/kernels/codec_kernels.py:112``). The
kernels are ``topk_mask_kernel`` and ``qint8_kernel`` in
``csrc/codec.cu``; each takes every payload of a call in one launch, one
row of the last axis per payload. The plain versions are
``repro_torch.kernels.ref.topk_mask``/``qint8_roundtrip``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import check_input, device_guard, stream_of

# launches of each kernel (incremented only where it is launched)
LAUNCHES = {"topk_mask": 0, "qint8_roundtrip": 0}


def _rows(x: torch.Tensor) -> tuple[int, int]:
    if x.ndim == 0 or x.shape[-1] == 0:
        raise ValueError(f"want payload rows (..., P) with P >= 1, got "
                         f"{tuple(x.shape)}")
    return x.numel() // x.shape[-1], x.shape[-1]


def topk_mask_cuda(x: torch.Tensor, kept: int) -> torch.Tensor:
    """Keep the ``kept`` largest |x| of each row of a CUDA tensor, lowest
    index first on ties; bit-equal to ``ref.topk_mask``."""
    suffix = check_input(x, "x")
    rows, p = _rows(x)
    if not 1 <= kept <= p:
        raise ValueError(f"need 1 <= kept <= {p}, got kept={kept}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.library("codec")
    with device_guard(x):
        err = getattr(lib, f"repro_topk_mask_{suffix}")(
            x.data_ptr(), out.data_ptr(), rows, p, kept, stream_of(x))
    _build.check(lib, err, "topk_mask")
    LAUNCHES["topk_mask"] += 1
    return out


def qint8_roundtrip_cuda(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Int8 quantize -> dequantize of each row of a CUDA tensor with the
    noise ``u`` (x's shape, dtype and device); bit-equal to
    ``ref.qint8_roundtrip``."""
    suffix = check_input(x, "x")
    check_input(u, "u")
    if u.dtype != x.dtype or u.device != x.device or u.shape != x.shape:
        raise TypeError(f"u ({u.dtype}, {u.device}, {tuple(u.shape)}) must "
                        f"match x ({x.dtype}, {x.device}, {tuple(x.shape)})")
    rows, p = _rows(x)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.library("codec")
    with device_guard(x):
        err = getattr(lib, f"repro_qint8_roundtrip_{suffix}")(
            x.data_ptr(), u.data_ptr(), out.data_ptr(), rows, p,
            float(torch.finfo(x.dtype).tiny), stream_of(x))
    _build.check(lib, err, "qint8_roundtrip")
    LAUNCHES["qint8_roundtrip"] += 1
    return out
