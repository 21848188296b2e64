"""The transport codecs' inner loops on Hopper: wrappers of the CUDA kernels.

Replace ``topk_mask_pallas`` (``repro/kernels/codec_kernels.py:85``) and
``qint8_roundtrip_pallas`` (``repro/kernels/codec_kernels.py:112``). The
kernels are in ``csrc/codec.cu``, one launch per call for every payload,
one row of the last axis per payload: rows of P <= ``WARP_MAX_P`` take a
warp each (``topk_mask_warp_kernel``, ``qint8_warp_kernel``), longer rows
a block each (``topk_mask_kernel``, ``qint8_kernel``); ``codec_route``
states the rule. The plain versions are
``repro_torch.kernels.ref.topk_mask``/``qint8_roundtrip``.

Each main-path call is one small launch, where the host's launch path is
most of the time, so that path does only what a launch needs: the checks
compare attributes, the launch function (of the extension module
``repro_codec``, not ctypes) is bound once, ``tiny`` is cached per dtype
and the stream handle is read raw.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import check_input, device_guard, stream_of

# launches of each kernel (incremented only where it is launched)
LAUNCHES = {"topk_mask": 0, "qint8_roundtrip": 0}

# the longest row of the warp routes: 32 values a lane (kWarpMaxP in
# csrc/codec.cu)
WARP_MAX_P = 1024
# topk_mask_kernel caches a row's bit patterns in shared memory up to
# this many bytes (kCacheBytes) and streams longer rows
CACHE_BYTES = 32 * 1024

_TINY = {dtype: float(torch.finfo(dtype).tiny)
         for dtype in (torch.float32, torch.float64)}


def codec_route(op: str, p: int, dtype: torch.dtype) -> str:
    """The CUDA kernel that serves rows of ``p`` values of ``dtype`` for
    ``op``: the rule of the launchers in ``csrc/codec.cu``. A warp route
    names the values a lane holds (the least power of two R with 32 R >=
    p). ``qint8_kernel`` takes 16-byte loads where rows of p values keep
    16-byte alignment and the tensors start on it, as PyTorch allocates
    them (a view off that boundary takes single loads)."""
    if dtype not in _TINY:
        raise TypeError(f"no CUDA codec kernel for dtype {dtype}")
    if op not in LAUNCHES:
        raise KeyError(f"no CUDA codec kernel for op {op!r}")
    if p <= WARP_MAX_P:
        regs = 1
        while 32 * regs < p:
            regs *= 2
        name = "topk_mask_warp_kernel" if op == "topk_mask" else "qint8_warp_kernel"
        return f"{name}<{regs}>"
    if op == "qint8_roundtrip":
        vector = p * dtype.itemsize % 16 == 0
        return "qint8_kernel (16-byte loads)" if vector else "qint8_kernel"
    cached = p * dtype.itemsize <= CACHE_BYTES
    return f"topk_mask_kernel ({'shared-memory cache' if cached else 'streamed'})"


@functools.cache
def _entry(op: str, suffix: str):
    """The launch function of op for a dtype suffix, bound on first use."""
    return getattr(_build.module("codec"), f"repro_{op}_{suffix}")


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
    fn = _entry("topk_mask", suffix)
    with device_guard(x):
        err = fn(x.data_ptr(), out.data_ptr(), rows, p, kept, stream_of(x))
    if err:
        _build.check(_build.module("codec"), err, "topk_mask")
    LAUNCHES["topk_mask"] += 1
    return out


def qint8_roundtrip_cuda(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Int8 quantize -> dequantize of each row of a CUDA tensor with the
    noise ``u`` (x's shape, dtype and device); bit-equal to
    ``ref.qint8_roundtrip``."""
    suffix = check_input(x, "x")
    check_input(u, "u")
    if (u.dtype != x.dtype or u.get_device() != x.get_device()
            or u.shape != x.shape):
        raise TypeError(f"u ({u.dtype}, {u.device}, {tuple(u.shape)}) must "
                        f"match x ({x.dtype}, {x.device}, {tuple(x.shape)})")
    rows, p = _rows(x)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    fn = _entry("qint8_roundtrip", suffix)
    with device_guard(x):
        err = fn(x.data_ptr(), u.data_ptr(), out.data_ptr(), rows, p,
                 _TINY[x.dtype], stream_of(x))
    if err:
        _build.check(_build.module("codec"), err, "qint8_roundtrip")
    LAUNCHES["qint8_roundtrip"] += 1
    return out
