"""Grouped-query flash attention on Hopper: wrapper of the CUDA kernel.

Replaces ``flash_attention_pallas`` (``repro/kernels/flash_attention.py:72``).
The kernel is ``flash_attention_kernel`` in ``csrc/flash_attention.cu``:
one launch per call, (B, T, H, D) float32 or bfloat16 tensors, head dim
up to 256, the KV head of q head h being h // (H / Hkv). It computes the
op's contract, ``repro_torch.kernels.ref.mha_blocked`` (the plain
version); ``block_q`` and ``block_k`` do not set its tiling and matter
only for rows that see no key, whose value the contract defines through
``block_k``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import stream_of

# launches of the kernel (incremented only where it is launched)
LAUNCHES = {"flash_attention": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_HEAD_DIM = 256
_INT_MAX = (1 << 31) - 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise RuntimeError(
                f"{name} is on {x.device}; the CUDA kernel takes CUDA tensors "
                f"(impl='ref' runs the plain version anywhere)")
        if x.dtype not in _SUFFIX:
            raise TypeError(f"{name} has dtype {x.dtype}; the kernel takes "
                            f"float32 or bfloat16")
        if x.ndim != 4:
            raise ValueError(f"{name} must be (B, T, heads, D), got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype or {k.device, v.device} != {q.device}:
        raise TypeError(f"q, k and v must share dtype and device, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype} on "
                        f"{q.device}/{k.device}/{v.device}")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, Tk, Hkv, D) with q's B and D; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    tk, hkv = k.shape[1], k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hkv})")
    if tk < 1:
        raise ValueError("need at least one key")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside the kernel's 1..{MAX_HEAD_DIM}")
    if max(b, h) > 65535 or max(tq, tk) * h * d > _INT_MAX:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"exceed the kernel's grid or int indexing")
    return _SUFFIX[q.dtype]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: "int | None" = None,
                         q_offset: int = 0, block_q: int = 512,
                         block_k: int = 1024) -> torch.Tensor:
    """Attention of CUDA tensors q (B, Tq, H, D) over k, v (B, Tk, Hkv,
    D) with ``ref.mha_blocked``'s masks and numerics; ``window`` of
    ``None`` or <= 0 means no window."""
    suffix = _check(q, k, v)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if q_offset < 0 or q_offset + tq > _INT_MAX:
        raise ValueError(f"q_offset {q_offset} outside the kernel's range")
    del block_q  # the contract's q blocking changes no row's value
    # a row that sees no key gets sum(v) / (nk * block_k) in the contract
    bk = min(block_k, tk)
    empty_denom = float(math.ceil(tk / bk) * bk)
    w = 0 if window is None or window <= 0 else min(int(window), _INT_MAX)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        err = getattr(lib, f"repro_flash_attention_{suffix}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, tq,
            tk, h, hkv, d, int(bool(causal)), w, int(q_offset), 1.0 / d**0.5,
            empty_denom, stream_of(q))
    _build.check(lib, err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
