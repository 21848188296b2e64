"""Grouped-query flash attention on Hopper: wrapper of the CUDA kernels.

Replaces ``flash_attention_pallas`` (``repro/kernels/flash_attention.py:72``).
One launch per call, of one of two kernels, chosen by ``flash_route``:

  * ``"sm90"`` — ``flash_attention_sm90_kernel`` in
    ``csrc/flash_attention_sm90.cu``: bfloat16 with a head dim that is a
    multiple of 8 (TMA's 16-byte strides), both products on the tensor
    cores (``wgmma``, float32 accumulators), K and V tiles brought by TMA;
  * ``"tf32x3"`` — ``flash_attention_tf32x3_kernel`` in
    ``csrc/flash_attention.cu``: float32 (the contract checks' dtype, held
    to 2e-5) and bfloat16 head dims that are not a multiple of 8, both
    products on the tensor cores (``mma.sync`` m16n8k8 TF32, float32
    accumulators) with each float32 operand split into two TF32 halves and
    three products summed (3xTF32), K and V tiles brought by ``cp.async``.

Both take (B, T, H, D) tensors with head dim up to 256, the KV head of q
head h being h // (H / Hkv), and compute the op's contract,
``repro_torch.kernels.ref.mha_blocked`` (the plain version); ``block_q``
and ``block_k`` do not set their tiling and matter only for rows that
see no key, whose value the contract defines through ``block_k``. The
route is a rule of dtype and head dim: a kernel that fails to build or
launch raises, and nothing falls back to the other kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import device_guard, stream_of

# launches (incremented only where a kernel is launched): the op's total
# and each route's
LAUNCHES = {"flash_attention": 0, "flash_attention_sm90": 0,
            "flash_attention_tf32x3": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_HEAD_DIM = 256
_INT_MAX = (1 << 31) - 1
# the sm90 kernel's q tile and key tile (kBM and kBN in
# csrc/flash_attention_sm90.cu) and the tf32x3 kernel's smallest q tile
# (kBQ in csrc/flash_attention.cu, which varies with the head dim); each
# grid has one row of blocks per q tile, at most 65535
SM90_BLOCK_Q = 64
SM90_BLOCK_K = 64
TF32X3_BLOCK_Q = 64


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches:
    ``"sm90"`` for bfloat16 with ``d % 8 == 0``, else ``"tf32x3"``."""
    return "sm90" if dtype == torch.bfloat16 and d % 8 == 0 else "tf32x3"


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               q_offset: int = 0) -> str:
    """Validate the shapes, dtypes and layout a kernel takes (any
    device); returns the route."""
    for name, x in (("q", q), ("k", k), ("v", v)):
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
    if q_offset < 0 or q_offset + tq > _INT_MAX:
        raise ValueError(f"q_offset {q_offset} outside the kernel's range")
    route = flash_route(q.dtype, d)
    block_q = SM90_BLOCK_Q if route == "sm90" else TF32X3_BLOCK_Q
    if -(-tq // block_q) > 65535:
        raise ValueError(f"tq {tq} exceeds the {route} kernel's grid "
                         f"({65535 * block_q} rows)")
    if route == "sm90":
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.numel() and x.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary "
                                 f"for TMA")
    return route


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: "int | None" = None,
                         q_offset: int = 0, block_q: int = 512,
                         block_k: int = 1024) -> torch.Tensor:
    """Attention of CUDA tensors q (B, Tq, H, D) over k, v (B, Tk, Hkv,
    D) with ``ref.mha_blocked``'s masks and numerics; ``window`` of
    ``None`` or <= 0 means no window."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise RuntimeError(
                f"{name} is on {x.device}; the CUDA kernel takes CUDA tensors "
                f"(impl='ref' runs the plain version anywhere)")
    route = check_args(q, k, v, q_offset=q_offset)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    del block_q  # the contract's q blocking changes no row's value
    # a row that sees no key gets sum(v) / (nk * block_k) in the contract
    bk = min(block_k, tk)
    empty_denom = float(math.ceil(tk / bk) * bk)
    w = 0 if window is None or window <= 0 else min(int(window), _INT_MAX)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if route == "sm90":
        lib = _build.library("flash_attention_sm90")
        fn = lib.repro_flash_attention_sm90_bf16
    else:
        lib = _build.library("flash_attention")
        fn = getattr(lib, f"repro_flash_attention_{_SUFFIX[q.dtype]}")
    with device_guard(q):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 tq, tk, h, hkv, d, int(bool(causal)), w, int(q_offset),
                 1.0 / d**0.5, empty_denom, stream_of(q))
    _build.check(lib, err, f"flash_attention ({route})")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{route}"] += 1
    return out
