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

The gradient: ``FlashAttentionFunction`` (``flash_attention_grad_cuda``,
which ``ops.flash_attention`` takes when an input requires a gradient)
launches the forward on its route with the row log-sum-exp written
beside the output, and its backward launches the three kernels of
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_cuda``). The
reference has no backward kernel: its gradient is JAX's derivative of
``mha_blocked`` (plain version here: ``ref.mha_blocked_grad``). The
backward takes self-attention only, Tq == Tk and q_offset 0 (every row
sees its own key), and raises for anything else.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import device_guard, stream_of

# launches (incremented only where a kernel is launched): the op's total
# and each route's
# and the backward's: one a call of flash_attention_bwd_cuda, and one a
# call for each of its three kernels
LAUNCHES = {"flash_attention": 0, "flash_attention_sm90": 0,
            "flash_attention_tf32x3": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0,
            "flash_attention_bwd_dq": 0}
BWD_KERNELS = ("delta", "dkdv", "dq")

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
# the backward's smallest query tile (kBQ in csrc/flash_attention_bwd.cu)
BWD_BLOCK_Q = 32


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


def _require_cuda(**tensors) -> None:
    for name, x in tensors.items():
        if not x.is_cuda:
            raise RuntimeError(
                f"{name} is on {x.device}; the CUDA kernel takes CUDA tensors "
                f"(impl='ref' runs the plain version anywhere)")


def _window(window) -> int:
    return 0 if window is None or window <= 0 else min(int(window), _INT_MAX)


def _forward(q, k, v, *, causal, window, q_offset, block_k, with_lse):
    """One launch of the forward on its route: (out, the row log-sum-exp
    (B, H, Tq) float32 when ``with_lse``, else None)."""
    route = check_args(q, k, v, q_offset=q_offset)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    # a row that sees no key gets sum(v) / (nk * block_k) in the contract
    bk = min(block_k, tk)
    empty_denom = float(math.ceil(tk / bk) * bk)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if route == "sm90":
        lib = _build.library("flash_attention_sm90")
        fn = lib.repro_flash_attention_sm90_bf16
    else:
        lib = _build.library("flash_attention")
        fn = getattr(lib, f"repro_flash_attention_{_SUFFIX[q.dtype]}")
    with device_guard(q):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, tq, tk, h, hkv,
                 d, int(bool(causal)), _window(window), int(q_offset),
                 1.0 / d**0.5, empty_denom, stream_of(q))
    _build.check(lib, err, f"flash_attention ({route})")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{route}"] += 1
    return out, lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: "int | None" = None,
                         q_offset: int = 0, block_q: int = 512,
                         block_k: int = 1024) -> torch.Tensor:
    """Attention of CUDA tensors q (B, Tq, H, D) over k, v (B, Tk, Hkv,
    D) with ``ref.mha_blocked``'s masks and numerics; ``window`` of
    ``None`` or <= 0 means no window. Not differentiable: see
    ``flash_attention_grad_cuda``."""
    _require_cuda(q=q, k=k, v=v)
    del block_q  # the contract's q blocking changes no row's value
    return _forward(q, k, v, causal=causal, window=window, q_offset=q_offset,
                    block_k=block_k, with_lse=False)[0]


def check_bwd_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_offset: int = 0) -> str:
    """``check_args`` and the backward's own limits: self-attention,
    Tq == Tk and q_offset 0, where every row sees at least its own key
    (any device); returns the forward's route."""
    route = check_args(q, k, v, q_offset=q_offset)
    if q_offset != 0 or q.shape[1] != k.shape[1]:
        raise ValueError(
            f"the flash-attention backward takes self-attention only "
            f"(q_offset 0, Tq == Tk); got q_offset {q_offset}, Tq "
            f"{q.shape[1]}, Tk {k.shape[1]}")
    if -(-q.shape[1] // BWD_BLOCK_Q) > 65535:
        raise ValueError(f"T {q.shape[1]} exceeds the backward's grid "
                         f"({65535 * BWD_BLOCK_Q} rows)")
    return route


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: "int | None" = None):
    """(dq, dk, dv) of self-attention of CUDA tensors q (B, T, H, D) over
    k, v (B, T, Hkv, D), from the forward's output ``out``, its row
    log-sum-exp ``lse`` (B, H, T) float32 and the output's gradient
    ``dout``: one call of the three kernels of
    ``csrc/flash_attention_bwd.cu``, each gradient in its input's dtype."""
    _require_cuda(q=q, k=k, v=v, out=out, dout=dout, lse=lse)
    check_bwd_args(q, k, v)
    for name, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q {tuple(q.shape)} "
                             f"{q.dtype}; got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, t, h, d = q.shape
    hkv = k.shape[2]
    if (lse.shape != (b, h, t) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 {(b, h, t)} on "
                         f"{q.device}; got {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention_bwd")
    fn = getattr(lib, f"repro_flash_attention_bwd_{_SUFFIX[q.dtype]}")
    with device_guard(q):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, hkv, d,
                 int(bool(causal)), _window(window), 1.0 / d**0.5,
                 stream_of(q))
    _build.check(lib, err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    for kernel in BWD_KERNELS:
        LAUNCHES[f"flash_attention_bwd_{kernel}"] += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention on the card: the forward kernel of
    the inputs' route, saving its output and row log-sum-exp; the
    backward kernels for (dq, dk, dv). Under activation checkpointing the
    forward runs again while the backward recomputes (two forward
    launches a layer in a training step)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_k):
        out, lse = _forward(q, k, v, causal=causal, window=window,
                            q_offset=0, block_k=block_k, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_grad_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: "int | None" = None, q_offset: int = 0,
                              block_q: int = 512,
                              block_k: int = 1024) -> torch.Tensor:
    """``flash_attention_cuda`` that autograd differentiates through the
    backward kernels; self-attention only (``check_bwd_args``)."""
    _require_cuda(q=q, k=k, v=v)
    check_bwd_args(q, k, v, q_offset=q_offset)
    del block_q
    return FlashAttentionFunction.apply(q, k, v, causal, window, block_k)
