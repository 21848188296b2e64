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
beside the output, and its backward (``flash_attention_bwd_cuda``) one
of two routes, chosen by ``flash_bwd_route``:

  * ``"sm90"`` — ``csrc/flash_attention_bwd_sm90.cu``: bfloat16 with a
    head dim that is a multiple of 8 (the forward's sm90 inputs), every
    product on the tensor cores (``wgmma``, float32 accumulators, P and
    dS rounded to bfloat16 as A operands), tiles brought by TMA; a delta
    pass, the dk/dv kernel (a block a key tile), the dq kernel (a block a
    query tile) and, when ``bwd_sm90_splits`` cuts a group's heads into
    runs, a pass that adds the runs' float32 partials;
  * ``"tf32x3"`` — ``csrc/flash_attention_bwd.cu``: float32, and
    bfloat16 head dims that are not a multiple of 8 (the forward's tf32x3
    inputs); the same schedule with every product on the tensor cores as
    ``mma.sync`` m16n8k8 TF32 (float32 accumulators, each float32 operand
    split into two TF32 halves and three products summed, as the
    forward's), tiles brought by ``cp.async``; its runs of heads are
    ``bwd_tf32x3_splits``.

The reference has no backward kernel: its gradient is JAX's derivative of
``mha_blocked`` (plain version here: ``ref.mha_blocked_grad``). The
backward takes self-attention only, Tq == Tk and q_offset 0 (every row
sees its own key), and raises for anything else; like the forward, a
route's kernel that fails to build or launch raises, and nothing falls
back to the other route.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import device_guard, stream_of

# launches (incremented only where a kernel is launched): the op's total
# and each route's; the backward's total and each route's (one a call of
# flash_attention_bwd_cuda), and one a call for each kernel it launches:
# flash_attention_bwd_{route}_{delta,dkdv,dq} and, with more than one run
# of heads, flash_attention_bwd_{route}_sum
BWD_KERNELS = {route: tuple(f"{route}_{k}" for k in ("delta", "dkdv", "dq"))
               for route in ("sm90", "tf32x3")}
LAUNCHES = {"flash_attention": 0, "flash_attention_sm90": 0,
            "flash_attention_tf32x3": 0, "flash_attention_bwd": 0,
            **{f"flash_attention_bwd_{name}": 0 for route, kernels
               in BWD_KERNELS.items()
               for name in (route, *kernels, f"{route}_sum")}}

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
# the backward's tiles: a dk/dv block's keys and a dq block's query rows,
# 64 on the sm90 route (kTile in csrc/flash_attention_bwd_sm90.cu); on the
# tf32x3 route 64-row dq tiles (kDqRows) and dk/dv tiles of BwdTiles' kBK
# keys by head-dim width (csrc/flash_attention_bwd.cu). Each grid has one
# row of blocks per tile, at most 65535: BWD_BLOCK_Q is the smallest tile
BWD_SM90_TILE = 64
BWD_TF32X3_TILE = {64: 64, 128: 64, 256: 32}
BWD_BLOCK_Q = min(BWD_SM90_TILE, *BWD_TF32X3_TILE.values())
# the sm90 dk/dv grid's least block count by head-dim width (64, 128,
# 256): four blocks a SM of the H100's 132 at D <= 64 (three are resident
# at once), two at D = 128 and 256 (two and one resident); measured on
# the card at the training, TinyLlama, qwen1.5 and gemma3-1b local heads
# (tools/flash_bwd.py --part layouts)
BWD_SM90_DKDV_BLOCKS = {64: 4 * 132, 128: 2 * 132, 256: 2 * 132}
# the tf32x3 dk/dv grid's, by the same rule: three blocks of its tiles are
# resident on a SM at D <= 64, two at D = 128 and one at 256
# (tools/flash_bwd.py --part layouts times every count of runs)
BWD_TF32X3_DKDV_BLOCKS = {64: 4 * 132, 128: 2 * 132, 256: 2 * 132}


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches:
    ``"sm90"`` for bfloat16 with ``d % 8 == 0``, else ``"tf32x3"``."""
    return "sm90" if dtype == torch.bfloat16 and d % 8 == 0 else "tf32x3"


def flash_bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernels a CUDA call of this dtype and head dim
    launches: the forward's route, ``"sm90"`` for bfloat16 with ``d % 8
    == 0``, else ``"tf32x3"``."""
    return flash_route(dtype, d)


def _width(d: int) -> int:
    """The head-dim width whose kernels a head dim takes."""
    return next(w for w in (64, 128, 256) if d <= w)


def _bwd_splits(b, t, h, hkv, tile, want) -> int:
    group = h // hkv
    blocks = b * hkv * -(-t // tile)
    return next((s for s in range(1, group + 1)
                 if group % s == 0 and blocks * s >= want), group)


def bwd_sm90_splits(b: int, t: int, h: int, hkv: int, d: int) -> int:
    """Runs of query heads the sm90 dk/dv kernel cuts a KV head's group
    into: the fewest (a divisor of the group) that give the dk/dv grid
    ``BWD_SM90_DKDV_BLOCKS`` blocks at the head dim's width (1: the whole
    group in one block, no partials). Each further run costs a float32
    write and read of dk and dv; too few blocks leave the causal mask's
    long key tiles (the first walks every query tile) running alone."""
    return _bwd_splits(b, t, h, hkv, BWD_SM90_TILE,
                       BWD_SM90_DKDV_BLOCKS[_width(d)])


def bwd_tf32x3_splits(b: int, t: int, h: int, hkv: int, d: int) -> int:
    """``bwd_sm90_splits``' rule for the tf32x3 dk/dv kernel, with its
    tile and ``BWD_TF32X3_DKDV_BLOCKS`` at the head dim's width."""
    return _bwd_splits(b, t, h, hkv, BWD_TF32X3_TILE[_width(d)],
                       BWD_TF32X3_DKDV_BLOCKS[_width(d)])


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
    ``dout``: one call of the kernels of the ``flash_bwd_route``, each
    gradient in its input's dtype."""
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
    route = flash_bwd_route(q.dtype, d)
    if route == "sm90":
        for name, x in (("out", out), ("dout", dout)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary "
                                 f"for the sm90 backward")
        splits = bwd_sm90_splits(b, t, h, hkv, d)
        # lse log2(e) and delta, each padded to whole tiles
        stats = 2 * b * h * (-(-t // BWD_SM90_TILE) * BWD_SM90_TILE)
        lib = _build.library("flash_attention_bwd_sm90")
        fn = lib.repro_flash_attention_bwd_sm90_bf16
    else:
        splits = bwd_tf32x3_splits(b, t, h, hkv, d)
        stats = b * h * t  # delta
        lib = _build.library("flash_attention_bwd")
        fn = getattr(lib,
                     f"repro_flash_attention_bwd_tf32x3_{_SUFFIX[q.dtype]}")
    # the statistics, then with more than one run the float32 partials of
    # dk and dv
    parts = 2 * splits * dk.numel() if splits > 1 else 0
    scratch = torch.empty(stats + parts, dtype=torch.float32,
                          device=q.device)
    with device_guard(q):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, hkv, d,
                 int(bool(causal)), _window(window), splits, 1.0 / d**0.5,
                 stream_of(q))
    _build.check(lib, err, f"flash_attention_bwd ({route})")
    LAUNCHES["flash_attention_bwd"] += 1
    LAUNCHES[f"flash_attention_bwd_{route}"] += 1
    for kernel in BWD_KERNELS[route]:
        LAUNCHES[f"flash_attention_bwd_{kernel}"] += 1
    if splits > 1:
        LAUNCHES[f"flash_attention_bwd_{route}_sum"] += 1
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
