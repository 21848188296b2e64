"""Kernel dispatch: the registry of ``repro.kernels.ops``, for PyTorch.

Each op has two implementations:

  * ``"ref"``  — the plain PyTorch version in ``repro_torch.kernels.ref``
                 (any device; the CPU path and the oracle on the card;
                 alias ``"reference"``)
  * ``"cuda"`` — the hand-written CUDA kernel for Hopper (a CUDA tensor
                 on a card of compute capability 9.x; anything else
                 raises)
  * ``"auto"`` resolves by the input tensor's device: a CUDA tensor
                 takes ``"cuda"``, a CPU tensor ``"ref"``.

Selection precedence, most local wins:

  1. the per-call ``impl=`` argument,
  2. the process default set by ``set_default_impl`` / ``use_impl``,
  3. the ``REPRO_TORCH_KERNEL_IMPL`` environment variable,
  4. ``"auto"``.

Ops: ``fwht``, ``srht_apply``, ``srht_apply_t``, ``srht_apply_rows``
(the sketch; the last is ``srht_apply`` along A's rows for FedNS),
``topk_mask`` and ``qint8_roundtrip`` (the transport codecs) and
``flash_attention`` (the LM's attention; its plain version is
``ref.mha_blocked``). The kernels are built only when the first
``"cuda"`` call runs. Every kernel wrapper counts its launches
(``launch_counts``).

Gradients: the ``"ref"`` versions are plain PyTorch, which autograd
differentiates. On ``"cuda"``, ``flash_attention`` with an input that
requires a gradient (and grad mode on) takes ``_CUDA_GRAD``'s entry, an
autograd Function whose backward is the hand-written backward kernel
(self-attention only); the other ops' kernels are not differentiable.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable

import torch

from repro_torch.kernels import codec as kcodec
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import fwht as kfwht
from repro_torch.kernels import ref
from repro_torch.kernels import srht as ksrht

ENV_VAR = "REPRO_TORCH_KERNEL_IMPL"
IMPLS = ("auto", "cuda", "ref")
_ALIASES = {"reference": "ref"}
_CUDA = {"fwht": kfwht.fwht_cuda,
         "srht_apply": ksrht.srht_apply_cuda,
         "srht_apply_t": ksrht.srht_apply_t_cuda,
         "srht_apply_rows": ksrht.srht_apply_rows_cuda,
         "topk_mask": kcodec.topk_mask_cuda,
         "qint8_roundtrip": kcodec.qint8_roundtrip_cuda,
         "flash_attention": kflash.flash_attention_cuda}
# the differentiable form of an op's kernel, taken when an input
# requires a gradient
_CUDA_GRAD = {"flash_attention": kflash.flash_attention_grad_cuda}
# the plain version of an op is ``ref.<op>`` unless named here (looked
# up at call time, so a test may substitute it)
_REF_NAMES = {"flash_attention": "mha_blocked"}
OPS = tuple(_CUDA)

_default_impl: "str | None" = None


def _canonical(impl: str) -> str:
    impl = _ALIASES.get(impl, impl)
    if impl not in IMPLS:
        raise ValueError(
            f"unknown kernel impl {impl!r}; expected one of {IMPLS} "
            f"(or alias {tuple(_ALIASES)})")
    return impl


def set_default_impl(impl: "str | None") -> None:
    """Set the process-wide implementation default (``None`` clears it,
    falling back to ``REPRO_TORCH_KERNEL_IMPL`` / ``"auto"``)."""
    global _default_impl
    _default_impl = None if impl is None else _canonical(impl)


@contextlib.contextmanager
def use_impl(impl: "str | None"):
    """Scoped ``set_default_impl``."""
    prev = _default_impl
    set_default_impl(impl)
    try:
        yield
    finally:
        set_default_impl(prev)


def resolve_impl(impl: "str | None", x: torch.Tensor) -> str:
    """Resolve per-call > config > env > auto down to a concrete impl for
    the input tensor ``x``."""
    choice = _canonical(impl or _default_impl or os.environ.get(ENV_VAR)
                        or "auto")
    if choice == "auto":
        return "cuda" if x.is_cuda else "ref"
    return choice


@functools.cache
def _capability(index: int) -> "tuple[int, int]":
    return torch.cuda.get_device_capability(index)


def _require_card(op: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise RuntimeError(
            f"impl='cuda' for op {op!r} needs a CUDA tensor, got one on "
            f"{x.device}; use impl='ref' for the plain version")
    major, minor = _capability(x.get_device())
    if major < 9:
        raise RuntimeError(
            f"impl='cuda' for op {op!r} needs a Hopper card (compute "
            f"capability 9.x), {x.device} has {major}.{minor}")


def get_impl(op: str, impl: str, x: torch.Tensor, *,
             grad: bool = False) -> Callable:
    """The callable for (op, impl) on input ``x``, its differentiable
    kernel where ``grad``; raises for an unknown op, or for ``"cuda"``
    where the kernel cannot run."""
    if op not in OPS:
        raise KeyError(f"unknown kernel op {op!r}; have {OPS}")
    impl = _canonical(impl)
    if impl == "ref":
        return getattr(ref, _REF_NAMES.get(op, op))
    if impl == "cuda":
        _require_card(op, x)
        return _CUDA_GRAD[op] if grad else _CUDA[op]
    raise ValueError(f"impl {impl!r} is not concrete; resolve it first")


def _dispatch(op: str, impl: "str | None", x: torch.Tensor, *,
              grad: bool = False) -> Callable:
    return get_impl(op, resolve_impl(impl, x), x, grad=grad)


def fwht(x: torch.Tensor, *, normalize: bool = False,
         impl: "str | None" = None) -> torch.Tensor:
    """Walsh-Hadamard transform along the last axis."""
    return _dispatch("fwht", impl, x)(x, normalize=normalize)


def srht_apply(x: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, *,
               impl: "str | None" = None) -> torch.Tensor:
    """Fused SRHT forward: sign-flip -> FWHT -> row-subsample.
    x (..., dim) -> (..., k); n = signs.shape[-1], k = rows.shape[-1].
    Batched operators: ``signs`` (G, n) and ``rows`` (G, k) with x
    (G, ..., dim), operator g on the rows under index g (one kernel
    launch for all G)."""
    if signs.ndim == 2 or rows.ndim == 2:
        ksrht.check_operators(x, signs, rows)
    return _dispatch("srht_apply", impl, x)(x, signs, rows)


def srht_apply_rows(a: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
                    *, impl: "str | None" = None) -> torch.Tensor:
    """Fused SRHT forward along the rows of a (G, n_rows, M), operator g
    (``signs`` (G, n), ``rows`` (G, k)) on a[g]: -> (G, k, M), contiguous
    (FedNS's data-axis sketch). On the card one launch, counted under
    ``srht_apply``: ``srht_rows_kernel`` reads a in place where
    ``fwht.rows_route`` lets it, else a's transpose goes through the
    batched ``srht_apply`` kernel."""
    ksrht.check_rows(a, signs, rows)
    return _dispatch("srht_apply_rows", impl, a)(a, signs, rows)


def srht_apply_t(y: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
                 dim: int, *, impl: "str | None" = None) -> torch.Tensor:
    """Fused SRHT transpose: scatter -> FWHT -> sign-flip -> restrict.
    y (..., k) -> (..., dim)."""
    return _dispatch("srht_apply_t", impl, y)(y, signs, rows, dim)


def topk_mask(x: torch.Tensor, kept: int, *,
              impl: "str | None" = None) -> torch.Tensor:
    """Keep the ``kept`` largest |x| of each payload row (last axis),
    zero the rest; ties go to the lowest index, as ``jax.lax.top_k``."""
    return _dispatch("topk_mask", impl, x)(x, kept)


def qint8_roundtrip(x: torch.Tensor, u: torch.Tensor, *,
                    impl: "str | None" = None) -> torch.Tensor:
    """Per-row symmetric int8 quantize -> dequantize; ``u ~ U[0,1)`` (x's
    shape) is the caller-supplied stochastic-rounding noise."""
    return _dispatch("qint8_roundtrip", impl, x)(x, u)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: "int | None" = None,
                    q_offset: int = 0, block_q: int = 512, block_k: int = 1024,
                    impl: "str | None" = None) -> torch.Tensor:
    """Grouped-query attention, q (B, Tq, H, D) over k, v (B, Tk, Hkv,
    D): causal, sliding ``window`` (``None`` or <= 0 is none) and
    ``q_offset`` masks, online softmax in float32, output in q's dtype.
    ``block_q``/``block_k`` are the contract's blocking (they decide only
    the value of rows that see no key); the kernel picks its own tiles.
    When an input requires a gradient the kernel route is differentiable
    through the backward kernel (Tq == Tk and ``q_offset`` 0 only)."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    return _dispatch("flash_attention", impl, q, grad=grad)(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        block_q=block_q, block_k=block_k)


_LAUNCHES = (kfwht.LAUNCHES, ksrht.LAUNCHES, kcodec.LAUNCHES, kflash.LAUNCHES)


def launch_counts() -> "dict[str, int]":
    """Kernel launches per op since the last ``reset_launch_counts``."""
    return {op: n for counts in _LAUNCHES for op, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _LAUNCHES:
        for op in counts:
            counts[op] = 0
