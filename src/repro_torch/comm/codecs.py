"""Payload codecs: simulated encode -> decode with exact byte counts.

Counterpart of ``repro.comm.codecs``. A codec models what a client puts
on the wire: ``roundtrip`` gives the payload the server reconstructs (so
compression error perturbs the optimization) and ``nbytes`` the exact
encoded size, computed in Python from the payload's shape and dtype.

Where the reference maps ``roundtrip(key, x)`` over clients with
``jax.vmap``, here a codec takes the whole stacked payload at once:

  * ``roundtrip(x, u) -> x_hat`` — ``x`` is (rows, ...), one payload per
      row (the clients of an uplink, or one broadcast); ``u`` is that
      payload's stochastic-rounding noise, ``None`` for deterministic
      codecs, shaped ``(rows,) + noise_shape(x.shape[1:])``: the shape of
      what the noisy stage sees (the packed triangle under ``sympack``);
  * ``nbytes(shape, dtype) -> int`` — one payload's encoded bytes, equal
    to the reference's to the byte.

The per-payload kernels (``topk_mask``, ``qint8_roundtrip`` in
``repro_torch.kernels.ops``) take every row in one launch. Codecs
compose: ``TopKCodec``/``SymPackCodec`` wrap an inner codec that encodes
their kept values and hand it the same noise; ``make_codec`` parses
``"+"``-chained specs such as ``"sympack+qint8"`` or ``"topk0.05+fp16"``.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch

from repro_torch.kernels import ops as kops

_INT32_BYTES = 4  # index width for sparse formats
_SCALE_BYTES = 4  # one fp32 scale per quantized tensor


def _size(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(rows, ...) -> (rows, P): one payload per row."""
    return x.reshape(x.shape[0], -1)


class Codec:
    """Base codec. ``deterministic`` codecs take no noise. ``lossless``
    codecs decode bit-exactly, so error feedback skips them."""

    name: str = "codec"
    deterministic: bool = True
    lossless: bool = False

    def roundtrip(self, x: torch.Tensor, u: "torch.Tensor | None") -> torch.Tensor:
        raise NotImplementedError

    def nbytes(self, shape: tuple, dtype: torch.dtype) -> int:
        raise NotImplementedError

    def noise_shape(self, shape: tuple) -> "tuple | None":
        """Shape of one payload's noise, or None for a deterministic codec."""
        return None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class IdentityCodec(Codec):
    """Lossless passthrough; bytes are the raw payload size. ``roundtrip``
    returns its input object, so the identity transport is bit-identical
    to no transport at all."""

    name = "identity"
    lossless = True

    def roundtrip(self, x, u):
        return x

    def nbytes(self, shape, dtype):
        return _size(shape) * dtype.itemsize


@dataclasses.dataclass(frozen=True)
class CastCodec(Codec):
    """Lossy dtype cast on the wire (fp16 / bf16), decoded back up."""

    wire_dtype: str = "float16"
    deterministic = True

    @property
    def name(self):
        return {"float16": "fp16", "bfloat16": "bf16"}.get(
            self.wire_dtype, self.wire_dtype)

    def roundtrip(self, x, u):
        return x.to(getattr(torch, self.wire_dtype)).to(x.dtype)

    def nbytes(self, shape, dtype):
        return _size(shape) * getattr(torch, self.wire_dtype).itemsize


class QInt8Codec(Codec):
    """Per-payload symmetric int8 quantization with stochastic rounding:
    scale = max|x| / 127, q = floor(x / scale + u), u ~ U[0,1). Wire
    format: an int8 per value plus one fp32 scale."""

    name = "qint8"
    deterministic = False

    def roundtrip(self, x, u):
        return kops.qint8_roundtrip(_flat(x), _flat(u)).reshape(x.shape)

    def nbytes(self, shape, dtype):
        return _size(shape) * 1 + _SCALE_BYTES

    def noise_shape(self, shape):
        return tuple(shape)


@dataclasses.dataclass(frozen=True)
class TopKCodec(Codec):
    """Magnitude top-k sparsification: keep a fraction (or count) of each
    payload's entries, sent as (int32 index, value) pairs; the values are
    optionally re-encoded by ``inner``."""

    fraction: "float | None" = None
    k: "int | None" = None
    inner: Codec = dataclasses.field(default_factory=IdentityCodec)

    def __post_init__(self):
        if (self.fraction is None) == (self.k is None):
            raise ValueError(
                "TopKCodec needs exactly one of fraction= or k=, got "
                f"fraction={self.fraction} k={self.k}")
        if self.fraction is not None and not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"top-k fraction must be in (0, 1], "
                             f"got {self.fraction}")

    @property
    def name(self):
        tag = (f"topk{self.fraction}" if self.fraction is not None
               else f"topk@{self.k}")
        return (tag if isinstance(self.inner, IdentityCodec)
                else f"{tag}+{self.inner.name}")

    @property
    def deterministic(self):
        return self.inner.deterministic

    @property
    def lossless(self):
        # keeping every entry degenerates to the inner codec
        return self.fraction == 1.0 and self.inner.lossless

    def _kept(self, n: int) -> int:
        if self.k is not None:
            return max(1, min(int(self.k), n))
        return max(1, min(n, int(math.ceil(float(self.fraction) * n))))

    def roundtrip(self, x, u):
        kept = self._kept(_size(x.shape[1:]))
        # exactly `kept` entries survive per payload, ties to the lowest
        # index; the inner stage sees the dense masked payload and the
        # same noise
        sparse = kops.topk_mask(_flat(x), kept).reshape(x.shape)
        return self.inner.roundtrip(sparse, u)

    def nbytes(self, shape, dtype):
        kept = self._kept(_size(shape))
        return kept * _INT32_BYTES + self.inner.nbytes((kept,), dtype)

    def noise_shape(self, shape):
        return self.inner.noise_shape(shape)


@dataclasses.dataclass(frozen=True)
class SymPackCodec(Codec):
    """Symmetric-matrix packing: send only the upper triangle of a square
    payload (k(k+1)/2 entries instead of k^2), re-encoded by ``inner``;
    decode mirrors it back to a full symmetric matrix."""

    inner: Codec = dataclasses.field(default_factory=IdentityCodec)

    @property
    def name(self):
        return ("sympack" if isinstance(self.inner, IdentityCodec)
                else f"sympack+{self.inner.name}")

    @property
    def deterministic(self):
        return self.inner.deterministic

    @property
    def lossless(self):
        return self.inner.lossless

    @staticmethod
    def _side(shape) -> int:
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError(f"sympack requires a square matrix payload, "
                             f"got {tuple(shape)}")
        return shape[0]

    def roundtrip(self, x, u):
        k = self._side(x.shape[1:])
        sym = 0.5 * (x + x.transpose(-1, -2))  # encode-side symmetrization
        iu = torch.triu_indices(k, k, device=x.device)  # row-major order
        packed = self.inner.roundtrip(sym[:, iu[0], iu[1]], u)
        out = torch.zeros_like(sym)
        out[:, iu[0], iu[1]] = packed
        diag = torch.diagonal(out, dim1=-2, dim2=-1)
        return out + out.transpose(-1, -2) - torch.diag_embed(diag)

    def nbytes(self, shape, dtype):
        k = self._side(shape)
        return self.inner.nbytes((k * (k + 1) // 2,), dtype)

    def noise_shape(self, shape):
        k = self._side(shape)
        return self.inner.noise_shape((k * (k + 1) // 2,))


# ---------------------------------------------------------------------------
# spec parser
# ---------------------------------------------------------------------------

_TOPK_RE = re.compile(r"^topk(@)?([0-9.]+)$")

CODEC_SPECS = ("identity", "fp16", "bf16", "qint8", "topk<frac>",
               "topk@<k>", "sympack")


def make_codec(spec: "str | Codec") -> Codec:
    """Parse ``"+"``-chained codec specs, outermost stage first:
    ``"identity" | "fp16" | "bf16" | "qint8" | "topk0.1" | "topk@64" |
    "sympack"``; the wrappers (``topk*``, ``sympack``) apply every stage
    to their right to the values they keep."""
    if isinstance(spec, Codec):
        return spec
    stages = [s.strip() for s in spec.split("+") if s.strip()]
    if not stages:
        return IdentityCodec()

    def _contains_sympack(codec: Codec) -> bool:
        while codec is not None:
            if isinstance(codec, SymPackCodec):
                return True
            codec = getattr(codec, "inner", None)
        return False

    def build(parts: "list[str]") -> Codec:
        head, rest = parts[0], parts[1:]
        m = _TOPK_RE.match(head)
        if m:
            inner = build(rest) if rest else IdentityCodec()
            if _contains_sympack(inner):
                # top-k flattens to a sparse vector; sympack downstream
                # would see a non-square payload and fail mid-round
                raise ValueError(
                    f"sympack cannot follow top-k in {spec!r}; "
                    "use 'sympack+topk...' to pack first")
            if m.group(1):  # topk@K absolute count
                return TopKCodec(k=int(float(m.group(2))), inner=inner)
            return TopKCodec(fraction=float(m.group(2)), inner=inner)
        if head == "sympack":
            return SymPackCodec(inner=build(rest) if rest else IdentityCodec())
        if rest:
            raise ValueError(
                f"codec {head!r} cannot wrap {'+'.join(rest)!r} (in "
                f"{spec!r}); only topk*/sympack take inner stages")
        if head in ("identity", "none", "raw"):
            return IdentityCodec()
        if head == "fp16":
            return CastCodec("float16")
        if head == "bf16":
            return CastCodec("bfloat16")
        if head == "qint8":
            return QInt8Codec()
        raise ValueError(
            f"unknown codec spec {head!r} (in {spec!r}); expected one of "
            f"{', '.join(CODEC_SPECS)}")

    return build(stages)
