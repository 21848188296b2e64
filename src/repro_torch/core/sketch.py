"""Sketch operators for Newton sketching (SRHT / Gaussian / SJLT).

Counterpart of ``repro.core.sketch``. A sketch is a random linear map
``S : R^dim -> R^k`` normalized so that ``S S^T = (dim/k) I_k`` exactly
for SRHT (when dim is a power of two) and ``E[S^T S / k] ~ I`` for the
dense kinds.

The SRHT is ``S = sqrt(n/k) * P * H_n * D`` restricted to the first
``dim`` coordinates (``n = next_pow2(dim)``, ``D`` Rademacher signs,
``H_n`` the orthonormal Hadamard transform, ``P`` a row sampler without
replacement). ``SrhtSketch`` routes through the ``srht_apply`` and
``srht_apply_t`` ops of ``repro_torch.kernels.ops``: the CUDA kernels on
the card, the plain versions on the CPU. Every op call takes the whole
batch at once, so a call site launches one kernel whatever the number of
clients. ``make_sketches`` draws m operators at once (one per client,
as FedNS sketches each client's data axis): ``BatchedSrhtSketch``
applies them with one batched ``srht_apply`` launch, the dense kinds
with one ``torch.bmm``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.keys import generator
from repro_torch.kernels import ops as kops


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Sketch:
    """Protocol base for a sampled sketch operator (one realization of S)."""

    kind: str = "?"
    k: int
    dim: int

    def apply(self, x: torch.Tensor, *, impl: "str | None" = None) -> torch.Tensor:
        """S @ x for x of shape (..., dim) -> (..., k)."""
        raise NotImplementedError

    def apply_t(self, y: torch.Tensor, *, impl: "str | None" = None) -> torch.Tensor:
        """S^T @ y for y of shape (..., k) -> (..., dim)."""
        raise NotImplementedError

    @property
    def op_dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def dense(self) -> torch.Tensor:
        """Materialize S as a (k, dim) matrix in the operator's dtype."""
        eye = torch.eye(self.dim, dtype=self.op_dtype, device=self.device)
        return self.apply(eye).T


@dataclasses.dataclass(frozen=True)
class SrhtSketch(Sketch):
    """Subsampled randomized Hadamard transform: signs (n,), rows (k,)
    distinct int64 indices in [0, n)."""

    k: int
    dim: int
    signs: torch.Tensor
    rows: torch.Tensor

    kind = "srht"

    def apply(self, x, *, impl=None):
        return kops.srht_apply(x, self.signs, self.rows, impl=impl)

    def apply_t(self, y, *, impl=None):
        return kops.srht_apply_t(y, self.signs, self.rows, self.dim,
                                 impl=impl)

    @property
    def op_dtype(self):
        return self.signs.dtype

    @property
    def device(self):
        return self.signs.device


@dataclasses.dataclass(frozen=True)
class DenseSketch(Sketch):
    """A sketch materialized as its (k, dim) matrix (small-dim kinds)."""

    k: int
    dim: int
    mat: torch.Tensor

    def apply(self, x, *, impl=None):
        return x @ self.mat.T

    def apply_t(self, y, *, impl=None):
        return y @ self.mat

    @property
    def op_dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device


@dataclasses.dataclass(frozen=True)
class GaussianSketch(DenseSketch):
    kind = "gaussian"


@dataclasses.dataclass(frozen=True)
class SjltSketch(DenseSketch):
    """Sparse JL transform, materialized dense for the convex dims."""

    kind = "sjlt"


def _rademacher(gen, shape, dtype, device) -> torch.Tensor:
    bits = torch.randint(0, 2, shape, generator=gen, device=device)
    return (2 * bits - 1).to(dtype)


def make_sketch(key: torch.Tensor, kind: str, k: int, dim: int,
                dtype: torch.dtype = torch.float32,
                device: "str | torch.device" = "cuda",
                sjlt_nnz_per_col: int = 4) -> Sketch:
    """Sample one sketch operator S in R^{k x dim} on ``device`` from a
    key (``repro_torch.core.base``)."""
    dev = resolve_device(device)
    gen = generator(key, dev)
    if kind == "srht":
        n = _next_pow2(dim)
        if not 1 <= k <= n:
            raise ValueError(f"SRHT needs 1 <= k <= next_pow2(dim) = {n}, got k={k}")
        signs = _rademacher(gen, (n,), dtype, dev)
        rows = torch.randperm(n, generator=gen, device=dev)[:k]
        return SrhtSketch(k, dim, signs, rows)
    if kind == "gaussian":
        mat = torch.randn((k, dim), generator=gen, dtype=dtype, device=dev)
        return GaussianSketch(k, dim, mat / torch.sqrt(torch.tensor(k, dtype=dtype)))
    if kind == "sjlt":
        # s nonzeros per column, value +-1/sqrt(s); materialized dense for
        # the small dims of the convex experiments
        s = min(sjlt_nnz_per_col, k)
        rows = torch.randint(0, k, (s, dim), generator=gen, device=dev)
        signs = _rademacher(gen, (s, dim), dtype, dev)
        cols = torch.arange(dim, device=dev).expand(s, dim)
        mat = torch.zeros((k, dim), dtype=dtype, device=dev)
        mat.index_put_((rows.reshape(-1), cols.reshape(-1)),
                       signs.reshape(-1) / torch.sqrt(torch.tensor(s, dtype=dtype)),
                       accumulate=True)
        return SjltSketch(k, dim, mat)
    raise ValueError(f"unknown sketch kind {kind!r}")


# ---------------------------------------------------------------------------
# m operators at once: one per client (FedNS, FedNDES)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchedSrhtSketch(Sketch):
    """m SRHT operators of one (k, dim): signs (m, n), rows (m, k), each
    row of ``rows`` distinct indices in [0, n). ``apply`` takes x
    (m, ..., dim), operator j on the rows under index j, through one
    batched ``srht_apply`` (one kernel launch on the card)."""

    k: int
    dim: int
    signs: torch.Tensor
    rows: torch.Tensor

    kind = "srht"

    def apply(self, x, *, impl=None):
        return kops.srht_apply(x, self.signs, self.rows, impl=impl)

    @property
    def op_dtype(self):
        return self.signs.dtype

    @property
    def device(self):
        return self.signs.device


@dataclasses.dataclass(frozen=True)
class BatchedDenseSketch(Sketch):
    """m dense operators (m, k, dim) (the Gaussian and SJLT kinds),
    applied to x (m, ..., dim) by one ``torch.bmm``."""

    k: int
    dim: int
    mat: torch.Tensor
    kind: str = "gaussian"

    def apply(self, x, *, impl=None):
        m = self.mat.shape[0]
        flat = x.reshape(m, -1, self.dim)
        return torch.bmm(flat, self.mat.transpose(1, 2)).reshape(
            x.shape[:-1] + (self.k,))

    @property
    def op_dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device


def make_sketches(key: torch.Tensor, kind: str, m: int, k: int, dim: int,
                  dtype: torch.dtype = torch.float32,
                  device: "str | torch.device" = "cuda",
                  sjlt_nnz_per_col: int = 4) -> Sketch:
    """Sample m operators S_j in R^{k x dim} on ``device`` from one key,
    each kind in one batched draw (no loop over the m operators): SRHT
    rows are the k largest of n uniform draws per operator, so each
    operator's rows are distinct."""
    dev = resolve_device(device)
    gen = generator(key, dev)
    if kind == "srht":
        n = _next_pow2(dim)
        if not 1 <= k <= n:
            raise ValueError(f"SRHT needs 1 <= k <= next_pow2(dim) = {n}, got k={k}")
        signs = _rademacher(gen, (m, n), dtype, dev)
        u = torch.rand((m, n), generator=gen, device=dev)
        rows = torch.topk(u, k, dim=1).indices.contiguous()
        return BatchedSrhtSketch(k, dim, signs, rows)
    if kind == "gaussian":
        mat = torch.randn((m, k, dim), generator=gen, dtype=dtype, device=dev)
        return BatchedDenseSketch(
            k, dim, mat / torch.sqrt(torch.tensor(k, dtype=dtype)), "gaussian")
    if kind == "sjlt":
        s = min(sjlt_nnz_per_col, k)
        rows = torch.randint(0, k, (m, s, dim), generator=gen, device=dev)
        signs = _rademacher(gen, (m, s, dim), dtype, dev)
        which = torch.arange(m, device=dev)[:, None, None].expand(m, s, dim)
        cols = torch.arange(dim, device=dev).expand(m, s, dim)
        mat = torch.zeros((m, k, dim), dtype=dtype, device=dev)
        mat.index_put_((which.reshape(-1), rows.reshape(-1), cols.reshape(-1)),
                       signs.reshape(-1) / torch.sqrt(torch.tensor(s, dtype=dtype)),
                       accumulate=True)
        return BatchedDenseSketch(k, dim, mat, "sjlt")
    raise ValueError(f"unknown sketch kind {kind!r}")


def sketch_sqrt_rows(sketch: Sketch, a_mat: torch.Tensor) -> torch.Tensor:
    """Left sketch of the Hessian square root, S @ A, on the data axis
    (``sketch.dim`` = A's rows): A (n_rows, dim_feat) -> (k, dim_feat),
    or, with m operators, A (m, n_rows, dim_feat) -> (m, k, dim_feat).
    The data axis is made the last axis by one contiguous copy of A's
    transpose."""
    at = a_mat.transpose(-1, -2).contiguous()
    return sketch.apply(at).transpose(-1, -2)


def sketch_psd(sketch: Sketch, h_mat: torch.Tensor) -> torch.Tensor:
    """S H S^T (k, k) for symmetric H (dim, dim)."""
    hs_t = sketch.apply(h_mat)  # (dim, k): row i is S @ H[i]
    shs_t = sketch.apply(hs_t.T.contiguous())  # (k, k)
    return 0.5 * (shs_t + shs_t.T)  # symmetrize against fp error


def effective_dimension(h_mat: torch.Tensor, lam: float) -> torch.Tensor:
    """Empirical effective dimension d_lambda = tr(H (H + lam I)^-1)."""
    evals = torch.clamp(torch.linalg.eigvalsh(h_mat), min=0.0)
    return torch.sum(evals / (evals + lam))
