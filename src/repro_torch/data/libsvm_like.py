"""Seeded synthetic stand-ins for the paper's LIBSVM datasets.

Counterpart of ``repro.data.libsvm_like``, with the same generator
(features x ~ N(0, Sigma) with power-law spectrum ``i^-decay``, labels
from a ground-truth logistic model with label noise) drawn from a
``torch.Generator`` on the device. Torch draws differ from JAX's, so the
same seed gives a different (equally distributed) dataset.
"""
from __future__ import annotations

import dataclasses
import zlib

import torch

from repro_torch.core.base import root_key
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    dim: int  # feature dimension M
    m_clients: int  # paper Table II's m
    sketch_k: int  # paper Table II's k
    spectrum_decay: float = 1.0
    label_noise: float = 0.05


# Paper Table II, as the reference twins have it (n reduced for covtype
# and SUSY to CPU-tractable sizes; the (M, k, m) columns match). A caller
# on the card may pass the full row count to ``make_classification``.
PAPER_DATASETS = {
    "phishing": DatasetSpec("phishing", 11_055, 68, 40, 17, spectrum_decay=2.0),
    "covtype": DatasetSpec("covtype", 58_101, 54, 200, 20, spectrum_decay=1.8),
    "susy": DatasetSpec("susy", 100_000, 18, 1000, 10, spectrum_decay=1.5),
}


def make_classification(
    seed: int,
    n: int,
    dim: int,
    *,
    spectrum_decay: float = 1.0,
    label_noise: float = 0.05,
    dtype: torch.dtype = torch.float64,
    device: "str | torch.device" = "cuda",
):
    """Logistic-model data with power-law feature covariance, drawn on
    ``device`` from ``root_key(seed)``. Returns X (n, dim), y (n,) in
    {-1, +1}."""
    dev = resolve_device(device)
    gen = root_key(seed, device=dev)
    evals = torch.arange(1, dim + 1, dtype=dtype, device=dev) ** (-spectrum_decay)
    X = torch.randn((n, dim), generator=gen, dtype=dtype, device=dev)
    X *= torch.sqrt(evals)[None, :]
    w_true = torch.randn((dim,), generator=gen, dtype=dtype, device=dev)
    w_true = w_true / torch.linalg.vector_norm(w_true) * 4.0
    p = torch.sigmoid(X @ w_true)
    u = torch.rand((n,), generator=gen, dtype=dtype, device=dev)
    y = torch.where(u < p, 1.0, -1.0).to(dtype)
    flip = torch.rand((n,), generator=gen, dtype=dtype, device=dev) < label_noise
    y = torch.where(flip, -y, y)
    return X, y


def load(name: str, *, dtype: torch.dtype = torch.float64, seed: int = 0,
         device: "str | torch.device" = "cuda"):
    """One of the paper's datasets (synthetic twin). Returns spec, X, y."""
    spec = PAPER_DATASETS[name]
    # deterministic name hash: builtin hash() is salted per process
    name_h = zlib.crc32(name.encode()) % (2**31)
    X, y = make_classification(
        name_h + seed, spec.n, spec.dim,
        spectrum_decay=spec.spectrum_decay, label_noise=spec.label_noise,
        dtype=dtype, device=device)
    return spec, X, y
