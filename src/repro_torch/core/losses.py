"""Convex objectives for the paper's setting (regularized GLMs).

Counterpart of ``repro.core.losses``: exact closed-form ``value / grad /
hessian / hess_sqrt / hvp`` on one shard ``X (n, M)``, ``y (n,)``:

    L(w) = (1/n) sum_i  l(x_i . w, y_i)  +  (lam/2) ||w||^2

with ``H = A^T A + lam I`` and ``A = diag(sqrt(l''_i / n)) X``.

``softplus(t)`` is ``logaddexp(t, 0)`` as in JAX:
``torch.nn.functional.softplus`` returns t itself above its threshold
of 20, which drops the e^-t tail a float64 loss keeps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def softplus(t: torch.Tensor) -> torch.Tensor:
    """log(1 + e^t), stable for any t and exact in the tail."""
    return torch.logaddexp(t, torch.zeros_like(t))


@dataclasses.dataclass(frozen=True)
class Objective:
    """A twice-differentiable regularized GLM objective."""

    name: str
    value: Callable  # (X, y, w, lam) -> scalar
    grad: Callable  # (X, y, w, lam) -> (M,)
    hessian: Callable  # (X, y, w, lam) -> (M, M)
    hess_sqrt: Callable  # (X, y, w, lam) -> (n, M): A with H = A^T A + lam I
    hvp: Callable  # (X, y, w, v, lam) -> (M,)


# ---------------------------------------------------------------------------
# Regularized logistic regression (labels y in {-1, +1})
# ---------------------------------------------------------------------------

def _logistic_value(X, y, w, lam):
    margins = y * (X @ w)
    return torch.mean(softplus(-margins)) + 0.5 * lam * torch.sum(w * w)


def _logistic_grad(X, y, w, lam):
    n = X.shape[0]
    s = torch.sigmoid(-(y * (X @ w)))
    return -(X.T @ (s * y)) / n + lam * w


def _logistic_weights(X, y, w):
    """l''_i = sigma(m_i) sigma(-m_i) (independent of label sign)."""
    p = torch.sigmoid(y * (X @ w))
    return p * (1.0 - p)


def _logistic_hessian(X, y, w, lam):
    n, m = X.shape
    d = _logistic_weights(X, y, w)
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    return (X.T * d) @ X / n + lam * eye


def _logistic_hess_sqrt(X, y, w, lam):
    n = X.shape[0]
    d = _logistic_weights(X, y, w)
    return X * torch.sqrt(d / n)[:, None]


def _logistic_hvp(X, y, w, v, lam):
    n = X.shape[0]
    d = _logistic_weights(X, y, w)
    return X.T @ (d * (X @ v)) / n + lam * v


logistic = Objective(
    name="logistic",
    value=_logistic_value,
    grad=_logistic_grad,
    hessian=_logistic_hessian,
    hess_sqrt=_logistic_hess_sqrt,
    hvp=_logistic_hvp,
)


# ---------------------------------------------------------------------------
# Regularized least squares
# ---------------------------------------------------------------------------

def _lsq_value(X, y, w, lam):
    r = X @ w - y
    return 0.5 * torch.mean(r * r) + 0.5 * lam * torch.sum(w * w)


def _lsq_grad(X, y, w, lam):
    n = X.shape[0]
    return X.T @ (X @ w - y) / n + lam * w


def _lsq_hessian(X, y, w, lam):
    n, m = X.shape
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    return X.T @ X / n + lam * eye


def _lsq_hess_sqrt(X, y, w, lam):
    n = X.shape[0]
    return X / torch.sqrt(torch.tensor(n, dtype=X.dtype))


def _lsq_hvp(X, y, w, v, lam):
    n = X.shape[0]
    return X.T @ (X @ v) / n + lam * v


least_squares = Objective(
    name="least_squares",
    value=_lsq_value,
    grad=_lsq_grad,
    hessian=_lsq_hessian,
    hess_sqrt=_lsq_hess_sqrt,
    hvp=_lsq_hvp,
)


OBJECTIVES = {"logistic": logistic, "least_squares": least_squares}
