"""Federated problem container, partition and reference solver.

Counterpart of the dense part of ``repro.core.federated``. Clients are
equal-sized shards stacked on a leading ``m`` axis (``X: (m, n_shard,
M)``, ``y: (m, n_shard)``); every per-client quantity is one batched
tensor expression over that axis (where JAX used ``vmap``), at the
broadcast iterate (``local_grad``) or at one iterate a client
(``local_grad_at``, for the optimizers that run local steps). Unequal
client sizes use per-client weights ``p_j = n_j / N`` and valid-row
masks.

``make_problem`` partitions iid or by label, as
``DatasetPopulation`` does behind the reference's ``make_problem``; the
Dirichlet split and the lazy populations come with the populations
slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.base import root_key
from repro_torch.core.losses import Objective, softplus
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FederatedProblem:
    """m clients of a regularized GLM, padded to equal shard size."""

    X: torch.Tensor  # (m, n_shard, M)
    y: torch.Tensor  # (m, n_shard)
    mask: torch.Tensor  # (m, n_shard) 1.0 for real rows, 0.0 for padding
    lam: float
    objective: Objective

    @property
    def m(self) -> int:
        return self.X.shape[0]

    @property
    def dim(self) -> int:
        return self.X.shape[-1]

    @property
    def client_weights(self) -> torch.Tensor:
        """p_j = n_j / N."""
        nj = torch.sum(self.mask, dim=1)
        return nj / torch.sum(nj)

    def _margins(self, w: torch.Tensor) -> torch.Tensor:
        return self.y * (self.X @ w)  # (m, n)

    # -- local (per-client) quantities, batched over the client axis ---------
    def local_value(self, w: torch.Tensor) -> torch.Tensor:
        """(m,) local losses (each on its own n_j)."""
        nj = torch.sum(self.mask, dim=1)
        if self.objective.name == "logistic":
            loss_sum = torch.sum(softplus(-self._margins(w)) * self.mask, dim=1)
        else:
            r = self.X @ w - self.y
            loss_sum = 0.5 * torch.sum(r * r * self.mask, dim=1)
        return loss_sum / nj + 0.5 * self.lam * torch.sum(w * w)

    def local_grad(self, w: torch.Tensor) -> torch.Tensor:
        """(m, M) local gradients."""
        nj = torch.sum(self.mask, dim=1)
        if self.objective.name == "logistic":
            s = torch.sigmoid(-self._margins(w)) * self.mask
            coef = -(s * self.y)
        else:
            coef = (self.X @ w - self.y) * self.mask
        g = torch.einsum("jnm,jn->jm", self.X, coef)
        return g / nj[:, None] + self.lam * w

    def local_hess_weights(self, w: torch.Tensor) -> torch.Tensor:
        """(m, n_shard) per-example l'' (masked)."""
        if self.objective.name == "logistic":
            p = torch.sigmoid(self._margins(w))
            return p * (1.0 - p) * self.mask
        return self.mask

    def local_hessian(self, w: torch.Tensor) -> torch.Tensor:
        """(m, M, M) local Hessians (including lam I)."""
        d = self.local_hess_weights(w)
        nj = torch.sum(self.mask, dim=1)
        hs = (self.X * d[..., None]).transpose(1, 2) @ self.X
        eye = torch.eye(self.dim, dtype=self.X.dtype, device=self.X.device)
        return hs / nj[:, None, None] + self.lam * eye[None]

    def local_hess_sqrt(self, w: torch.Tensor) -> torch.Tensor:
        """(m, n_shard, M) local A_j with H_j = A_j^T A_j + lam I."""
        d = self.local_hess_weights(w)
        nj = torch.sum(self.mask, dim=1)
        return self.X * torch.sqrt(d / nj[:, None])[..., None]

    # -- at per-client iterates ws (m, M), one a client ----------------------
    def _margins_at(self, ws: torch.Tensor) -> torch.Tensor:
        return self.y * torch.einsum("jnm,jm->jn", self.X, ws)

    def local_grad_at(self, ws: torch.Tensor) -> torch.Tensor:
        """(m, M): client j's local gradient at its own iterate ws[j]
        (the local runs of FedAvg, FedProx and LocalNewton)."""
        nj = torch.sum(self.mask, dim=1)
        if self.objective.name == "logistic":
            s = torch.sigmoid(-self._margins_at(ws)) * self.mask
            coef = -(s * self.y)
        else:
            coef = (torch.einsum("jnm,jm->jn", self.X, ws) - self.y) * self.mask
        g = torch.einsum("jnm,jn->jm", self.X, coef)
        return g / nj[:, None] + self.lam * ws

    def local_hessian_at(self, ws: torch.Tensor) -> torch.Tensor:
        """(m, M, M): client j's local Hessian (lam I included) at its own
        iterate ws[j]."""
        if self.objective.name == "logistic":
            p = torch.sigmoid(self._margins_at(ws))
            d = p * (1.0 - p) * self.mask
        else:
            d = self.mask
        nj = torch.sum(self.mask, dim=1)
        hs = (self.X * d[..., None]).transpose(1, 2) @ self.X
        eye = torch.eye(self.dim, dtype=self.X.dtype, device=self.X.device)
        return hs / nj[:, None, None] + self.lam * eye[None]

    # -- global quantities ---------------------------------------------------
    def global_value(self, w: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.client_weights * self.local_value(w))

    def global_grad(self, w: torch.Tensor) -> torch.Tensor:
        return torch.einsum("j,jm->m", self.client_weights, self.local_grad(w))

    def global_hessian(self, w: torch.Tensor) -> torch.Tensor:
        return torch.einsum("j,jab->ab", self.client_weights,
                            self.local_hessian(w))


def make_problem(
    X: torch.Tensor,
    y: torch.Tensor,
    m: int,
    lam: float,
    objective: Objective,
    *,
    seed: int = 0,
    heterogeneity: str = "iid",
    device: "str | torch.device" = "cuda",
) -> FederatedProblem:
    """Partition a dataset into m client shards on ``device``.

    heterogeneity:
      * "iid"   — random permutation (from ``root_key(seed)``), equal
                  shards of ceil(n/m) rows; the last shard holds the
                  remainder and is padded with masked zero rows
      * "label" — sort by label before sharding (pathological non-iid)
    """
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    y = torch.as_tensor(y, device=dev)
    n = X.shape[0]
    if heterogeneity == "iid":
        perm = torch.randperm(n, generator=root_key(seed, device=dev),
                              device=dev)
    elif heterogeneity == "label":
        perm = torch.argsort(y, stable=True)
    else:
        raise ValueError(
            f"heterogeneity {heterogeneity!r} is not ported; have 'iid' "
            f"and 'label' ('dirichlet' comes with the populations slice)")
    n_shard = -(-n // m)  # ceil
    pad = n_shard * m - n
    rows_X = torch.cat([X[perm], X.new_zeros((pad, X.shape[1]))])
    rows_y = torch.cat([y[perm], y.new_zeros((pad,))])
    mask = (torch.arange(n_shard * m, device=dev) < n).to(X.dtype)
    return FederatedProblem(
        X=rows_X.reshape(m, n_shard, X.shape[1]),
        y=rows_y.reshape(m, n_shard),
        mask=mask.reshape(m, n_shard),
        lam=float(lam),
        objective=objective,
    )


def newton_solve(problem: FederatedProblem, w0: torch.Tensor,
                 iters: int = 50, tol: float = 1e-12) -> torch.Tensor:
    """Reference optimum w* via exact (global) Newton.

    Halts at the first iterate with ``||grad F(w)|| <= tol``: the loop
    still runs ``iters`` steps, but once converged every later update is
    masked out on the device (no host sync), so the returned ``w`` is
    the halting iterate. ``tol=0.0`` runs all ``iters`` steps.
    """
    w = w0
    done = torch.zeros((), dtype=torch.bool, device=w0.device)
    for _ in range(iters):
        g = problem.global_grad(w)
        done = done | (torch.linalg.vector_norm(g) <= tol)
        step = torch.linalg.solve_ex(problem.global_hessian(w), g)[0]
        w = torch.where(done, w, w - step)
    return w
