"""Federated problem container, partition and reference solver.

Counterpart of the dense part of ``repro.core.federated``. Clients are
equal-sized shards stacked on a leading ``m`` axis (``X: (m, n_shard,
M)``, ``y: (m, n_shard)``); every per-client quantity is one batched
tensor expression over that axis (where JAX used ``vmap``), at the
broadcast iterate (``local_grad``) or at one iterate a client
(``local_grad_at``, for the optimizers that run local steps). Unequal
client sizes use per-client weights ``p_j = n_j / N`` and valid-row
masks.

Populations. ``FederatedProblem`` holds every client; a
``ClientPopulation`` describes m clients (O(m) host metadata: shard
sizes) and materializes only a requested cohort: ``materialize(ids)``
returns the ``FederatedProblem`` of those clients, the same shard for an
id whatever cohort it rides in. ``DatasetPopulation`` partitions a real
dataset (its rows on the device, gathered per cohort);
``SyntheticPopulation`` generates client j's shard from ``(seed, j)``
with counter-based draws, vectorised over the cohort. ``make_problem``
is ``DatasetPopulation(...).materialize_all()``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.base import root_key
from repro_torch.core.losses import Objective, logistic, softplus
from repro_torch.device import host_to, resolve_device
from repro_torch.obs import log as obs_log


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


# ---------------------------------------------------------------------------
# client populations: cohorts materialized on demand
# ---------------------------------------------------------------------------

# the dense Dirichlet split warns when the largest shard exceeds this
# multiple of the mean (every client is padded to the largest)
_PAD_WARN_FACTOR = 4.0


def _redistribute_cap(sizes: np.ndarray, cap: int) -> np.ndarray:
    """Clip shard sizes at ``cap`` and hand the excess rows to the
    smallest shards (the total stays exact, every size >= 1); a pure
    function of (sizes, cap)."""
    sizes = sizes.copy()
    excess = int(np.maximum(sizes - cap, 0).sum())
    sizes = np.minimum(sizes, cap)
    while excess > 0:
        # fill the currently smallest shards first, one sweep at a time
        order = np.argsort(sizes, kind="stable")
        room = cap - sizes[order]
        take = np.minimum(room, np.maximum(excess // len(sizes), 1))
        for j, t in zip(order, take):
            t = int(min(t, excess))
            sizes[j] += t
            excess -= t
            if excess == 0:
                break
    return sizes


def dirichlet_proportions(seed: int, m: int, alpha: float) -> np.ndarray:
    """Dir(alpha) client proportions (m,), drawn on the host from a seeded
    ``numpy.random.Generator`` (torch has no seeded Dirichlet sampler)."""
    return np.random.default_rng(seed).dirichlet(np.full(m, float(alpha)))


def _dirichlet_sizes(props: np.ndarray, n: int,
                     max_pad_factor: "float | None" = None) -> np.ndarray:
    """n * props shard sizes, largest-remainder rounded to sum to n, every
    client >= 1 row. ``max_pad_factor`` caps any shard at ``factor *
    ceil(n/m)`` rows, redistributing the excess; ``None`` keeps the raw
    draw and warns when the padding blowup is large."""
    m = len(props)
    raw = np.asarray(props, dtype=np.float64) * n
    sizes = np.floor(raw).astype(np.int64)
    # largest-remainder rounding so sizes sum exactly to n
    short = n - int(sizes.sum())
    order = np.argsort(-(raw - sizes))
    sizes[order[:short]] += 1
    # every client holds at least one real row (p_j = 0 breaks the
    # weighted aggregation and the local 1/n_j normalizations)
    while (sizes == 0).any():
        sizes[int(np.argmax(sizes))] -= 1
        sizes[int(np.argmin(sizes))] += 1
    mean = -(-n // m)  # ceil(n/m)
    if max_pad_factor is not None:
        cap = max(1, int(np.ceil(max_pad_factor * mean)))
        if sizes.max() > cap:
            sizes = _redistribute_cap(sizes, cap)
    elif sizes.max() > _PAD_WARN_FACTOR * mean:
        obs_log.warn_with_context(
            f"dirichlet shard sizes pad every client to the largest chunk "
            f"({int(sizes.max())} rows vs ceil(n/m)={mean}): dense "
            f"materialization costs m*max_j(n_j)*M. Pass max_pad_factor=<f> "
            f"to cap the blowup, or use a ClientPopulation", stacklevel=3,
            m=m, n=n, max_shard=int(sizes.max()), mean_shard=mean)
    return sizes


class ClientPopulation:
    """Describes ``m`` clients without materializing their data.

    Subclasses build the ``(c, n_shard, M)`` ``FederatedProblem`` of a
    cohort (``materialize(ids)``, a fixed pad width ``n_shard``) on the
    population's ``device``; host metadata is O(m) (shard sizes).
    """

    # marks population mode for ``run_rounds``
    is_population = True

    m: int
    dim: int
    lam: float
    objective: Objective
    n_shard: int  # fixed cohort pad width
    sizes: np.ndarray  # (m,) int64 rows a client
    device: torch.device
    dtype: torch.dtype

    @property
    def client_weights(self) -> np.ndarray:
        """(m,) p_j = n_j / N over the whole population (host)."""
        s = self.sizes.astype(np.float64)
        return s / s.sum()

    def materialize(self, ids) -> FederatedProblem:
        """The cohort ``ids`` as a ``FederatedProblem`` (an id's shard is
        the same whatever cohort it rides in)."""
        raise NotImplementedError

    def materialize_all(self) -> FederatedProblem:
        """Every client materialized (workstation scale only)."""
        return self.materialize(np.arange(self.m))

    def eval_problem(self, max_clients: int = 64) -> FederatedProblem:
        """A fixed evaluation cohort (ids evenly spaced over the
        population) for the loss and gradient curves."""
        if self.m <= max_clients:
            ids = np.arange(self.m)
        else:
            ids = np.unique(
                np.linspace(0, self.m - 1, max_clients).astype(np.int64))
        return self.materialize(ids)


class DatasetPopulation(ClientPopulation):
    """A dataset partitioned into m client views, gathered per cohort.

    Holds the partitioned rows (O(n), on ``device``) and O(m) metadata
    (sizes, row offsets). The partition rule is ``make_problem``'s:
    "iid" a permutation from ``root_key(seed)``, "label" the rows sorted
    by label, both in shards of ceil(n/m) rows (the last one short);
    "dirichlet" the label-sorted rows in contiguous chunks of n *
    Dir(alpha) rows (``dirichlet_proportions(seed, m, alpha)``), padded
    to the largest.
    """

    def __init__(self, X, y, m: int, lam: float, objective: Objective, *,
                 seed: int = 0, heterogeneity: str = "iid",
                 dirichlet_alpha: float = 0.3,
                 max_pad_factor: "float | None" = None,
                 device: "str | torch.device" = "cuda"):
        dev = resolve_device(device)
        X = torch.as_tensor(X, device=dev)
        y = torch.as_tensor(y, device=dev)
        n = X.shape[0]
        if heterogeneity == "dirichlet":
            if n < m:
                raise ValueError(
                    f"dirichlet split needs n >= m, got n={n} m={m}")
            perm = torch.argsort(y, stable=True)
            sizes = _dirichlet_sizes(
                dirichlet_proportions(seed, m, dirichlet_alpha), n,
                max_pad_factor=max_pad_factor)
            rows_X, rows_y = X[perm], y[perm]
            n_shard = int(sizes.max())
        elif heterogeneity in ("iid", "label"):
            if heterogeneity == "iid":
                perm = torch.randperm(n, generator=root_key(seed, device=dev),
                                      device=dev)
            else:
                perm = torch.argsort(y, stable=True)
            n_shard = -(-n // m)  # ceil
            pad = n_shard * m - n
            rows_X = torch.cat([X[perm], X.new_zeros((pad, X.shape[1]))])
            rows_y = torch.cat([y[perm], y.new_zeros((pad,))])
            sizes = np.full((m,), n_shard, dtype=np.int64)
            sizes[-1] = n - n_shard * (m - 1)
        else:
            raise ValueError(
                f"unknown heterogeneity {heterogeneity!r}; want 'iid', "
                f"'label' or 'dirichlet'")
        self._init_rows(rows_X, rows_y, sizes, n_shard, m, lam, objective)

    @classmethod
    def from_rows(cls, rows_X, rows_y, sizes, n_shard: int, lam: float,
                  objective: Objective) -> "DatasetPopulation":
        """A population over rows already partitioned: client j holds
        ``sizes[j]`` rows from ``sum(sizes[:j])`` (``interop`` builds one
        from the reference's rows)."""
        pop = cls.__new__(cls)
        pop._init_rows(rows_X, rows_y, np.asarray(sizes, dtype=np.int64),
                       n_shard, len(sizes), lam, objective)
        return pop

    def _init_rows(self, rows_X, rows_y, sizes, n_shard, m, lam, objective):
        self.m = int(m)
        self.dim = int(rows_X.shape[1])
        self.lam = float(lam)
        self.objective = objective
        self.sizes = sizes
        self.n_shard = int(n_shard)
        self.device = rows_X.device
        self.dtype = rows_X.dtype
        self._rows_X = rows_X
        self._rows_y = rows_y
        self._starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self._n_rows = rows_X.shape[0]

    def materialize(self, ids) -> FederatedProblem:
        ids = np.asarray(ids, dtype=np.int64)
        # clamp the gather window to the row table (short shards read
        # trailing rows that the mask then zeroes)
        idx = np.minimum(
            self._starts[ids][:, None] + np.arange(self.n_shard)[None, :],
            self._n_rows - 1)
        valid = np.arange(self.n_shard)[None, :] < self.sizes[ids][:, None]
        idx = host_to(idx, self.device)
        mask = host_to(valid, self.device, self.dtype)
        return FederatedProblem(
            X=self._rows_X[idx] * mask[..., None],
            y=self._rows_y[idx] * mask.to(self._rows_y.dtype),
            mask=mask, lam=self.lam, objective=self.objective)


# splitmix64's constants as int64 (torch has no uint64 arithmetic; int64
# wraps the same bits)
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 tensors (wrapping arithmetic)."""
    x = x + _GOLDEN
    x = (x ^ _lshr(x, 30)) * _M1
    x = (x ^ _lshr(x, 27)) * _M2
    return x ^ _lshr(x, 31)


def counter_uniform(seed: int, ids: torch.Tensor, lanes: int,
                    dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(c, lanes) U[0,1): entry (i, l) a pure function of (seed, ids[i],
    l), drawn in one vectorised pass on ``ids``' device."""
    base = _mix(_mix(torch.full_like(ids, seed & ((1 << 63) - 1))) ^ ids)
    lane = torch.arange(lanes, dtype=torch.int64, device=ids.device)
    z = _mix(base[:, None] ^ lane[None, :])
    return _lshr(z, 11).to(dtype) * 2.0 ** -53


def _box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(2.0 * torch.pi * u2)


class SyntheticPopulation(ClientPopulation):
    """A generative population: client ``j``'s shard is a pure function
    of ``(seed, j)``; nothing exists until a cohort is sampled.

    Features follow the power-law-covariance logistic model of the
    synthetic LIBSVM twins; labels come from a shared ``w_true``,
    optionally tilted per client (``heterogeneity > 0`` adds N(0, het^2)
    to it). Shard sizes are ``n_per_client * m * Dir(alpha)`` rounded and
    clipped into ``[1, n_shard]``, so cohorts pad to a fixed width. A
    cohort is one vectorised counter-based draw (``counter_uniform``) on
    ``device``: the draws of an id do not depend on the cohort, the
    round or the driver. Same model as ``repro``'s, other numbers.
    """

    def __init__(self, m: int, dim: int, *, lam: float = 1e-3,
                 objective: "Objective | None" = None, seed: int = 0,
                 n_per_client: int = 32, n_shard: "int | None" = None,
                 dirichlet_alpha: "float | None" = 0.3,
                 spectrum_decay: float = 1.0, label_noise: float = 0.05,
                 heterogeneity: float = 0.0,
                 dtype: torch.dtype = torch.float64,
                 device: "str | torch.device" = "cuda"):
        self.m = int(m)
        self.dim = int(dim)
        self.lam = float(lam)
        self.objective = logistic if objective is None else objective
        self.seed = int(seed)
        self.n_shard = int(n_shard if n_shard is not None
                           else max(2, 2 * n_per_client))
        self.device = resolve_device(device)
        self.dtype = dtype
        if dirichlet_alpha is None:
            self.sizes = np.full((m,), int(n_per_client), dtype=np.int64)
        else:
            props = dirichlet_proportions(seed, m, dirichlet_alpha)
            raw = np.round(props * (n_per_client * m)).astype(np.int64)
            # clip into [1, n_shard]: the pad width is a population
            # constant, so one heavy draw never widens every cohort
            self.sizes = np.clip(raw, 1, self.n_shard)
        evals = torch.arange(1, dim + 1, dtype=dtype,
                             device=self.device) ** (-float(spectrum_decay))
        self._sqrt_evals = torch.sqrt(evals)
        # w_true: the normals of the id -1 (no client has it)
        u = counter_uniform(self.seed, torch.tensor(
            [-1], dtype=torch.int64, device=self.device), 2 * dim, dtype)[0]
        w_true = _box_muller(u[:dim], u[dim:])
        self._w_true = w_true / torch.linalg.vector_norm(w_true) * 4.0
        self._label_noise = float(label_noise)
        self._het = float(heterogeneity)

    def _draw_shards(self, ids: np.ndarray):
        """(c, n_shard, dim) X, (c, n_shard) y and mask of the cohort.
        A client's counter lanes: X's normals (two uniforms each), the
        tilt's normals, the label coins, the flip coins."""
        ns, d = self.n_shard, self.dim
        cid = host_to(ids, self.device)
        u = counter_uniform(self.seed, cid, 2 * ns * d + 2 * d + 2 * ns,
                            self.dtype)
        c = len(ids)
        X = _box_muller(u[:, :ns * d], u[:, ns * d:2 * ns * d])
        X = X.reshape(c, ns, d) * self._sqrt_evals
        o = 2 * ns * d
        w = self._w_true.expand(c, d)
        if self._het > 0.0:
            w = w + self._het * _box_muller(u[:, o:o + d], u[:, o + d:o + 2 * d])
        o += 2 * d
        p = torch.sigmoid(torch.einsum("cnd,cd->cn", X, w))
        y = torch.where(u[:, o:o + ns] < p, 1.0, -1.0).to(self.dtype)
        flip = u[:, o + ns:o + 2 * ns] < self._label_noise
        y = torch.where(flip, -y, y)
        n_j = host_to(self.sizes[ids], self.device)
        mask = (torch.arange(ns, device=self.device)[None, :]
                < n_j[:, None]).to(self.dtype)
        return X * mask[..., None], y * mask, mask

    def materialize(self, ids) -> FederatedProblem:
        ids = np.asarray(ids, dtype=np.int64)
        X, y, mask = self._draw_shards(ids)
        return FederatedProblem(X=X, y=y, mask=mask, lam=self.lam,
                                objective=self.objective)


def make_problem(
    X: torch.Tensor,
    y: torch.Tensor,
    m: int,
    lam: float,
    objective: Objective,
    *,
    seed: int = 0,
    heterogeneity: str = "iid",
    dirichlet_alpha: float = 0.3,
    max_pad_factor: "float | None" = None,
    device: "str | torch.device" = "cuda",
) -> FederatedProblem:
    """Partition a dataset into m client shards on ``device``:
    ``DatasetPopulation(...).materialize_all()``.

    heterogeneity:
      * "iid"       — random permutation (from ``root_key(seed)``), equal
                      shards of ceil(n/m) rows; the last shard holds the
                      remainder and is padded with masked zero rows
      * "label"     — sort by label before sharding (pathological non-iid)
      * "dirichlet" — label-sorted rows in contiguous chunks of n *
                      Dir(alpha) rows (largest-remainder rounded, >= 1
                      each), padded to the largest; ``max_pad_factor=f``
                      caps a chunk at ``f * ceil(n/m)`` rows
    """
    return DatasetPopulation(
        X, y, m, lam, objective, seed=seed, heterogeneity=heterogeneity,
        dirichlet_alpha=dirichlet_alpha, max_pad_factor=max_pad_factor,
        device=device).materialize_all()


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
