"""Mesh-resident FLeNS: clients as ranks, the counterpart of
``repro.core.distributed``.

The simulator in ``core/`` batches every client on one device. This
module runs the SAME round over a process group: every rank of the
client axes (``("pod", "data")`` present in the mesh) holds one client's
rows, sketches them on its own device, and the server aggregation is an
all-reduce over the client axes, the O(k^2) wire pattern as a usable
training API. A ``model`` axis in the mesh holds copies of the data.

Wire contract: every rank draws the round's operator itself from the
round seed (``SketchPolicy.sample`` keyed by ``key_from_ints(seed)``,
the seed doubling as the round index), so no rank broadcasts a basis.

Numerical contract (``tests/test_torch_distributed.py``): one round on
an m-rank mesh equals one simulator round with the same m clients and
the same operator, to float tolerance.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core.base import solve
from repro_torch.core.losses import Objective
from repro_torch.core.sketch_policy import SketchPolicy, as_policy
from repro_torch.keys import key_from_ints
from repro_torch.launch.mesh import axis_group, axis_index, axis_sizes


@dataclasses.dataclass(frozen=True)
class DistributedFLeNS:
    """FLeNS with clients distributed over mesh axes.

    ``mesh`` is a ``DeviceMesh`` over the initialised default group;
    ``round_fn()`` returns the step ``(X, y, w, w_prev, seed) -> (w_next,
    w)`` on this rank's rows (``shard_data``)."""

    mesh: object
    objective: Objective
    dim: int
    k: int
    lam: float
    mu: float = 1.0
    beta: float = 0.0
    lam_damp: float = 1e-8
    client_axes: tuple = ("pod", "data")
    sketch: "str | SketchPolicy" = "srht"

    def _axes(self) -> tuple:
        return tuple(a for a in self.client_axes
                     if a in self.mesh.mesh_dim_names)

    def _n_clients(self) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self._axes())

    # -- client-local math ---------------------------------------------------
    def _local_grad(self, X, y, w):
        if self.objective.name == "logistic":
            margins = y * (X @ w)
            s = torch.sigmoid(-margins)
            return -(X.T @ (s * y)) / X.shape[0] + self.lam * w
        r = X @ w - y
        return X.T @ r / X.shape[0] + self.lam * w

    def _local_hess_sqrt(self, X, y, w):
        if self.objective.name == "logistic":
            margins = y * (X @ w)
            p = torch.sigmoid(margins)
            d = p * (1 - p)
        else:
            d = torch.ones_like(y)
        return X * torch.sqrt(d / X.shape[0])[:, None]

    # -- one communication round ------------------------------------------------
    def round_fn(self):
        dim, k = self.dim, self.k
        policy = as_policy(self.sketch, k=k)
        if policy.adaptive:
            raise ValueError(
                "DistributedFLeNS runs one fixed-shape step: adaptive-k "
                f"sketch policies ({policy.spec()!r}) cannot resize it; "
                "use a constant-k fresh/fixed/rotating schedule")
        group = axis_group(self.mesh, self._axes())
        n_clients = self._n_clients()

        def step(X, y, w, w_prev, seed: int):
            v = w + self.beta * (w - w_prev)
            # the seed is the round index: a fresh schedule keys the basis
            # from it directly, a fixed or rotating one from its epoch
            sketch = policy.sample(key_from_ints(seed), seed, dim,
                                   dtype=w.dtype, device=w.device)
            eye = torch.eye(k, dtype=w.dtype, device=w.device)
            sst = sketch.apply(sketch.apply_t(eye))

            a = self._local_hess_sqrt(X, y, v)
            b = sketch.apply(a)  # (n_loc, k)
            h_sk = b.T @ b  # k x k: the uplink payload
            g_sk = sketch.apply(self._local_grad(X, y, v))

            # server aggregation: the mean over the client axes (one
            # all-reduce of the k^2 + k values, then / n)
            if group is not None:
                flat = torch.cat([h_sk.reshape(-1), g_sk])
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
                flat = flat / n_clients
                h_sk, g_sk = flat[:k * k].reshape(k, k), flat[k * k:]

            h_tilde = h_sk + self.lam * sst + self.lam_damp * eye
            delta = sketch.apply_t(solve(h_tilde, g_sk))
            w_next = v - self.mu * delta
            return w_next, w

        return step

    # -- data placement ------------------------------------------------------------
    def shard_data(self, X: torch.Tensor, y: torch.Tensor):
        """This rank's client rows of the global dataset: the contiguous
        block at its index over the client axes (the reference's
        ``NamedSharding(P(axes))``); raises when the rows do not divide."""
        n, m = X.shape[0], self._n_clients()
        if n % m:
            raise ValueError(f"{n} rows do not divide over {m} clients "
                             f"(client axes {self._axes()})")
        per = n // m
        j = axis_index(self.mesh, self._axes())
        return X[j * per:(j + 1) * per], y[j * per:(j + 1) * per]


def run_distributed(dist_flens: DistributedFLeNS, X, y, w0, rounds: int,
                    seed0: int = 0):
    """Convenience driver: ``rounds`` rounds from the global dataset on
    every rank; returns (w, the iterate path)."""
    step = dist_flens.round_fn()
    Xs, ys = dist_flens.shard_data(X, y)
    w, w_prev = w0, w0
    ws = [w0]
    for t in range(rounds):
        w, w_prev = step(Xs, ys, w, w_prev, seed0 + t)
        ws.append(w)
    return w, ws
