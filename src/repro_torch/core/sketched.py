"""Sketched Newton-type federated baselines: FedNS and FedNDES (Li 2024).

Counterpart of ``repro.core.sketched``. FedNS: each client sketches its
Hessian square root on the data axis and uploads ``S_j A_j`` of size
(k, M), so the server rebuilds ``H ~= sum_j p_j (S_j A_j)^T (S_j A_j) +
lam I``. Uplink O(kM). FedNDES: FedNS with k chosen from the effective
dimension d_lambda of the global loss Hessian at w0.

Each client has its own operator S_j, drawn through the
``SketchPolicy``: all m in one batched draw from the round's basis key
(``materialize_batch``: the round's key for the fresh default, a pure
function of ``(seed, epoch)`` for ``"srht:fixed"`` / ``"srht:rotate=R"``,
which makes the ``sa`` payload eligible for error feedback). The m
sketches are one batched ``srht_apply`` over the contiguous transpose
of A (m, M, n_shard): one kernel launch a round for all clients
(``sketch_sqrt_rows``).
"""
from __future__ import annotations

import torch

from repro_torch.comm import NULL_COMM
from repro_torch.core.base import FederatedOptimizer, OptState, solve
from repro_torch.core.sketch import sketch_sqrt_rows
from repro_torch.core.sketch_policy import (
    SketchPolicy,
    adaptive_k,
    as_policy,
    loss_effective_dimension,
)


class FedNS(FederatedOptimizer):
    """Federated Newton sketch with per-client data-axis sketches."""

    name = "fedns"

    def __init__(self, k: int, mu: float = 1.0,
                 sketch: "str | SketchPolicy" = "srht"):
        self.policy = as_policy(sketch, k=k)
        if self.policy.adaptive:
            # nothing here ramps k mid-run (the guard signal is a FLeNS
            # construct); FedNDES sizes k from the effective dimension
            raise ValueError(
                f"{type(self).__name__} does not support adaptive-k sketch "
                f"policies ({self.policy.spec()!r}); use FLeNS for the "
                f"guard-driven ramp or FedNDES for effective-dimension "
                f"sizing")
        self.mu = mu

    @property
    def k(self) -> int:
        return self.policy.k

    @k.setter
    def k(self, value: int) -> None:
        self.policy = self.policy.with_k(value)

    def init(self, problem, w0):
        # the round counter is a host integer: deriving the basis key of
        # a fixed or rotating schedule never waits on the device
        return {"w": w0, "t": 0}

    def round(self, problem, state: OptState, key, comm=None) -> OptState:
        comm = NULL_COMM if comm is None else comm
        w, t = state["w"], state["t"]
        # clients sketch at the decoded broadcast (their data-axis
        # sketches are drawn locally: no basis broadcast); the server
        # steps from its exact iterate
        w_bcast = comm.downlink("w", w)
        p = comm.weights(problem.client_weights)
        gs = comm.uplink("grad", problem.local_grad(w_bcast))
        g = torch.einsum("j,jm->m", p, gs)
        a = problem.local_hess_sqrt(w_bcast)  # (m, n_shard, M)
        s = self.policy.materialize_batch(
            self.policy.basis_key(key, t), problem.m, a.shape[1],
            dtype=a.dtype, device=a.device)
        sa = sketch_sqrt_rows(s, a)  # (m, k, M)
        # a fresh basis makes cross-round EF memory meaningless; a fixed
        # or rotating one keeps the payload in a stable coordinate
        # system, its residual reset whenever a rotation draws anew
        sa = comm.uplink("sa", sa,
                         ef_eligible=self.policy.basis_persistent(),
                         ef_reset=self.policy.ef_reset(t))
        h_tilde = torch.einsum("j,jka,jkb->ab", p, sa, sa)
        h_tilde = h_tilde + problem.lam * torch.eye(
            problem.dim, dtype=w.dtype, device=w.device)
        return {"w": w - self.mu * solve(h_tilde, g), "t": t + 1}

    def uplink_floats(self, problem) -> int:
        return self.k * problem.dim + problem.dim


class FedNDES(FedNS):
    """FedNS with a dimension-efficient (effective-dimension) sketch size.

    ``init`` computes d_lambda at w0 and sets k = ceil(c * d_lambda),
    clipped to [k_min, n_shard]; then it runs as FedNS.
    """

    name = "fedndes"

    def __init__(self, mu: float = 1.0, sketch: "str | SketchPolicy" = "srht",
                 c: float = 2.0, k_min: int = 8):
        super().__init__(k=k_min, mu=mu, sketch=sketch)
        self.c = c
        self.k_min = k_min

    def init(self, problem, w0):
        d_lam = loss_effective_dimension(problem, w0)
        n_shard = problem.X.shape[1]
        self.k = adaptive_k(d_lam, c=self.c, k_min=self.k_min, k_max=n_shard)
        return super().init(problem, w0)
