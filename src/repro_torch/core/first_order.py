"""First-order federated baselines: FedAvg and FedProx.

Counterpart of ``repro.core.first_order``. Both transmit only the
locally updated model (O(M) uplink) and average on the server: the
sublinear-rate baselines of the paper's Table I. The reference runs each
client's local steps as ``scan`` under ``vmap``; here the m local
iterates are one (m, M) tensor and each local step is one batched
gradient over all clients (``FederatedProblem.local_grad_at``).
"""
from __future__ import annotations

import torch

from repro_torch.comm import NULL_COMM
from repro_torch.core.base import FederatedOptimizer, OptState


class FedAvg(FederatedOptimizer):
    """McMahan et al. 2017: E local full-batch GD steps, weighted average."""

    name = "fedavg"

    def __init__(self, lr: float = 1.0, local_steps: int = 5):
        self.lr = lr
        self.local_steps = local_steps

    def _local_step(self, problem, wl: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
        """One local GD step of every client from its iterate wl (m, M);
        w is the broadcast the run started from."""
        return wl - self.lr * problem.local_grad_at(wl)

    def round(self, problem, state: OptState, key, comm=None) -> OptState:
        comm = NULL_COMM if comm is None else comm
        # clients start their local runs from the decoded broadcast
        w = comm.downlink("w", state["w"])
        wl = w.expand(problem.m, problem.dim)
        for _ in range(self.local_steps):
            wl = self._local_step(problem, wl, w)
        w_locals = comm.uplink("w_local", wl)
        p = comm.weights(problem.client_weights)
        return {"w": torch.einsum("j,jm->m", p, w_locals)}

    def uplink_floats(self, problem) -> int:
        return problem.dim


class FedProx(FedAvg):
    """Li et al. 2020: FedAvg with a proximal term (mu/2)||w - w_t||^2."""

    name = "fedprox"

    def __init__(self, lr: float = 1.0, local_steps: int = 5,
                 mu_prox: float = 0.1):
        super().__init__(lr=lr, local_steps=local_steps)
        self.mu_prox = mu_prox

    def _local_step(self, problem, wl, w):
        # the proximal anchor is the decoded broadcast clients start
        # from: a client never sees the server's exact iterate
        g = problem.local_grad_at(wl) + self.mu_prox * (wl - w)
        return wl - self.lr * g
