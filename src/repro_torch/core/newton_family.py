"""Newton-type federated baselines from the paper's Table I.

Counterpart of ``repro.core.newton_family``:

* FedNewton           — exact aggregated Hessian (O(M^2) uplink)
* DistributedNewton   — GIANT-style averaged local-Newton directions
* LocalNewton         — L local Newton iterations, average weights
* FedNew              — one-pass ADMM direction (Elgabli et al. 2022)
* FedNL               — rank-1 compressed Hessian learning (Safaryan 2022)

Every per-client solve and power iteration is one batched call over the
client axis (where the reference used ``vmap``); solves use ``solve``
(``torch.linalg.solve_ex``), which never waits on the device.
"""
from __future__ import annotations

import torch

from repro_torch.comm import NULL_COMM
from repro_torch.core.base import FederatedOptimizer, OptState, solve
from repro_torch.core.sketch_policy import SketchPolicy
from repro_torch.keys import generator


def _eye(problem) -> torch.Tensor:
    return torch.eye(problem.dim, dtype=problem.X.dtype, device=problem.X.device)


class FedNewton(FederatedOptimizer):
    """Exact federated Newton: aggregate full local Hessians + gradients."""

    name = "fednewton"

    def __init__(self, mu: float = 1.0):
        self.mu = mu

    def round(self, problem, state: OptState, key, comm=None) -> OptState:
        comm = NULL_COMM if comm is None else comm
        w = state["w"]
        # clients differentiate at the decoded broadcast; the server
        # steps from its own exact iterate
        w_bcast = comm.downlink("w", w)
        gs = comm.uplink("grad", problem.local_grad(w_bcast))
        hs = comm.uplink("hess", problem.local_hessian(w_bcast))
        p = comm.weights(problem.client_weights)
        g = torch.einsum("j,jm->m", p, gs)
        h = torch.einsum("j,jab->ab", p, hs)
        return {"w": w - self.mu * solve(h, g)}

    def uplink_floats(self, problem) -> int:
        return problem.dim * problem.dim + problem.dim


class DistributedNewton(FederatedOptimizer):
    """GIANT-style (Ghosh et al. 2020): average of H_j^{-1} g_global.

    Two-phase round: (1) clients upload local gradients, the server
    broadcasts the global gradient; (2) clients return local-Newton
    directions H_j^{-1} g, the server averages. Uplink 2M per round.
    """

    name = "distributed_newton"

    def __init__(self, mu: float = 1.0):
        self.mu = mu

    def round(self, problem, state: OptState, key, comm=None) -> OptState:
        comm = NULL_COMM if comm is None else comm
        w = state["w"]
        w_bcast = comm.downlink("w", w)
        p = comm.weights(problem.client_weights)
        # phase 1: gradients up, the global gradient broadcast back (a
        # second O(M) downlink this round, billed)
        gs = comm.uplink("grad", problem.local_grad(w_bcast))
        g = comm.downlink("grad", torch.einsum("j,jm->m", p, gs))
        # phase 2: local-Newton directions up
        hs = problem.local_hessian(w_bcast)  # (m, M, M)
        dirs = solve(hs, g.expand(problem.m, problem.dim))
        dirs = comm.uplink("dir", dirs)
        d = torch.einsum("j,jm->m", p, dirs)
        return {"w": w - self.mu * d}

    def uplink_floats(self, problem) -> int:
        return 2 * problem.dim

    def downlink_floats(self, problem) -> int:
        # the model and the global-gradient broadcast of phase 1
        return 2 * problem.dim


class LocalNewton(FederatedOptimizer):
    """Gupta et al. 2021: L local Newton iterations, average the weights."""

    name = "local_newton"

    def __init__(self, mu: float = 1.0, local_iters: int = 2):
        self.mu = mu
        self.local_iters = local_iters

    def round(self, problem, state: OptState, key, comm=None) -> OptState:
        comm = NULL_COMM if comm is None else comm
        # clients iterate from the decoded broadcast
        w = comm.downlink("w", state["w"])
        wl = w.expand(problem.m, problem.dim)
        for _ in range(self.local_iters):
            step = solve(problem.local_hessian_at(wl), problem.local_grad_at(wl))
            wl = wl - self.mu * step
        w_locals = comm.uplink("w_local", wl)
        p = comm.weights(problem.client_weights)
        return {"w": torch.einsum("j,jm->m", p, w_locals)}

    def uplink_floats(self, problem) -> int:
        return problem.dim


class FedNew(FederatedOptimizer):
    """Elgabli et al. 2022: one-pass ADMM for the Newton direction.

    Clients keep a direction d_j and a dual y_j; each round runs one ADMM
    sweep on  min_d 0.5 d^T H_j d - g_j^T d  s.t. d_j = d_bar:
        d_j   <- (H_j + rho I)^{-1} (g_j + rho d_bar - y_j)
        d_bar <- weighted mean of d_j
        y_j   <- y_j + alpha (d_j - d_bar)
    and the server steps  w <- w - mu d_bar.
    """

    name = "fednew"
    # the duals are dense (m, dim) state carried across rounds
    per_client_state = True

    def __init__(self, mu: float = 1.0, rho: float = 0.1, alpha: float = 0.25):
        self.mu = mu
        self.rho = rho
        self.alpha = alpha

    def init(self, problem, w0):
        return {
            "w": w0,
            "d_bar": torch.zeros_like(w0),
            "duals": w0.new_zeros((problem.m, problem.dim)),
        }

    def round(self, problem, state: OptState, key, comm=None) -> OptState:
        comm = NULL_COMM if comm is None else comm
        w, d_bar, duals = state["w"], state["d_bar"], state["duals"]
        # clients receive the model and the averaged direction: two O(M)
        # broadcasts per ADMM sweep, both billed
        w_bcast = comm.downlink("w", w)
        d_bar_bcast = comm.downlink("d_bar", d_bar)
        gs = problem.local_grad(w_bcast)  # (m, M)
        hs = problem.local_hessian(w_bcast)  # (m, M, M)
        rhs = gs + self.rho * d_bar_bcast - duals
        ds = solve(hs + self.rho * _eye(problem), rhs)
        ds_wire = comm.uplink("dir", ds)  # the server sees the decoded copy
        p = comm.weights(problem.client_weights)
        d_new = torch.einsum("j,jm->m", p, ds_wire)
        # each client advances its dual from its own exact d_j; only
        # delivering clients observe d_bar and update at all
        duals = comm.where_delivered(
            duals + self.alpha * (ds - d_new[None]), duals)
        return {"w": w - self.mu * d_new, "d_bar": d_new, "duals": duals}

    def uplink_floats(self, problem) -> int:
        return problem.dim

    def downlink_floats(self, problem) -> int:
        # the model and the averaged-direction broadcast d_bar
        return 2 * problem.dim


class FedNL(FederatedOptimizer):
    """Safaryan et al. 2022: compressed Hessian learning.

    The server keeps a Hessian model B; clients send a rank-1 (top
    eigenpair, by power iteration) compression of (H_j(w_t) - B_t) and
    their gradient; B takes the aggregated compressed differences and the
    step uses (B + l_reg I)^{-1}.
    """

    name = "fednl"

    # the rank-1 eigenbasis is re-derived by power iteration every round:
    # a per-round basis, so the hess_delta payload is never EF-eligible
    _eig_basis = SketchPolicy.per_round("rank1-eig")

    def __init__(self, mu: float = 1.0, power_iters: int = 16,
                 l_reg: float = 1e-3):
        self.mu = mu
        self.power_iters = power_iters
        self.l_reg = l_reg

    def init(self, problem, w0):
        return {"w": w0, "B": problem.global_hessian(w0)}

    def power_init(self, key: torch.Tensor, m: int, dim: int,
                   like: torch.Tensor) -> torch.Tensor:
        """The m power-iteration start vectors (m, dim), standard normal,
        in one draw from the round's key."""
        return torch.randn((m, dim), generator=generator(key, like.device),
                           dtype=like.dtype, device=like.device)

    def _rank1_compress(self, delta: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
        """Top eigenpair of each symmetric difference delta (m, M, M) by
        power iteration from v (m, M): lam v v^T, (m, M, M)."""
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        for _ in range(self.power_iters):
            v = torch.einsum("jab,jb->ja", delta, v)
            v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)
        lam = torch.einsum("ja,ja->j", v, torch.einsum("jab,jb->ja", delta, v))
        return lam[:, None, None] * (v[:, :, None] * v[:, None, :])

    def round(self, problem, state: OptState, key, comm=None) -> OptState:
        comm = NULL_COMM if comm is None else comm
        w, B = state["w"], state["B"]
        # clients differentiate at the decoded broadcast; B needs no
        # broadcast: clients mirror it from the same compressed updates
        w_bcast = comm.downlink("w", w)
        p = comm.weights(problem.client_weights)
        gs = comm.uplink("grad", problem.local_grad(w_bcast))
        g = torch.einsum("j,jm->m", p, gs)
        hs = problem.local_hessian(w_bcast)  # (m, M, M)
        v0 = self.power_init(key, problem.m, problem.dim, w)
        comps = self._rank1_compress(hs - B, v0)
        # the native wire format is one (value, vector) eigenpair per
        # client, not the (M, M) outer product; the B update is already
        # Hessian-space error feedback, so generic EF stays off
        comps = comm.uplink("hess_delta", comps,
                            wire_shape=(problem.dim + 1,),
                            ef_eligible=self._eig_basis.basis_persistent())
        B = B + torch.einsum("j,jab->ab", p, comps)
        # PSD safeguard: symmetrize, then a ridge in the step
        B = 0.5 * (B + B.T)
        step = solve(B + self.l_reg * _eye(problem), g)
        return {"w": w - self.mu * step, "B": B}

    def uplink_floats(self, problem) -> int:
        # rank-1 eigenpair (M + 1) + gradient (M)
        return 2 * problem.dim + 1
