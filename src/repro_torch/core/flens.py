"""FLeNS — Federated Learning with Enhanced Nesterov-Newton Sketch.

Counterpart of ``repro.core.flens`` (the paper's Algorithm 1 made
dimensionally consistent, and the FLeNS+ variant):

  1. Nesterov look-ahead       v_t = w_t + beta_t (w_t - w_{t-1})
  2. Every client j computes   g_j(v_t) and the two-sided sketch
                               H~_j = (A_j S^T)^T (A_j S^T) in R^{k x k}
     with the SAME per-round SRHT S (the server broadcasts the key).
  3. Uplink per client: H~_j (k^2 floats) + S g_j (k floats).
  4. Server: delta = S^T (sum_j p_j H~_j + lam S S^T + lam_damp I)^-1
     (S g), w_{t+1} = v_t - mu * delta.

``variant="plus"`` adds the raw gradient to the uplink and a first-order
step in the orthogonal complement of the sketch subspace:
w_{t+1} = v_t - mu * delta - eta * (g - P_S g).

The round runs on the device without waiting on it: the sketch products
are batched kernel launches over all clients, the solves use
``solve_ex`` (no error check that would read back), and the guard (a
rejected step keeps w and kills the momentum; the trust scale halves on
reject and doubles back on accept) is ``torch.where`` on device
scalars. Only the adaptive-k hook, which runs on the host between
rounds, reads the trust scale back, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.comm import NULL_COMM
from repro_torch.core.base import FederatedOptimizer, OptState, solve
from repro_torch.core.sketch_policy import (
    SketchPolicy,
    as_policy,
    loss_effective_dimension,
)

# lower bound of the guard's backtracking trust scale: rejects halve the
# scale down to this floor, accepts double it back (capped at 1)
_MIN_TRUST_SCALE = 1.0 / 64.0


class FLeNS(FederatedOptimizer):
    name = "flens"

    def __init__(
        self,
        k: int,
        mu: float = 1.0,
        beta: "float | str" = "paper",
        sketch: "str | SketchPolicy" = "srht",
        lam_damp: float = 1e-8,
        variant: str = "paper",  # "paper" | "plus"
        eta: "float | None" = None,  # complement step size (plus); None -> 1/L1
        step_from: str = "v",  # "v" (standard accelerated) | "w" (paper literal)
        restart: bool = True,  # function-value adaptive momentum restart
    ):
        self.policy = as_policy(sketch, k=k)
        self.mu = mu
        self.beta = beta
        self.lam_damp = lam_damp
        self.variant = variant
        self.eta = eta
        self.step_from = step_from
        self.restart = restart
        self._guard_scale = 1.0  # host-side adaptive-k reject detector
        if self.policy.adaptive and not restart:
            raise ValueError(
                "adaptive-k sketch policies need the guard (restart=True): "
                "the k ramp is driven by its rejected steps")
        if variant == "plus":
            self.name = "flens_plus"

    @property
    def k(self) -> int:
        return self.policy.k

    @k.setter
    def k(self, value: int) -> None:
        self.policy = self.policy.with_k(value)

    # -- momentum schedule ---------------------------------------------------
    def _beta_value(self, problem, w0: torch.Tensor) -> float:
        if isinstance(self.beta, (int, float)):
            return float(self.beta)
        evals = torch.linalg.eigvalsh(problem.global_hessian(w0))
        l1 = float(evals[-1])
        gam = max(float(evals[0]), problem.lam)
        if self.beta == "paper":  # Assumption A7: (L1 - gamma)/(L1 + gamma)
            return (l1 - gam) / (l1 + gam)
        if self.beta == "sqrt":  # classical accelerated-GD schedule
            sl, sg = l1 ** 0.5, gam ** 0.5
            return (sl - sg) / (sl + sg)
        raise ValueError(f"unknown beta rule {self.beta!r}")

    def init(self, problem, w0):
        if self.policy.adaptive:
            d_eff = loss_effective_dimension(problem, w0)
            self.policy = self.policy.resolved(d_eff, cap=problem.dim)
            self._guard_scale = 1.0
        beta = self._beta_value(problem, w0)
        like = dict(dtype=w0.dtype, device=w0.device)
        state = {
            "w": w0,
            "w_prev": w0,
            "beta": torch.tensor(beta, **like),
            "loss": problem.global_value(w0),
            "scale": torch.tensor(1.0, **like),
            # round counter: the rotation-epoch input of the schedule (a
            # host integer, so deriving the basis key never syncs)
            "t": 0,
        }
        if self.variant == "plus":
            if self.eta is None:
                h = problem.global_hessian(w0)
                eta = 1.0 / float(torch.linalg.eigvalsh(h)[-1])
            else:
                eta = float(self.eta)
            state["eta"] = torch.tensor(eta, **like)
        return state

    # -- host-side adaptive-k hook (run_rounds calls this pre-round) ---------
    def round_signature(self, round_idx: int, state: OptState):
        if not self.policy.adaptive:
            return None
        # a trust-scale drop since the last round (or sitting at the
        # floor) means the guard rejected: ramp k toward k_max
        scale = float(state.get("scale", 1.0))
        rejected = scale < self._guard_scale or scale <= _MIN_TRUST_SCALE
        if round_idx > 0 and rejected:
            self.policy = self.policy.ramped()
        self._guard_scale = scale
        return ("flens_k", self.policy.k)

    # -- one communication round ----------------------------------------------
    def round(self, problem, state: OptState, key, comm=None) -> OptState:
        comm = NULL_COMM if comm is None else comm
        w, w_prev, beta = state["w"], state["w_prev"], state["beta"]
        t = state["t"]
        dim = problem.dim
        like = dict(dtype=w.dtype, device=w.device)

        # (1) Nesterov look-ahead
        v = w + beta * (w - w_prev)

        # server broadcast: the look-ahead iterate and the basis key
        v_bcast = comm.downlink("w", v)
        skey = comm.downlink("seed", self.policy.basis_key(key, t))

        # (2) the round's shared sketch
        s = self.policy.materialize(skey, dim, dtype=w.dtype, device=w.device)
        eye_k = torch.eye(self.k, **like)
        sst = s.apply(s.apply_t(eye_k))  # S S^T (k, k)

        # client side, batched over all clients: local gradients and the
        # sketched Hessian square roots A_j S^T (one launch each)
        gs = problem.local_grad(v_bcast)  # (m, M)
        a = problem.local_hess_sqrt(v_bcast)  # (m, n_shard, M)
        bj = s.apply(a)  # (m, n_shard, k)
        h_sk = bj.transpose(1, 2) @ bj  # (m, k, k)
        sg = s.apply(gs)  # (m, k)

        persistent = self.policy.basis_persistent()
        reset = self.policy.ef_reset(t)
        h_sk = comm.uplink("h_sk", h_sk, ef_eligible=persistent,
                           ef_reset=reset)
        sg = comm.uplink("sg", sg, ef_eligible=persistent, ef_reset=reset)

        # (3)+(4) server aggregation and sketched-subspace Newton step
        p = comm.weights(problem.client_weights)
        h_tilde = torch.einsum("j,jab->ab", p, h_sk) + problem.lam * sst
        g_sk = torch.einsum("j,jk->k", p, sg)
        delta_k = solve(h_tilde + self.lam_damp * eye_k, g_sk)
        delta = s.apply_t(delta_k)

        base = v if self.step_from == "v" else w
        scale = state["scale"]
        w_next = base - scale * self.mu * delta

        if self.variant == "plus":
            gs_hat = comm.uplink("grad", gs)  # full gradient (O(M) uplink)
            g = torch.einsum("j,jm->m", p, gs_hat)
            proj = s.apply_t(solve(sst, s.apply(g)))  # P_S g
            w_next = w_next - scale * state["eta"] * (g - proj)

        # guarded step: clients piggyback their local loss at w_next
        if self.restart:
            lv = problem.local_value(comm.downlink("w_next", w_next))
            lv = comm.uplink("loss", lv)
        else:
            # the server reads the local losses without an uplink
            lv = problem.gather_cohort(problem.local_value(w_next))
        loss_next = torch.sum(p * lv)
        if self.restart:
            # NaN-safe acceptance: a NaN loss is a rejected step
            ok = loss_next <= state["loss"]
            w_out = torch.where(ok, w_next, w)
            w_prev_out = torch.where(ok, w, w_out)  # reject -> zero momentum
            loss_out = torch.where(ok, loss_next, state["loss"])
            scale_out = torch.where(ok, torch.clamp(scale * 2.0, max=1.0),
                                    torch.clamp(scale * 0.5,
                                                min=_MIN_TRUST_SCALE))
        else:
            w_out, w_prev_out, loss_out = w_next, w, loss_next
            scale_out = scale
        out = {"w": w_out, "w_prev": w_prev_out, "beta": beta,
               "loss": loss_out, "scale": scale_out, "t": t + 1}
        if self.variant == "plus":
            out["eta"] = state["eta"]
        return out

    def uplink_floats(self, problem) -> int:
        extra = 1 if self.restart else 0  # piggybacked local-loss scalar
        if self.variant == "plus":
            return self.k * self.k + self.k + problem.dim + extra
        return self.k * self.k + self.k + extra

    def downlink_floats(self, problem) -> int:
        # a guarded round broadcasts the look-ahead model, the candidate
        # iterate and the sketch basis key: 2M + 1
        if self.restart:
            return 2 * problem.dim + 1
        return problem.dim + 1
