"""FLeNS-head: the paper's optimizer on the head of an LM
(``repro.optim.flens_head``).

A logistic readout on frozen backbone features is exactly the paper's
convex problem with X := features, so FLeNS applies to it as it is. Per
round every client holds the features of its own sequences, forms its
local gradient and two-sided sketched Hessian of the head objective,
and the server takes the FLeNS step. This module is the glue from an LM
backbone to a ``repro_torch.core`` ``FederatedProblem`` (see
``examples/federated_llm_torch.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import FLeNS, logistic, make_problem
from repro_torch.core.federated import FederatedProblem
from repro_torch.models.common import embed


@torch.no_grad()
def extract_features(model, params, tokens: torch.Tensor, *,
                     pool: str = "mean") -> torch.Tensor:
    """Backbone features (B, D) float32 of a token batch (B, T): the
    cache-free backbone's final-norm output, averaged over the positions
    (``pool="mean"``) or at the last one (``"last"``); no LM head."""
    x = embed(params["embed"], tokens, model.cfg)
    feats, _, _ = model._backbone(params, x)
    if pool == "mean":
        return torch.mean(feats.float(), dim=1)
    if pool == "last":
        return feats[:, -1].float()
    raise ValueError(pool)


def head_problem(features: torch.Tensor, labels: torch.Tensor, m_clients: int,
                 lam: float = 1e-3, heterogeneity: str = "iid",
                 seed: int = 0) -> FederatedProblem:
    """The convex head objective as a federated problem in float64 on the
    features' device: features (N, D), labels (N,) in {-1, +1}, split
    over ``m_clients`` as ``make_problem`` splits (``seed`` draws the
    iid permutation)."""
    return make_problem(features.double(), labels.double(), m=m_clients,
                        lam=lam, objective=logistic,
                        heterogeneity=heterogeneity, seed=seed,
                        device=features.device)


def flens_head_init(problem: FederatedProblem, *, k: int, **flens_kw):
    """(FLeNS(k, ...), its state at the zero head)."""
    opt = FLeNS(k=k, **flens_kw)
    w0 = torch.zeros((problem.dim,), dtype=problem.X.dtype,
                     device=problem.X.device)
    return opt, opt.init(problem, w0)


def flens_head_update(opt: FLeNS, problem: FederatedProblem, state, key):
    """One FLeNS round on the head; ``key`` is the round's key."""
    return opt.round(problem, state, key)
