"""Mixture-of-Experts FFN, the counterpart of ``repro.models.moe`` on one
shard (the reference's path with no mesh).

Routing is top-k softmax with a Switch-style load-balance auxiliary loss
and capacity-factor token dropping: every token's k assignments, in
token-major order (flat index t k + j), take the next free place of
their expert's capacity buffer, and an assignment past the capacity is
dropped (a dummy slot, contributing 0). The kept rows go through the
experts' gated MLPs as three batched products over (E, C, .) and come
back weighted, each token's k contributions summed in slot order in the
activations' dtype. The reference's sharded and decode branches
(``shard_map`` over an expert mesh) come with ROADMAP queue 1, item 2.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ModelConfig,
    dense_init,
    mlp_apply,
    mlp_init,
    residual_scale,
    stacked_dense_init,
)

# the ROADMAP item that brings moe_apply's sharded and decode branches
DISTRIBUTION_ITEM = 2
# where ``record_routes`` collects each call's routing (None: off)
_routes: "list | None" = None


def moe_init(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """Router (D, E), experts' w_gate / w_up (E, D, F) and w_down (E, F,
    D), and the shared expert's MLP (width ``moe_d_ff`` times the shared
    count) where the config has one; ``lead`` prepends stacking axes
    (layers). The expert stacks are drawn a matrix at a time."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    dt = cfg.param_dtype
    params = {
        "router": dense_init(gen, (*lead, d, e), d, dt),
        "w_gate": stacked_dense_init(gen, (*lead, e, d, f), d, dt),
        "w_up": stacked_dense_init(gen, (*lead, e, d, f), d, dt),
        "w_down": stacked_dense_init(gen, (*lead, e, f, d), f, dt,
                                     scale=residual_scale(cfg)),
    }
    if cfg.n_shared_experts:
        params["shared"] = mlp_init(gen, cfg, lead=lead,
                                    d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return params


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest of each row, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no order)."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg: ModelConfig):
    """Top-k routing of (T, D) tokens in float32: (ids (T, k), weights
    (T, k) renormalised to sum 1, the Switch loss E sum_e mean_prob_e
    mean_count_e)."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    weights, ids = _top_k(probs, cfg.top_k)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    e, t = cfg.n_experts, x_flat.shape[0]
    me = torch.mean(probs, dim=0)  # mean router prob per expert
    ce = _counts(ids.reshape(-1), e).float() / t  # assignments per token
    aux = e * torch.sum(me * ce)
    return ids, weights, aux


def _counts(flat_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments to each expert (an integer scatter-add: exact, and no
    host sync, which ``torch.bincount`` on the card makes)."""
    return torch.zeros(n_experts, dtype=flat_ids.dtype,
                       device=flat_ids.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))


def _dispatch(flat_ids: torch.Tensor, n_experts: int, capacity: int):
    """(pos, keep, slot) of the (T k,) assignments in token-major order:
    ``pos`` the exclusive count of earlier assignments to the same expert
    (a stable sort by expert keeps their order), ``keep`` pos < capacity,
    ``slot`` the row of the (E C + 1, D) buffer, the last a dummy for the
    dropped."""
    n = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    counts = _counts(flat_ids, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_ids)
    pos[order] = (torch.arange(n, device=flat_ids.device)
                  - starts[flat_ids[order]])
    keep = pos < capacity
    slot = torch.where(keep, flat_ids * capacity + pos,
                       n_experts * capacity)
    return pos, keep, slot


def _expert_compute(w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, xs: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Grouped gated MLP over the capacity buffers: xs (E, C, D) ->
    (E, C, D)."""
    gate = torch.bmm(xs, w_gate)
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate,
                                                        approximate="tanh")
    return torch.bmm(act * torch.bmm(xs, w_up), w_down)


def _moe_shard_body(x_flat: torch.Tensor, router_w: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, *, cfg: ModelConfig,
                    capacity: int):
    """The MoE of (T, D) tokens on one shard holding every expert:
    (out (T, D), aux, drop_frac)."""
    t, d = x_flat.shape
    e, k = cfg.n_experts, cfg.top_k
    ids, weights, aux = _route(router_w, x_flat, cfg)
    _, keep, slot = _dispatch(ids.reshape(-1), e, capacity)

    # the kept rows into (E, C, D), assignment t k + j taking token t's
    # row; every dropped row writes zeros to the dummy slot
    rows = x_flat[:, None].expand(t, k, d).reshape(t * k, d)
    rows = torch.where(keep[:, None], rows, 0.0)
    buf = torch.zeros((e * capacity + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device).index_put((slot,), rows)
    ys = _expert_compute(w_gate, w_up, w_down,
                         buf[:-1].reshape(e, capacity, d), cfg)

    # combine: each contribution times its weight in x's dtype, a token's
    # k contributions added in slot order (the reference's scatter-add
    # into zeros, token by token; no atomics, so no run-to-run rounding)
    ys_flat = ys.reshape(e * capacity, d)
    contrib = torch.where(
        keep[:, None], ys_flat[torch.clamp(slot, max=e * capacity - 1)], 0.0
    ) * weights.reshape(-1)[:, None].to(x_flat.dtype)
    contrib = contrib.reshape(t, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    drop_frac = 1.0 - torch.sum(keep.float()) / (t * k)
    if _routes is not None:
        _routes.append({"ids": ids.detach(), "keep": keep.reshape(t, k),
                        "slot": slot.reshape(t, k), "capacity": capacity,
                        "drop_frac": drop_frac.detach()})
    return out, aux, drop_frac


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              capacity: "int | None" = None, mesh=None):
    """MoE FFN. x (B, T, D) -> (out (B, T, D), aux loss, drop fraction).
    Each expert's ``capacity`` defaults to max(4, int(capacity_factor k
    B T / E)), counting the call's B T tokens (a padded prompt's too),
    and is at most B T k. The reference's sharded and decode branches
    take a mesh; the port has none yet, and a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            f"moe_apply on a mesh (the reference's shard_map branches) comes "
            f"with ROADMAP queue 1, item {DISTRIBUTION_ITEM} (distribution)")
    b, t, d = x.shape
    if capacity is None:
        capacity = max(4, int(cfg.capacity_factor * cfg.top_k * b * t
                              / max(cfg.n_experts, 1)))
    capacity = min(capacity, b * t * cfg.top_k)
    out, aux, drop = _moe_shard_body(
        x.reshape(b * t, d), params["router"], params["w_gate"],
        params["w_up"], params["w_down"], cfg=cfg, capacity=capacity)
    out = out.reshape(b, t, d)
    if cfg.n_shared_experts:
        out = out + mlp_apply(params["shared"], x, cfg)
    return out, aux, drop


@contextlib.contextmanager
def record_routes():
    """Collect the routing of every ``moe_apply`` call inside the block,
    in call order: a list of {"ids" (T, k), "keep" and "slot" (T, k),
    "capacity", "drop_frac"} (the card's checks count the choices and
    keeps on which two runs differ, and report each layer's drops)."""
    global _routes
    prev, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = prev
