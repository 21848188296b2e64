"""Mixture-of-Experts FFN, the counterpart of ``repro.models.moe``.

Routing is top-k softmax with a Switch-style load-balance auxiliary loss
and capacity-factor token dropping: every token's k assignments, in
token-major order (flat index t k + j), take the next free place of
their expert's capacity buffer, and an assignment past the capacity is
dropped (a dummy slot, contributing 0). The kept rows go through the
experts' gated MLPs as three batched products over (E, C, .) and come
back weighted, each token's k contributions summed in slot order in the
activations' dtype.

On a mesh (``repro_torch.sharding.ctx``) each rank runs the reference's
``shard_map`` body on its own shard with explicit collectives: the
expert-parallel branch (experts over ``model``, tokens over the batch
axes, outputs summed over ``model``) and the decode branch (tokens
all-gathered over ``data``, expert weights F-sharded over it, outputs
summed over (``data``, ``model``)). ``moe_local_params`` cuts a rank's
shard of the experts out of the global weights. The collectives carry
the gradients ``jax.grad`` gives through the reference's body
(``repro_torch.sharding.collectives``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import axis_group, axis_sizes
from repro_torch.models.common import (
    ModelConfig,
    dense_init,
    mlp_apply,
    mlp_init,
    residual_scale,
    stacked_dense_init,
)
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import ctx, rules
from repro_torch.sharding.ctx import get_mesh

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
                    capacity: int, n_exp_shards: int = 1, shard_idx: int = 0,
                    model_group=None):
    """The MoE of (T, D) tokens on one shard of ``n_exp_shards``, holding
    experts [shard_idx E_loc, (shard_idx + 1) E_loc): (out (T, D), aux,
    drop_frac). Every token is routed over all E experts; the shard keeps
    the assignments to its own experts. With ``model_group`` the partial
    outputs are summed (``psum``: the cotangent passes through) and the
    drop fractions averaged over it."""
    t, d = x_flat.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // n_exp_shards
    ids, weights, aux = _route(router_w, x_flat, cfg)
    flat_ids = ids.reshape(-1)
    if n_exp_shards == 1:
        _, keep, slot = _dispatch(flat_ids, e, capacity)
        assigned = t * k
    else:
        local_e = flat_ids - shard_idx * e_loc
        is_local = (local_e >= 0) & (local_e < e_loc)
        # another shard's assignments queue at a dummy expert e_loc
        _, keep, slot = _dispatch(torch.where(is_local, local_e, e_loc),
                                  e_loc + 1, capacity)
        keep = keep & is_local
        slot = torch.where(keep, slot, e_loc * capacity)
        assigned = torch.sum(is_local.float()) + 1e-9

    # the kept rows into (E_loc, C, D), assignment t k + j taking token
    # t's row; every dropped row writes zeros to the dummy slot
    rows = x_flat[:, None].expand(t, k, d).reshape(t * k, d)
    rows = torch.where(keep[:, None], rows, 0.0)
    buf = torch.zeros((e_loc * capacity + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device).index_put((slot,), rows)
    ys = _expert_compute(w_gate, w_up, w_down,
                         buf[:-1].reshape(e_loc, capacity, d), cfg)

    # combine: each contribution times its weight in x's dtype, a token's
    # k contributions added in slot order (the reference's scatter-add
    # into zeros, token by token; no atomics, so no run-to-run rounding)
    ys_flat = ys.reshape(e_loc * capacity, d)
    contrib = torch.where(
        keep[:, None],
        ys_flat[torch.clamp(slot, max=e_loc * capacity - 1)], 0.0
    ) * weights.reshape(-1)[:, None].to(x_flat.dtype)
    contrib = contrib.reshape(t, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    drop_frac = 1.0 - torch.sum(keep.float()) / assigned
    if model_group is not None:
        out = coll.sum_replicated(out, model_group)
        drop_frac = coll.mean_replicated(drop_frac, model_group)
    if _routes is not None:
        _routes.append({"ids": ids.detach(), "keep": keep.reshape(t, k),
                        "slot": slot.reshape(t, k), "capacity": capacity,
                        "drop_frac": drop_frac.detach()})
    return out, aux, drop_frac


def _shards(mesh) -> "tuple[int, int]":
    """(expert shards: the ``model`` axis, token shards: ``pod`` x
    ``data``) of a mesh, (1, 1) without one."""
    if mesh is None:
        return 1, 1
    sizes = axis_sizes(mesh)
    return (sizes.get("model", 1),
            sizes.get("pod", 1) * sizes.get("data", 1))


def moe_branch(mesh, b: int, t: int) -> str:
    """Which of the reference's three paths a (b, t) GLOBAL batch takes:
    ``"one"`` (no mesh, or one expert shard and one token shard),
    ``"decode"`` (b t <= 4096 on a mesh with a ``data`` axis) or
    ``"expert"`` (the expert-parallel one)."""
    n_exp, n_data = _shards(mesh)
    if mesh is None or n_exp == 1 and n_data == 1:
        return "one"
    if b * t <= 4096 and "data" in axis_sizes(mesh):
        return "decode"
    return "expert"


def moe_param_spec(mesh, path, leaf, *, branch: str) -> tuple:
    """The spec of an expert weight on ``branch``, the layout of the
    reference's ``in_specs``: E over ``model`` (``"expert"``), the
    serving layout with F over ``data`` too (``"decode"``, from
    ``sharding.rules.serving_param_spec``); the router, the shared
    expert and everything on ``"one"`` whole."""
    names = [str(p) for p in path]
    if (branch == "one" or len(names) < 2 or names[-2] != "moe"
            or names[-1] not in ("w_gate", "w_up", "w_down")):
        return ()
    if branch == "decode":
        return rules.serving_param_spec(mesh, path, leaf)
    lead = (None,) * (leaf.ndim - 3)
    return rules._guard(mesh, tuple(leaf.shape), lead + ("model", None, None))


def moe_local_params(mesh, params: dict, branch: str,
                     rank: "int | None" = None) -> dict:
    """The shard of a global ``moe`` parameter tree (stacked or one
    layer's) that ``rank`` (this process's on a ``DeviceMesh``) passes to
    ``moe_apply`` on ``branch``."""
    return rules.shard_tree(mesh, params, moe_param_spec, rank=rank,
                            prefix=("moe",), branch=branch)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              capacity: "int | None" = None):
    """MoE FFN. x (B, T, D) -> (out (B, T, D), aux loss, drop fraction).

    Without a mesh (``sharding.ctx.get_mesh()``) every expert is here,
    and each expert's ``capacity`` defaults to max(4, int(capacity_factor
    k B T / E)), counting the call's B T tokens (a padded prompt's too),
    at most B T k. On a mesh, x is this rank's batch shard (B / (pod x
    data) rows of the global batch) and ``params`` its shard of the
    experts (``moe_local_params``); the branch is ``moe_branch`` of the
    global batch:

      * ``"expert"``: the rank routes its tokens, computes the
        assignments to its E / model experts (capacity from its own
        B T), the outputs are summed over ``model``, aux and drop
        averaged over the batch axes;
      * ``"decode"``: the tokens are all-gathered over ``data``, the rank
        computes all of them against its experts' F / data slice
        (capacity from the global B T), the partial outputs are summed
        over (``data``, ``model``) and the rank keeps its own rows; aux
        and drop averaged over (``data``, ``model``) and ``pod``.

    A backward gives each rank what ``jax.grad`` of the reference's
    ``moe_apply`` gives for its shard, of a loss on the global output
    and aux: x's rows, the router's whole gradient (summed over the
    mesh), the expert shard's (summed over the axes that replicate it)
    and the shared expert's (summed over the batch axes)."""
    b, t, d = x.shape
    mesh = get_mesh()
    n_exp, n_data = _shards(mesh)
    branch = moe_branch(mesh, b * n_data, t)
    t_shard = b * t
    if capacity is None:
        capacity = max(4, int(cfg.capacity_factor * cfg.top_k * t_shard
                              / max(cfg.n_experts, 1)))
    capacity = min(capacity, t_shard * cfg.top_k)
    x_flat = x.reshape(b * t, d)
    weights = (params["router"], params["w_gate"], params["w_up"],
               params["w_down"])
    if branch == "one":
        out, aux, drop = _moe_shard_body(x_flat, *weights, cfg=cfg,
                                         capacity=capacity)
    elif branch == "decode":
        _check_local(weights[1:], cfg, n_exp, axis_sizes(mesh)["data"])
        coord = rules.coordinate(mesh)
        gb = b * n_data
        cap_dec = max(4, int(cfg.capacity_factor * cfg.top_k * gb * t
                             / max(cfg.n_experts, 1)))
        cap_dec = min(cap_dec, gb * t * cfg.top_k)
        data_group = axis_group(mesh, ("data",))
        # o is partial over both the F-slice (data) and the experts (model)
        dm = axis_group(mesh, ("data", "model"))
        pod = axis_group(mesh, ("pod",))
        # the router is read by every rank, the experts' F-slices by
        # every pod; x's rows gathered over data and read by every model
        # rank
        weights = (coll.replicated_input(weights[0], _whole(mesh)),
                   *(coll.replicated_input(w, pod) for w in weights[1:]))
        x_all = coll.gather_rows(x_flat, data_group, dm, coord["data"])
        o, aux, drop = _moe_shard_body(
            x_all, *weights, cfg=cfg, capacity=cap_dec,
            n_exp_shards=n_exp, shard_idx=coord.get("model", 0))
        out = coll.sum_then_rows(o, dm, data_group, coord["data"], b * t)
        stats = coll.mean_replicated(
            coll.mean_replicated(torch.stack([aux, drop]), dm), pod)
        aux, drop = stats[0], stats[1]
    else:
        _check_local(weights[1:], cfg, n_exp, 1)
        model_group = axis_group(mesh, ("model",))
        weights = (coll.replicated_input(weights[0], _whole(mesh)),
                   *(coll.replicated_input(w, axis_group(mesh, ctx.BATCH))
                     for w in weights[1:]))
        out, aux, drop = _moe_shard_body(
            coll.replicated_input(x_flat, model_group), *weights, cfg=cfg,
            capacity=capacity, n_exp_shards=n_exp,
            shard_idx=rules.coordinate(mesh).get("model", 0),
            model_group=model_group)
        # aux and drop: averaged over the token shards for logging; aux
        # is the same on every model rank, one copy of n_exp
        stats = torch.stack([coll.split_copies(aux, n_exp), drop])
        for ax in ctx.BATCH:
            stats = coll.mean_replicated(stats, axis_group(mesh, (ax,)))
        aux, drop = stats[0], stats[1]
    out = out.reshape(b, t, d)
    if cfg.n_shared_experts:
        shared = params["shared"]
        if branch != "one":
            # every batch shard reads the shared expert
            shared = {k: coll.replicated_input(v, axis_group(mesh, ctx.BATCH))
                      for k, v in shared.items()}
        out = out + mlp_apply(shared, x, cfg,
                              d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return out, aux, drop


def _whole(mesh):
    """The group of every rank of the mesh."""
    return axis_group(mesh, tuple(axis_sizes(mesh)))


def _check_local(experts, cfg: ModelConfig, n_exp: int, n_f: int) -> None:
    """Raise unless the expert weights are the shard their branch takes:
    E / model experts, F / data columns on the decode branch."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    want = [(e // n_exp, d, f // n_f), (e // n_exp, d, f // n_f),
            (e // n_exp, f // n_f, d)]
    got = [tuple(w.shape) for w in experts]
    if e % n_exp or f % n_f or got != want:
        raise ValueError(
            f"moe_apply on this mesh takes its rank's shard of the experts "
            f"(moe_local_params): want w_gate, w_up, w_down {want}, got "
            f"{got}")


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
