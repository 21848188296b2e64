"""Hand state from the JAX package to the port as numpy arrays.

JAX's threefry draws cannot be reproduced with torch generators, so the
tests that hold the port against ``repro`` build a problem, a sketch, an
optimizer state or an LM's parameters once (in ``repro``), pass it over
as numpy, and run both packages on the same values.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.federated import (
    DatasetPopulation,
    FederatedProblem,
    SyntheticPopulation,
)
from repro_torch.core.losses import OBJECTIVES, Objective
from repro_torch.core.sketch import BatchedSrhtSketch, SrhtSketch
from repro_torch.device import resolve_device
from repro_torch.models.common import FLOAT32_LEAVES
from repro_torch.tree import tree_map


def problem_from_numpy(X, y, mask, lam: float, objective: "str | Objective",
                       device: "str | torch.device" = "cuda") -> FederatedProblem:
    """A ``FederatedProblem`` over stacked shards X (m, n, M), y (m, n),
    mask (m, n); ``objective`` by name or object."""
    dev = resolve_device(device)
    if isinstance(objective, str):
        objective = OBJECTIVES[objective]
    X, y, mask = (np.asarray(a) for a in (X, y, mask))
    if X.ndim != 3 or y.shape != X.shape[:2] or mask.shape != X.shape[:2]:
        raise ValueError(f"want X (m, n, M), y and mask (m, n); got "
                         f"{X.shape}, {y.shape}, {mask.shape}")
    return FederatedProblem(
        X=torch.tensor(X, device=dev), y=torch.tensor(y, device=dev),
        mask=torch.tensor(mask, device=dev), lam=float(lam),
        objective=objective)


def dataset_population_from_numpy(rows_X, rows_y, sizes, n_shard: int,
                                  lam: float, objective: "str | Objective",
                                  device: "str | torch.device" = "cuda"
                                  ) -> DatasetPopulation:
    """A ``DatasetPopulation`` over rows already partitioned (the
    reference's permuted rows and shard sizes): client j holds
    ``sizes[j]`` rows from ``sum(sizes[:j])``, padded to ``n_shard``."""
    dev = resolve_device(device)
    if isinstance(objective, str):
        objective = OBJECTIVES[objective]
    return DatasetPopulation.from_rows(
        torch.tensor(np.asarray(rows_X), device=dev),
        torch.tensor(np.asarray(rows_y), device=dev), sizes, n_shard,
        lam, objective)


def synthetic_population_from_numpy(shards, sizes, dim: int, n_shard: int,
                                    lam: float, objective: "str | Objective",
                                    device: "str | torch.device" = "cuda"
                                    ) -> SyntheticPopulation:
    """A ``SyntheticPopulation`` of ``len(sizes)`` clients whose cohorts
    are handed over: ``shards(ids)`` returns the cohort's X (c, n_shard,
    dim), y and mask (c, n_shard) as numpy (the reference population's
    ``materialize``)."""
    dev = resolve_device(device)
    if isinstance(objective, str):
        objective = OBJECTIVES[objective]
    pop = SyntheticPopulation(len(sizes), dim, lam=lam, objective=objective,
                              n_shard=n_shard, dirichlet_alpha=None,
                              device=dev)
    pop.sizes = np.asarray(sizes, dtype=np.int64)

    def draw(ids):
        return tuple(torch.tensor(np.asarray(a), device=dev)
                     for a in shards(ids))
    pop._draw_shards = draw
    return pop


def sketch_from_numpy(signs, rows, k: int, dim: int,
                      device: "str | torch.device" = "cuda") -> SrhtSketch:
    """An ``SrhtSketch`` from drawn signs (n,) and rows (k,), checked on
    the host: n a power of two >= dim, k distinct rows in [0, n)."""
    dev = resolve_device(device)
    signs = np.asarray(signs)
    rows = np.asarray(rows).astype(np.int64)
    n = signs.shape[0]
    if signs.ndim != 1 or n & (n - 1) or n < dim:
        raise ValueError(f"signs must be (n,), n a power of two >= dim={dim}; "
                         f"got {signs.shape}")
    if rows.shape != (k,) or len(np.unique(rows)) != k or (
            rows.min() < 0 or rows.max() >= n):
        raise ValueError(f"rows must be {k} distinct indices in [0, {n})")
    return SrhtSketch(k, dim, torch.tensor(signs, device=dev),
                      torch.tensor(rows, device=dev))


def sketches_from_numpy(signs, rows, k: int, dim: int,
                        device: "str | torch.device" = "cuda"
                        ) -> BatchedSrhtSketch:
    """A ``BatchedSrhtSketch`` of m operators from drawn signs (m, n) and
    rows (m, k) (FedNS's per-client draws), checked on the host: n a
    power of two >= dim, each operator's k rows distinct in [0, n)."""
    dev = resolve_device(device)
    signs = np.asarray(signs)
    rows = np.asarray(rows).astype(np.int64)
    if signs.ndim != 2 or rows.ndim != 2 or rows.shape != (signs.shape[0], k):
        raise ValueError(f"want signs (m, n) and rows (m, {k}); got "
                         f"{signs.shape} and {rows.shape}")
    n = signs.shape[1]
    if n & (n - 1) or n < dim:
        raise ValueError(f"n = {n} must be a power of two >= dim={dim}")
    srt = np.sort(rows, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any() or rows.min() < 0 or rows.max() >= n:
        raise ValueError(f"each operator's rows must be {k} distinct "
                         f"indices in [0, {n})")
    return BatchedSrhtSketch(k, dim, torch.tensor(signs, device=dev),
                             torch.tensor(rows, device=dev))


def state_from_numpy(state: dict, device: "str | torch.device" = "cuda") -> dict:
    """An optimizer state dict (any optimizer's: FedNL's ``B``, FedNew's
    ``d_bar`` and ``duals``, ...): arrays become tensors on ``device``,
    the round counter ``t`` a host integer."""
    dev = resolve_device(device)
    out = {}
    for name, v in state.items():
        out[name] = (int(np.asarray(v)) if name == "t"
                     else torch.tensor(np.asarray(v), device=dev))
    return out


def transport_state_from_numpy(state: dict, ef_memory: dict,
                               device: "str | torch.device" = "cuda"
                               ) -> "tuple[dict, dict]":
    """A mid-trajectory (optimizer state, EF memory) pair for a
    ``CommSession``: the state as ``state_from_numpy`` makes it, and each
    payload's stacked (m, ...) memory as a tensor on ``device``."""
    dev = resolve_device(device)
    memory = {name: torch.tensor(np.asarray(v), device=dev)
              for name, v in ef_memory.items()}
    return state_from_numpy(state, device=dev), memory


def lm_params_from_numpy(params, cfg, device: "str | torch.device" = "cuda") -> dict:
    """An LM parameter tree for ``repro_torch.models.lm.LM`` from
    ``repro``'s: the same nested dict of stacked (L, ...) arrays (numpy,
    or anything ``np.asarray`` reads, bfloat16 included), each leaf a
    tensor on ``device`` in ``cfg.param_dtype``, but the leaves the
    reference keeps in float32 (``common.FLOAT32_LEAVES``: mamba2's
    ``a_log``, ``d_skip``, ``dt_bias``, the RG-LRU's ``lam``), which stay
    float32. The port keeps the reference's layout (the vlm's two-level
    (n, per, ...) self stack and its (n,) gates, whisper's encoder stack
    included), so this is the one place a layout would change."""
    dev = resolve_device(device)

    def leaf(name, a):
        if isinstance(a, dict):
            return {sub_name: leaf(sub_name, sub) for sub_name, sub in a.items()}
        # through float32: numpy has no bfloat16 torch.tensor can read,
        # and float32 holds every bfloat16 and float32 value exactly
        arr = np.asarray(a).astype(np.float32)
        dtype = torch.float32 if name in FLOAT32_LEAVES else cfg.param_dtype
        return torch.tensor(arr, device=dev).to(dtype)
    return leaf(None, dict(params))


def lm_shard_from_numpy(params, cfg, mesh,
                        device: "str | torch.device" = "cuda",
                        rank: "int | None" = None) -> dict:
    """The rank's shard of ``repro``'s LM parameters for serving over
    ``mesh``: ``lm_params_from_numpy`` (on the host), then each leaf's
    block under ``rules.serving_param_spec`` (``rules.serving_shard``)
    on ``device``; ``rank`` defaults to this process's on a
    ``DeviceMesh``. Every leaf takes the same path: mamba2's ``w_in``
    and the RG-LRU's projections cut by columns over ``model`` and rows
    over ``data``, ``w_out`` the other way round; a ``dense_sb`` group's
    ``loc`` (n, per, ...) and ``glob`` (n, ...) stacks, whisper's
    ``encoder`` stack and the vlm's and dec's cross layers as any
    attention layer and MLP; ``vision_proj`` by its d_model over
    ``data``; the conv weights, the float32 leaves, the gates, the norms
    (``enc_final_norm`` too) whole."""
    from repro_torch.sharding import rules

    dev = resolve_device(device)
    shard = rules.serving_shard(mesh, lm_params_from_numpy(params, cfg,
                                                           device="cpu"), rank)
    return tree_map(lambda a: a.to(dev), shard)


def lm_train_shard_from_numpy(params, cfg, mesh,
                              device: "str | torch.device" = "cuda",
                              rank: "int | None" = None) -> dict:
    """The rank's shard of ``repro``'s LM parameters for training over
    ``mesh``: ``lm_params_from_numpy`` (on the host), then each leaf's
    block under ``rules.param_spec`` (``rules.training_shard``: the FSDP
    dims over ``data``, the heads, MLP width, experts and vocab over
    ``model``) on ``device``; ``rank`` defaults to this process's on a
    ``DeviceMesh``."""
    from repro_torch.sharding import rules

    dev = resolve_device(device)
    shard = rules.training_shard(mesh, lm_params_from_numpy(params, cfg,
                                                            device="cpu"), rank)
    return tree_map(lambda a: a.to(dev), shard)


def _tensor_keep_dtype(a, dev: torch.device) -> torch.Tensor:
    """A tensor on ``dev`` with the array's dtype, bfloat16 included."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=dev).to(
            torch.bfloat16)
    return torch.tensor(arr, device=dev)


def adamw_state_from_numpy(state, device: "str | torch.device" = "cuda") -> dict:
    """An AdamW state for ``repro_torch.optim.adamw_update`` from
    ``repro.optim.adamw_init``/``adamw_update``'s: the moments ``m`` and
    ``v`` as trees of tensors in their own dtype (float32 or bfloat16),
    ``step`` a 0-dim int32 tensor, all on ``device``."""
    dev = resolve_device(device)

    def tree(a):
        if isinstance(a, dict):
            return {name: tree(sub) for name, sub in a.items()}
        return _tensor_keep_dtype(a, dev)
    return {"m": tree(dict(state["m"])), "v": tree(dict(state["v"])),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def adamw_shard_from_numpy(state, mesh, device: "str | torch.device" = "cuda",
                           rank: "int | None" = None) -> dict:
    """The rank's shard of ``repro``'s AdamW state for training over
    ``mesh``: ``adamw_state_from_numpy``'s moments cut as the parameters
    are (``rules.training_shard``: the reference's ``train_4k`` layout
    keeps ``m`` and ``v`` in the parameters' sharding), ``step`` whole."""
    from repro_torch.sharding import rules

    dev = resolve_device(device)
    whole = adamw_state_from_numpy(state, device="cpu")
    return {name: tree_map(lambda a: a.to(dev),
                           rules.training_shard(mesh, whole[name], rank))
            for name in ("m", "v")} | {"step": whole["step"].to(dev)}
