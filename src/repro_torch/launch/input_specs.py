"""Parameter and FLOP bookkeeping of the model zoo, the counterpart of
the bookkeeping half of ``repro.launch.input_specs``.

``param_shapes`` builds a config's parameter tree on the meta device
(``LM.init`` under a function mode that drops the generator and moves
every factory to ``meta``), so a full-size config costs no memory.
``count_params`` and ``active_params`` are the reference's
``_count_params`` and ``_active_params`` (a MoE counts top_k of its
n_experts expert weights a token), and ``model_flops`` is its estimate
of a step at an input shape: 6 N D for a training step (N the active
parameters, D the batch's tokens), 2 N D for a prefill, 2 N B for a
decode step. The reference's ``LoweringSpec``/``build`` half lowers XLA
HLO onto TPU meshes and has no counterpart here.
"""
from __future__ import annotations

import math

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs import INPUT_SHAPES
from repro_torch.models.common import ModelConfig


class _MetaInit(TorchFunctionMode):
    """Every tensor made inside the block lands on the meta device, and
    draws take no generator: shapes and dtypes only."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)


def _leaves(tree):
    if isinstance(tree, dict):
        for sub in tree.values():
            yield from _leaves(sub)
    else:
        yield tree


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree of ``LM(cfg).init`` on the meta device."""
    from repro_torch.models.lm import LM

    with _MetaInit():
        return LM(cfg).init(torch.Generator())


def count_params(tree) -> int:
    """Elements over every leaf of a parameter tree."""
    return int(sum(math.prod(leaf.shape) for leaf in _leaves(tree)))


def active_params(cfg: ModelConfig, tree) -> int:
    """Parameters a token touches: every one, but top_k of a MoE's
    n_experts expert weights (w_gate, w_up, w_down of each group's
    ``moe``)."""
    total = count_params(tree)
    if not cfg.n_experts:
        return total
    expert_total = 0
    for key, sub in tree.items():
        if key.startswith("group") and isinstance(sub, dict) and "moe" in sub:
            expert_total += sum(math.prod(sub["moe"][nm].shape)
                                for nm in ("w_gate", "w_up", "w_down"))
    active_frac = cfg.top_k / cfg.n_experts
    return int(total - expert_total + expert_total * active_frac)


def model_flops(n_active: int, shape_name: str) -> float:
    """The model FLOPs of one step at ``INPUT_SHAPES[shape_name]``:
    6 N b t (train), 2 N b t (prefill), 2 N b (decode)."""
    shp = INPUT_SHAPES[shape_name]
    b, t = shp.global_batch, shp.seq_len
    if shp.kind == "train":
        return 6.0 * n_active * b * t
    if shp.kind == "prefill":
        return 2.0 * n_active * b * t
    return 2.0 * n_active * b * 1
