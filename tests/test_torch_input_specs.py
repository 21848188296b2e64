"""The port's parameter and FLOP bookkeeping (``repro_torch.launch.
input_specs``) against ``repro.launch.input_specs.build``'s, on every
config and input shape, at full size and at ``reduced()``.

The reference's counts come from ``build`` on a 1 x 1 mesh (axes Auto):
``jax.eval_shape`` of its model's init, no arrays; ``reduced()`` through
its ``get_config`` patched to return the reduced config. The port's
trees live on the meta device, so kimi-k2's 1.03e12 parameters cost no
memory.
"""
import functools

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import input_specs as jspecs
from repro_torch.configs import INPUT_SHAPES, _ALIASES, get_config
from repro_torch.launch import input_specs

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

ARCHS = sorted(_ALIASES) + ["gemma3-4b@rightsized"]


@functools.cache
def _mesh():
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=auto)


@functools.cache
def _tree(arch, reduced):
    cfg = get_config(arch)
    return input_specs.param_shapes(cfg.reduced() if reduced else cfg)


def _reference(arch, shape, reduced):
    if not reduced:
        return jspecs.build(arch, shape, _mesh())
    inner = jspecs.get_config
    jspecs.get_config = lambda a: inner(a).reduced()
    try:
        return jspecs.build(arch, shape, _mesh())
    finally:
        jspecs.get_config = inner


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_flops_are_the_reference_ones(arch, reduced):
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    tree = _tree(arch, reduced)
    assert {leaf.device.type for leaf in input_specs._leaves(tree)} == {"meta"}
    n = input_specs.count_params(tree)
    n_active = input_specs.active_params(cfg, tree)
    for shape in INPUT_SHAPES:
        want = _reference(arch, shape, reduced)
        assert (n, n_active) == (want.n_params, want.n_active_params), shape
        assert input_specs.model_flops(n_active, shape) == want.model_flops


def test_kimi_at_full_size_costs_no_memory():
    """kimi-k2's 1.03e12 parameters as meta tensors: the counts the
    reference records, and 6 N D of a train_4k step on the active N."""
    cfg = get_config("kimi-k2-1t-a32b")
    tree = _tree("kimi-k2-1t-a32b", False)
    n_active = input_specs.active_params(cfg, tree)
    assert input_specs.count_params(tree) == 1027247535104
    assert n_active == 33700803584
    assert input_specs.model_flops(n_active, "train_4k") == \
        6.0 * n_active * 256 * 4096
    assert input_specs.model_flops(n_active, "decode_32k") == \
        2.0 * n_active * 128


def test_the_reference_configs_are_the_ports():
    """The counts rest on the two registries' configs agreeing."""
    for arch in ARCHS:
        a, b = get_config(arch), jget_config(arch)
        assert (a.n_layers, a.d_model, a.vocab, a.n_experts) == \
            (b.n_layers, b.d_model, b.vocab, b.n_experts)
