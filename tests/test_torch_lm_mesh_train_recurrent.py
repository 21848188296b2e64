"""The port's recurrent LMs trained over a mesh against
``repro.models.lm`` under the same mesh, on the CPU.

The reference's ``train_4k`` layout (``_torch_mesh_train.py``): the
parameters, gradients and AdamW moments each leaf's block under
``rules.param_spec`` (mamba2's ``w_in`` and the RG-LRU's ``w_x``,
``w_gate``, ``w_a`` and ``w_i`` by columns over ``model`` and rows over
``data``, ``w_out`` the other way round; the conv weights, the float32
leaves and the biases whole), the batch's rows over ``data``. Configs,
``.reduced()`` in float32: ``mamba2-780m`` (the ``ssd`` kind: 16 SSD
heads of 32, state 32, T 64 over two scan chunks) and
``recurrentgemma-2b`` (one ``griffin`` super-block of two RG-LRU units
and a local attention unit of window 8 over T 16, 4 q heads and one KV
head, which stays whole on ``model``) with remat, the super-block one
checkpoint; and mamba2 at SSD head dim 256, whose 2 heads do not
divide over a 4-way ``model`` axis (every rank runs every head, while
``w_out``'s rows split and the gated output's cotangent is summed over
``model``). The reference's zero leaves (norm scales, conv and gate
biases) are set to seeded noise. Meshes: (2 ``data``, 2 ``model``) and
a 4-way ``model`` axis; one mamba2 case has a mask whose counts differ
between the data ranks. The bars are those of
``test_torch_lm_mesh_train.py``: loss, ce and aux equal on every rank
and within 1e-6 (relative) of the reference's, each gradient block
within 1e-5 of its leaf's largest |gradient| and bit-equal across the
ranks that hold it, and one ``train_step`` from an AdamW state of step
3 within 1e-5, its gnorm within 1e-6.
"""
import pytest
import torch

import _torch_mesh_train as mt
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

SUITE = mt.Suite(
    models={"mamba2-780m": ("mamba2-780m", {}),
            "recurrentgemma-2b": ("recurrentgemma-2b",
                                  {"remat": True, "window": 8}),
            "mamba2-p256": ("mamba2-780m", {"ssm_head_dim": 256})},
    # name -> (model, mesh, B, T, masked)
    cases={"mamba2/dm": ("mamba2-780m", "dm", 4, 64, False),
           "mamba2/m4": ("mamba2-780m", "m4", 4, 64, False),
           "mamba2/dm/mask": ("mamba2-780m", "dm", 4, 64, True),
           "griffin/dm": ("recurrentgemma-2b", "dm", 4, 16, False),
           "griffin/m4": ("recurrentgemma-2b", "m4", 4, 16, False),
           "mamba2-p256/m4": ("mamba2-p256", "m4", 4, 64, False)},
    noise_zeros=True)
CASES = list(SUITE.cases)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mt.run(SUITE, tmp_path_factory.mktemp("lm_mesh_train_recurrent"))


@pytest.mark.parametrize("name", CASES)
def test_loss_matches_the_reference_on_every_rank(runs, name):
    mt.check_loss(runs, name)


@pytest.mark.parametrize("name", CASES)
def test_gradient_blocks_match_the_reference(runs, name):
    mt.check_gradient_blocks(SUITE, runs, name)


@pytest.mark.parametrize("name", CASES)
def test_ranks_holding_one_block_have_bit_equal_gradients(runs, name):
    mt.check_bit_equal_blocks(SUITE, runs, name)


@pytest.mark.parametrize("name", CASES)
def test_one_train_step_matches_the_reference(runs, name):
    mt.check_train_step(SUITE, runs, name)
