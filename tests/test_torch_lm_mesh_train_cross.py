"""The port's right-sized and cross-attention LMs trained over a mesh
against ``repro.models.lm`` under the same mesh, on the CPU.

The reference's ``train_4k`` layout (``_torch_mesh_train.py``).
Configs, ``.reduced()`` in float32:

  * ``gemma3-1b@rightsized`` at 4 layers and window 8 with remat: one
    ``dense_sb`` super-block (two local units over the window, a global
    unit; one checkpoint), then a remainder ``dense`` layer with the
    window; 4 q heads and one KV head, whole on ``model``; T 16;
  * ``whisper-tiny``: the ``dec`` kind (2 units) over its encoder (2
    non-causal units over 32 frames, run once a step, ``vision_proj``'s
    counterpart the encoder's weights, FSDP over ``data``); 4 q heads, 2
    KV heads;
  * ``llama-3.2-vision-90b``: one ``vlm`` super-block of 2 self layers
    and a cross layer over 16 vision tokens of width 64 projected by
    ``vision_proj`` (FSDP over ``data``), its gates 0.7 and -0.5 (the
    reference starts them at 0, where the memory reaches no logit).

The reference's zero leaves are set to seeded noise. Meshes: (2
``data``, 2 ``model``), where the cross layers' 2 KV heads split (each
rank's q heads read the memory's K and V of its own KV head, no
gather), and a 4-way ``model`` axis, where they stay whole on every
rank; one whisper case has a mask whose counts differ between the data
ranks. The bars are those of ``test_torch_lm_mesh_train.py``.
"""
import pytest
import torch

import _torch_mesh_train as mt
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

SUITE = mt.Suite(
    models={"gemma3-1b@rightsized": ("gemma3-1b@rightsized",
                                     {"n_layers": 4, "window": 8,
                                      "remat": True}),
            "whisper-tiny": ("whisper-tiny", {}),
            "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {})},
    # name -> (model, mesh, B, T, masked)
    cases={"gemma3/dm": ("gemma3-1b@rightsized", "dm", 4, 16, False),
           "gemma3/m4": ("gemma3-1b@rightsized", "m4", 4, 16, False),
           "whisper/dm": ("whisper-tiny", "dm", 4, 16, False),
           "whisper/m4": ("whisper-tiny", "m4", 4, 16, False),
           "whisper/dm/mask": ("whisper-tiny", "dm", 4, 16, True),
           "vlm/dm": ("llama-3.2-vision-90b", "dm", 4, 16, False),
           "vlm/m4": ("llama-3.2-vision-90b", "m4", 4, 16, False)},
    reference_parts=3, noise_zeros=True)
CASES = list(SUITE.cases)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mt.run(SUITE, tmp_path_factory.mktemp("lm_mesh_train_cross"))


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
