"""The port's checkpoints (``repro_torch.checkpoint``): the reference's
checkpoint cases (``tests/test_substrate.py``) on the port's format, and
that format against the reference's own layout: the same step
directories, and ``arrays.npz`` numbered in ``jax.tree`` order with
bfloat16 as uint16 bits, so the reference's arrays read back through the
port's leaf order. Metadata is JSON (``tree.json``), not msgpack."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save as jsave
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.tree import leaves

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16),
                       "c": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    like = {"a": torch.zeros(3, 4), "nested": {"b": torch.zeros(2, 2),
                                               "c": torch.zeros(())}}
    got = restore(tmp_path, 7, like)
    for a, b in zip(leaves(tree), leaves(got)):
        assert a.dtype == b.dtype  # the saved dtype, bfloat16 included
        assert torch.equal(a, b)


def test_checkpoint_latest_and_overwrite(tmp_path):
    tree = {"w": torch.zeros(4)}
    assert latest_step(tmp_path / "none") is None
    save(tmp_path, 1, tree)
    save(tmp_path, 5, tree)
    assert latest_step(tmp_path) == 5
    save(tmp_path, 5, {"w": torch.ones(4)})  # overwrite is atomic
    got = restore(tmp_path, 5, tree)
    assert torch.equal(got["w"], torch.ones(4))
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save(tmp_path, 0, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        restore(tmp_path, 0, {"w": torch.zeros(5)})
    with pytest.raises(ValueError, match="leaves"):
        restore(tmp_path, 0, {"w": torch.zeros(4), "x": torch.zeros(1)})


def test_layout_matches_the_reference(tmp_path):
    """The same directory, array names, leaf order and bfloat16 bits as
    ``repro.checkpoint.save`` writes; the reference's arrays restore
    through the port when its metadata is given as JSON."""
    tree = _tree()
    jtree = {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
             "nested": {"b": jnp.ones((2, 2), jnp.bfloat16),
                        "c": jnp.asarray(3, jnp.int32)}}
    mine = save(tmp_path / "port", 3, tree)
    ref = jsave(tmp_path / "ref", 3, jtree)
    assert mine.name == ref.name == "step_000000003"
    a, b = np.load(mine / "arrays.npz"), np.load(ref / "arrays.npz")
    assert sorted(a.files) == sorted(b.files) == ["a0", "a1", "a2"]
    for name in a.files:
        assert a[name].dtype == b[name].dtype
        np.testing.assert_array_equal(a[name], b[name])
    meta = json.loads((mine / "tree.json").read_text())
    assert meta["step"] == 3
    assert [m["dtype"] for m in meta["meta"]] == ["float32", "bfloat16",
                                                  "int32"]
    assert meta["treedef"] == {"a": 0, "nested": {"b": 1, "c": 2}}
    # the reference's arrays under the port's metadata
    (ref / "tree.json").write_text(json.dumps(meta))
    got = restore(tmp_path / "ref", 3, tree)
    for x, y in zip(leaves(tree), leaves(got)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert len(jax.tree.leaves(jtree)) == len(leaves(tree))
