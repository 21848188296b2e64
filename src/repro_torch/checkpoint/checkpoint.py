"""Atomic, step-managed checkpoints of trees of tensors
(``repro.checkpoint``), in the reference's layout with JSON metadata.

One directory per step (``step_000000042/``) holds
  * ``tree.json``  — the tree's structure, each leaf's dtype and shape,
    and the step;
  * ``arrays.npz`` — the leaves, copied to the host, as ``a0``, ``a1``,
    ... in ``jax.tree`` order (sorted dict keys), bfloat16 stored as its
    uint16 bits.
The reference keeps the metadata in ``tree.msgpack``; the port writes
JSON because the machines it runs on do not all have ``msgpack``. Writes
go to a temporary directory renamed into place, so a killed run never
leaves a half-written step. ``restore`` rebuilds the tree of ``like``
with each leaf's saved dtype, on that leaf's device, and raises when
the leaf count or a shape differs.
"""
from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np
import torch

from repro_torch.tree import leaves, structure, unflatten


def _host(leaf: torch.Tensor) -> "tuple[np.ndarray, str]":
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def save(ckpt_dir, step: int, tree) -> pathlib.Path:
    """Write ``tree`` as step ``step`` under ``ckpt_dir`` (replacing that
    step if it exists); returns the step's directory."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays, meta = {}, []
    for i, leaf in enumerate(leaves(tree)):
        arr, dtype_name = _host(torch.as_tensor(leaf))
        arrays[f"a{i}"] = arr
        meta.append({"dtype": dtype_name, "shape": list(arr.shape)})
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "tree.json").write_text(json.dumps(
        {"treedef": structure(tree), "meta": meta, "step": step}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(ckpt_dir) -> "int | None":
    """The largest step saved under ``ckpt_dir``, or None."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1])
                   for p in ckpt_dir.glob("step_*") if p.is_dir())
    return steps[-1] if steps else None


def restore(ckpt_dir, step: int, like):
    """Step ``step`` into the structure of ``like`` (leaf count and shapes
    checked), each leaf with its saved dtype on ``like``'s leaf's device."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    blob = json.loads((path / "tree.json").read_text())
    data = np.load(path / "arrays.npz")
    want = leaves(like)
    if len(want) != len(blob["meta"]):
        raise ValueError(f"checkpoint has {len(blob['meta'])} leaves, "
                         f"expected {len(want)}")
    out = []
    for i, (leaf, m) in enumerate(zip(want, blob["meta"])):
        arr = data[f"a{i}"]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(np.shape(leaf))}")
        if m["dtype"] == "bfloat16":
            t = torch.from_numpy(np.array(arr.view(np.int16))).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        out.append(t.to(dev))
    return unflatten(like, out)
