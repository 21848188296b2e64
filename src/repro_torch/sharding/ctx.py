"""The active mesh, the counterpart of ``repro.sharding.ctx``.

Code that runs differently on a mesh reads the mesh set here, as the
reference reads its own: ``models.moe.moe_apply``, and the dense, moe,
ssd, rec and griffin kinds of ``models.lm.LM`` served over a mesh
(``models.common``'s embedding, MLP and unembedding,
``models.attention``'s prefill and decode, ``models.ssd``'s heads,
``models.rglru``'s width, ``serving.engine``), whose weights and decode
state are each
rank's shard under ``rules.serving_param_spec`` and
``rules.state_spec``; and ``LM.loss`` of the dense and moe kinds, whose
weights are each rank's shard under ``rules.param_spec``, with
``optim.adamw_update``. A mesh is a ``DeviceMesh``
(``repro_torch.launch.mesh.make_mesh``), or a ``MeshShape`` where only
its axis names and sizes are read.

The reference's ``shard`` and ``named_sharding`` are activation sharding
constraints for GSPMD. Eager PyTorch has none for plain tensors: each
rank holds its own shard, and the collectives GSPMD would insert are
explicit (``sharding.tensor_parallel``), so the port has no stand-in
for them.
"""
from __future__ import annotations

import contextlib

from repro_torch.launch.mesh import axis_sizes

_MESH = None

# Logical batch axis: sharded over every data-parallel mesh axis present.
BATCH = ("pod", "data")
MODEL = "model"
FSDP = "data"  # weight-shard axis for fully-sharded data parallelism


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """The mesh active inside the block (None: no mesh)."""
    prev = _MESH
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def _filter_axes(mesh, axes) -> tuple:
    """Per-dim axes with those absent from ``mesh`` dropped (a tuple
    entry keeps its present axes, None if none), trailing Nones
    dropped."""
    names = axis_sizes(mesh)
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        elif isinstance(a, (tuple, list)):
            sub = tuple(x for x in a if x in names)
            out.append(sub if sub else None)
        else:
            out.append(a if a in names else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def pspec(*axes) -> tuple:
    """Per-dim axes filtered to the active mesh (() if none)."""
    mesh = get_mesh()
    if mesh is None:
        return ()
    return _filter_axes(mesh, axes)


def axis_size(name: str) -> int:
    mesh = get_mesh()
    if mesh is None:
        return 1
    return axis_sizes(mesh).get(name, 1)
