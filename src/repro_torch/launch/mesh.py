"""Meshes and process groups, the counterpart of ``repro.launch.mesh``.

The reference lays a ``jax.sharding.Mesh`` over the devices one process
sees. The port's mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of an initialised process group, one rank a mesh
position: gloo on the CPU; on the card NCCL for one rank, and gloo over
CUDA tensors for several ranks on one card (NCCL refuses two ranks on
one device).

``process_group`` starts and ends a group from a ``FileStore`` with an
explicit timeout, so a hung collective fails instead of waiting forever;
``spawn`` runs one process a rank and joins them with a timeout.
``make_production_mesh`` is the TPU v5e layout as a ``MeshShape``: axis
names and sizes that the sharding rules read, with no group behind it
(no 256- or 512-rank group exists here).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import subprocess
import tempfile
import time
from typing import Callable

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without ranks behind them (what
    the sharding rules read from a ``DeviceMesh`` too)."""

    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> "dict[str, int]":
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> "dict[str, int]":
    """Axis name -> size of a ``DeviceMesh`` or a ``MeshShape``, in the
    mesh's axis order."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The production TPU v5e layouts: 16 x 16 a pod, 2 pods when
    ``multi_pod``."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named by ``axes`` over the ranks of
    the initialised default group (row-major: rank r at the position
    whose flat index is r)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(start one with process_group)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, pods: int = 0,
                    device_type: str = "cpu"):
    """A small ("data", "model") mesh, ("pod", "data", "model") with
    ``pods``, for sharding tests."""
    if pods:
        return make_mesh((pods, n_data, n_model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


# groups over several axes, per mesh, made once (new_group is collective)
_GROUPS: dict = {}


@contextlib.contextmanager
def process_group(rank: int, world_size: int, store_path, *,
                  backend: str = "gloo", timeout_s: float = 120.0):
    """Initialise the default group from a ``FileStore`` at
    ``store_path`` (a file no earlier group used), and destroy it on
    exit. Gloo binds to the loopback interface unless
    ``GLOO_SOCKET_IFNAME`` says otherwise."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        _GROUPS.clear()
        dist.destroy_process_group()


def _present(mesh, axes) -> tuple:
    names = mesh.mesh_dim_names
    return tuple(a for a in axes if a in names)


def axis_index(mesh, axes) -> int:
    """This rank's row-major index over the named axes (absent axes
    skipped; 0 for none)."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in _present(mesh, axes):
        idx = idx * sizes[a] + coord[a]
    return idx


def axis_group(mesh, axes, copy: int = 0):
    """The process group of this rank's slice along the named axes (the
    ranks that differ from it only there), or None when no named axis is
    in the mesh; ``copy`` k > 0 gives the k-th other group of the same
    ranks (a collective cut in stripes moves each over its own group).
    Every rank of the mesh must ask for the same axes and copies in the
    same order: the first call makes a group for every slice."""
    axes = _present(mesh, axes)
    if not axes:
        return None
    if len(axes) == 1 and copy == 0:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes, copy)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        ranks = mesh.mesh
        rest = [i for i, n in enumerate(names) if n not in axes]
        order = rest + [names.index(a) for a in axes]
        width = 1
        for a in axes:
            width *= ranks.shape[names.index(a)]
        slices = ranks.permute(order).reshape(-1, width).tolist()
        mine = None
        for members in slices:
            group = dist.new_group(members)
            if dist.get_rank() in members:
                mine = group
        _GROUPS[key] = (mesh, mine)  # the mesh kept alive: its id stays its
    return _GROUPS[key][1]


def spawn(argv_of: Callable[[int], list], world_size: int, *,
          timeout_s: float, env: "dict | None" = None) -> None:
    """Run ``argv_of(rank)`` for every rank as its own process and wait
    for all of them; raise, with the tail of what each rank printed, when
    one exits non-zero (the others are then killed: they would wait in a
    collective) or the ranks outlast ``timeout_s``."""
    logs = [tempfile.TemporaryFile("w+") for _ in range(world_size)]
    procs = [subprocess.Popen(argv_of(r), env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = []
        for r, f in enumerate(logs):
            f.seek(0)
            tails.append(f"-- rank {r} (exit {codes[r]}):\n{f.read()[-3000:]}")
        for f in logs:
            f.close()
        what = ("outlasted %.0f s" % timeout_s if time.monotonic() > deadline
                else "failed")
        raise RuntimeError(f"{world_size} ranks: {what}, exit codes {codes}\n"
                           + "\n".join(tails))
    for f in logs:
        f.close()
