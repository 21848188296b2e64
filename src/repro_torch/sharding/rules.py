"""Logical sharding rules: parameter, decode-state, batch and cohort trees
to per-dim mesh axes, the counterpart of ``repro.sharding.rules``.

Strategy (the reference's):
  * batch dims            -> ("pod", "data")
  * vocab / heads / d_ff / experts (parallelizable width) -> "model"
  * weight d_model dims   -> "data"   (FSDP)
  * KV-cache sequence     -> "model"  (sequence-parallel decode attention);
                             batch=1 long-context shards seq over
                             ("data", "model") as well
  * every assignment is divisibility-guarded: a dim that does not divide
    by the mesh axis product falls back to replication.

A spec is a tuple with one entry a tensor dim (trailing replicated dims
dropped, as the reference's ``PartitionSpec``): None, an axis name, or a
tuple of axis names. Each rule reads only the mesh's axis names and
sizes (``launch.mesh.axis_sizes``), so it takes a ``DeviceMesh`` or a
``MeshShape``: a 512-chip layout is checked without 512 processes. A
path is the tuple of keys from the tree's root to the leaf (a list's
index as its string, as the reference's ``SequenceKey``). ``placements``
turns a spec into DTensor placements, ``local_shard`` and ``shard_tree``
cut a rank's shard out of a global tensor or tree. ``cohort_block`` and
``shard_cohort`` give a rank its block of a federated cohort.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.mesh import axis_group, axis_sizes
from repro_torch.sharding import collectives


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _guard(mesh, shape, spec_axes) -> tuple:
    """Drop axis assignments that don't divide or aren't in the mesh."""
    names = axis_sizes(mesh)
    out = []
    for dim, axes in zip(shape, spec_axes):
        if axes is None:
            out.append(None)
            continue
        cand = (axes,) if isinstance(axes, str) else tuple(axes)
        cand = tuple(a for a in cand if a in names)
        # progressively drop trailing axes until divisible
        while cand and dim % _axsize(mesh, cand) != 0:
            cand = cand[:-1]
        if not cand:
            out.append(None)
        elif len(cand) == 1:
            out.append(cand[0])
        else:
            out.append(cand)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _path_names(path) -> "list[str]":
    return [str(k) for k in path]


# -- parameter rules ----------------------------------------------------------

def param_spec(mesh, path, leaf) -> tuple:
    names = _path_names(path)
    name = names[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    fsdp, mdl = "data", "model"

    if nd <= 1:
        return ()
    if name == "table":  # (V, D)
        return _guard(mesh, shape, (mdl, fsdp))
    if name == "lm_head":  # (D, V)
        return _guard(mesh, shape, (fsdp, mdl))
    if name in ("wq", "wk", "wv"):  # (L?, D, H, Dh)
        return _guard(mesh, shape, (None,) * (nd - 3) + (fsdp, mdl, None))
    if name == "wo":  # (L?, H, Dh, D)
        return _guard(mesh, shape, (None,) * (nd - 3) + (mdl, None, fsdp))
    expert = nd >= 3 and len(names) >= 2 and names[-2] == "moe"
    if name in ("w_gate", "w_up"):
        # expert tensors are direct children of "moe": (L?, E, D, F);
        # plain mlp (incl. the moe *shared* expert) is (L?, D, F)
        if expert:
            return _guard(mesh, shape, (None,) * (nd - 3) + (mdl, fsdp, None))
        return _guard(mesh, shape, (None,) * (nd - 2) + (fsdp, mdl))
    if name == "w_down":
        if expert:
            return _guard(mesh, shape, (None,) * (nd - 3) + (mdl, None, fsdp))
        return _guard(mesh, shape, (None,) * (nd - 2) + (mdl, fsdp))
    if name == "router":
        return ()
    if name in ("w_in", "w_x", "w_gate2", "w_a", "w_i"):
        # ssd (L?, D, X); rglru (L?, D, D)
        return _guard(mesh, shape, (None,) * (nd - 2) + (fsdp, mdl))
    if name == "w_out":  # (L?, Din, D)
        return _guard(mesh, shape, (None,) * (nd - 2) + (mdl, fsdp))
    if name == "conv_w":
        return ()
    if name == "vision_proj":  # (Dv, D)
        return _guard(mesh, shape, (None, fsdp))
    # default: replicate trailing structure, fsdp on the largest dim if big
    if nd >= 2 and math.prod(shape) > 1_000_000:
        base = [None] * nd
        base[-2] = fsdp
        base[-1] = mdl
        return _guard(mesh, shape, tuple(base))
    return ()


def serving_param_spec(mesh, path, leaf) -> tuple:
    """The serving layout of ``repro.launch.input_specs``
    (``_serving_param_shardings``): the experts' weights F-sharded over
    ``data`` (E, D, F) -> (model, None, data), (E, F, D) -> (model, data,
    None), which the decode branch of ``moe_apply`` takes; the vocab
    table and head keep their d_model dim whole when the vocab dim is
    model-sharded; every other leaf as ``param_spec``."""
    names = _path_names(path)
    shape = tuple(leaf.shape)
    if (len(names) >= 2 and names[-2] == "moe"
            and names[-1] in ("w_gate", "w_up", "w_down")):
        lead = (None,) * (len(shape) - 3)
        if names[-1] == "w_down":
            return _guard(mesh, shape, lead + ("model", "data", None))
        return _guard(mesh, shape, lead + ("model", None, "data"))
    spec = list(param_spec(mesh, path, leaf))
    vocab_sharded = any(ax == "model" or (isinstance(ax, tuple)
                                          and "model" in ax) for ax in spec)
    if names and names[-1] in ("table", "lm_head") and vocab_sharded:
        spec = [None if ax == "data" or (isinstance(ax, tuple)
                                         and "data" in ax) else ax
                for ax in spec]
    return tuple(spec)


# -- decode-state rules ---------------------------------------------------------

def state_spec(mesh, path, leaf, *, batch: int) -> tuple:
    names = _path_names(path)
    name = names[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    batch_axes = "data" if batch > 1 else None
    seq_axes = ("model",) if batch > 1 else ("data", "model")

    if name in ("k", "v"):  # (G, [per,] B, S, Hkv, Dh)
        lead = nd - 4  # layer (and vlm per-layer) dims stay replicated
        return _guard(mesh, shape,
                      (None,) * lead + (batch_axes, seq_axes, None, None))
    if name in ("cross_k", "cross_v"):  # (G, B, Sv, Hkv, Dh)
        return _guard(mesh, shape, (None, batch_axes, None, None, None))
    if name == "pos":  # (G, [per,] B, S) — follows the cache sharding
        return _guard(mesh, shape,
                      (None,) * (nd - 2) + (batch_axes, seq_axes))
    if name == "ssm":  # (G, B, H, N, P)
        return _guard(mesh, shape, (None, batch_axes, "model", None, None))
    if name in ("conv", "conv0", "conv1"):  # (G, B, K-1, C)
        return _guard(mesh, shape, (None, batch_axes, None, None))
    if name in ("h", "h0", "h1"):  # (G, B, D)
        return _guard(mesh, shape, (None, batch_axes, None))
    return ()


# -- batch rules -----------------------------------------------------------------

def batch_spec(mesh, path, leaf) -> tuple:
    shape = tuple(leaf.shape)
    return _guard(mesh, shape, (("pod", "data"),) + (None,) * (len(shape) - 1))


# -- federated cohort rules ---------------------------------------------------

def cohort_spec(mesh, leaf) -> tuple:
    """One cohort-stacked array: the leading (client) axis over the first
    client-capable mesh axis, the rest replicated; divisibility-guarded
    (a cohort that does not divide the mesh is replicated)."""
    names = axis_sizes(mesh)
    axes = tuple(a for a in ("clients", "data") if a in names)[:1]
    if not axes or leaf.ndim == 0:
        return ()
    return _guard(mesh, tuple(leaf.shape),
                  (axes[0],) + (None,) * (leaf.ndim - 1))


@dataclasses.dataclass(frozen=True)
class CohortBlock:
    """A rank's block of a cohort of ``width`` clients: rows [offset,
    offset + rows) of the client axis. ``group`` is the process group
    whose ranks hold the other blocks, in rank order (None where the
    cohort is replicated, or for a mesh without ranks behind it)."""

    offset: int
    rows: int
    width: int
    group: object = dataclasses.field(default=None, compare=False)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This block's rows of a whole-cohort tensor (``x`` itself when
        the block is the whole cohort)."""
        if self.rows == self.width:
            return x
        return x[self.offset:self.offset + self.rows]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole cohort's rows from every rank's block (``x`` itself
        when the cohort is replicated)."""
        if self.group is None:
            return x
        return collectives.all_gather_rows(x, self.group)


def cohort_block(mesh, width: int, rank: "int | None" = None) -> CohortBlock:
    """The block of a ``width``-client cohort that ``rank`` (this
    process's on a ``DeviceMesh``) holds under ``cohort_spec``: an equal
    contiguous block of the client axis by the rank's coordinate on the
    client mesh axis, or the whole cohort where the guard replicates."""
    spec = cohort_spec(mesh, torch.empty((width,), device="meta"))
    if not spec:
        return CohortBlock(0, width, width)
    axis = spec[0]
    n = axis_sizes(mesh)[axis]
    rows = width // n
    group = axis_group(mesh, (axis,)) if rank is None else None
    return CohortBlock(coordinate(mesh, rank)[axis] * rows, rows, width,
                       group)


def shard_cohort(mesh, cohort, rank: "int | None" = None):
    """This rank's block of a cohort ``FederatedProblem``: (the block's
    problem, its offset, the cohort's width). The block keeps the whole
    cohort's client weights for the server step; a cohort that does not
    divide the client axis stays whole, as the reference falls back to
    replication."""
    block = cohort_block(mesh, cohort.m, rank)
    return cohort.block_of(block), block.offset, block.width


# -- trees, placements, shards --------------------------------------------------

def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_specs(mesh, tree, rule, **kw):
    """``rule`` mapped over a tree of dicts and lists: a tree of specs of
    the same structure."""
    return _map_with_path(lambda path, leaf: rule(mesh, path, leaf, **kw),
                          tree)


def placements(mesh, spec) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh axis:
    ``Shard(d)`` where tensor dim d names the axis, else
    ``Replicate()``. A dim sharded over several axes takes them in the
    mesh's order, as the reference's row-major device order does."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in axis_sizes(mesh):
        dims = [d for d, ax in enumerate(spec)
                if ax == axis or (isinstance(ax, tuple) and axis in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def coordinate(mesh, rank: "int | None" = None) -> "dict[str, int]":
    """Axis name -> position of ``rank`` (row-major over the mesh), or
    of this process's rank on a ``DeviceMesh`` when ``rank`` is None."""
    sizes = axis_sizes(mesh)
    if rank is None:
        return dict(zip(sizes, mesh.get_coordinate()))
    out = {}
    for name in reversed(list(sizes)):
        rank, out[name] = divmod(rank, sizes[name])
    return {name: out[name] for name in sizes}


def local_shard(mesh, tensor: torch.Tensor, spec,
                rank: "int | None" = None) -> torch.Tensor:
    """The block of a global ``tensor`` that ``rank`` holds under
    ``spec`` (a view): each sharded dim cut in equal blocks, block index
    row-major over the dim's axes in their listed order."""
    coord = coordinate(mesh, rank)
    sizes = axis_sizes(mesh)
    out = tensor
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(tensor.shape)} does not "
                             f"divide over {axes} ({n})")
        block = out.shape[d] // n
        out = out.narrow(d, idx * block, block)
    return out


def shard_tree(mesh, tree, rule, *, rank: "int | None" = None,
               prefix: tuple = (), **kw):
    """The rank's shard of every leaf of a global tree, each leaf's spec
    from ``rule(mesh, prefix + path, leaf, **kw)``."""
    return _map_with_path(
        lambda path, leaf: local_shard(mesh, leaf,
                                       rule(mesh, prefix + path, leaf, **kw),
                                       rank), tree)


def serving_shard(mesh, params: dict, rank: "int | None" = None) -> dict:
    """The rank's serving shard of a global LM parameter tree: each leaf's
    block under ``serving_param_spec``, copied, so that the global tree
    can be freed (``shard_tree``'s blocks are views of it)."""
    return _copied_shard(mesh, params, serving_param_spec, rank)


def training_shard(mesh, tree: dict, rank: "int | None" = None) -> dict:
    """The rank's training shard of a global LM parameter tree, or of a
    tree in its layout (a gradient, an AdamW moment: the reference keeps
    them in the parameters' sharding): each leaf's block under
    ``param_spec``, copied."""
    return _copied_shard(mesh, tree, param_spec, rank)


def _copied_shard(mesh, tree: dict, rule, rank) -> dict:
    return _map_with_path(
        lambda path, leaf: local_shard(mesh, leaf, rule(mesh, path, leaf),
                                       rank).clone(), tree)
