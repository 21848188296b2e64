"""Collectives with their transposes, and a rank's place in an LM run
over a mesh.

Under ``sharding.ctx.use_mesh`` the port's LMs hold the reference's
layouts: for serving, weights as ``rules.serving_param_spec`` cuts them
and the decode state as ``rules.state_spec`` does; for training, weights,
gradients and AdamW's moments as ``rules.param_spec`` cuts them. Where
the reference's GSPMD partitioner inserts collectives of its own, the
port calls these explicitly:

  * ``gather`` over ``data`` of a weight's FSDP-sharded dim, on use
    (``unshard_all``: a unit's weights in one collective), and over
    ``model`` of vocab-sharded logits, of the heads of q, K and V (a
    cross layer's K and V of the memory too), of
    the last dim of a recurrent block's column-parallel activation
    (mamba2's ``w_in`` product, the RG-LRU's ``w_x`` product) and of
    the RG-LRU's state;
  * ``sum_over`` ``model`` of row-parallel partial outputs (``wo``,
    ``w_down``, ``w_out``) and of a vocab-parallel embedding's rows, of
    a vocab-parallel CE's sums, and ``sum_of_squares`` over ``model`` of
    mamba2's gated RMSNorm;
  * ``max_over`` and ``sum_over`` the cache's sequence shards (a
    right-sized ring's apart from a full cache's) of a softmax's max
    and sum, then of the probability-weighted V;
  * ``replicated_input`` where a value every rank of a group holds
    enters a computation split over it (the normed activations before
    the ``model``-split projections, MLP and logits; a leaf whose
    gradient each rank of a group holds a part of).

Each carries its transpose, under one convention (Megatron's, and that
of ``sharding.collectives``): every rank seeds the same replicated loss,
and a value replicated over a group carries the whole cotangent on every
rank of it. So ``sum_over`` passes its cotangent through,
``replicated_input`` sums it over the group (the identity forward: its
f to ``sum_over``'s g), ``max_over`` carries no gradient (it shifts a
log-sum-exp, whose gradient does not depend on the shift), and a gather
either keeps the rank's block of its cotangent (``"slice"``: the
gathered value is read alike on every rank, as logits or the MoE's
experts, which ``moe_apply`` sums itself) or reduce-scatters it
(``"sum"``: an FSDP weight, each rank's gradient from its own rows).
Every rank runs the same collectives in the same order, forward and
backward. A remat unit's gathers run again in its recomputation and
count as forward gathers.

A group is a tuple of ``STRIPES`` process groups of the same ranks: a
payload of ``STRIPE_MIN_BYTES`` or more is cut in as many stripes, all
in flight at once (gloo moves one collective at a time over a group's
TCP pairs, which holds a gather of a layer's weights to a fraction of
the host's copy rate). A group of one rank is None, and each collective
is then the identity, both ways, so a 1 x 1 mesh runs the no-mesh
arithmetic bit for bit. Sums of bfloat16 or float16 values (partials,
cotangents) run in float32 and are rounded back once. ``moved_bytes``
counts what each collective kind received on this rank, and
``collective_seconds`` the host time each kind spent (the calls block
until their result is here): ``gather``, ``sum`` and ``max`` forward,
``reduce_scatter`` (a ``"sum"`` gather's transpose) and ``sum_bwd`` (a
``replicated_input``'s) backward.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_group, axis_sizes
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import get_mesh

STRIPES = 4
STRIPE_MIN_BYTES = 1 << 20
KINDS = ("gather", "sum", "max", "reduce_scatter", "sum_bwd")

# bytes each collective kind brought to this rank, and the host seconds
# it took, since the last reset
_MOVED: "dict[str, int]" = dict.fromkeys(KINDS, 0)
_SECONDS: "dict[str, float]" = dict.fromkeys(KINDS, 0.0)


def reset_moved_bytes() -> None:
    """Zero ``moved_bytes`` and ``collective_seconds``."""
    for kind in KINDS:
        _MOVED[kind] = 0
        _SECONDS[kind] = 0.0


def collective_seconds() -> "dict[str, float]":
    """Host seconds this rank spent in each collective kind."""
    return dict(_SECONDS)


def moved_bytes() -> "dict[str, int]":
    """Bytes received by this rank's collectives, by kind: a gather's
    other ranks' parts, an all-reduce's (n - 1) / n of its buffer twice
    (a ring's reduce-scatter and all-gather), a reduce-scatter's
    (n - 1) / n of its buffer."""
    return dict(_MOVED)


def _stripes(flat: torch.Tensor, groups) -> list:
    """(lo, hi, group) of each stripe of a flat payload: one stripe under
    ``STRIPE_MIN_BYTES``, else one a group of ``groups``."""
    k = (len(groups) if flat.numel() * flat.element_size() >= STRIPE_MIN_BYTES
         else 1)
    bounds = [flat.numel() * i // k for i in range(k + 1)]
    return [(bounds[i], bounds[i + 1], groups[i]) for i in range(k)]


def _wait(works, kind: str, t0: float) -> None:
    for work in works:
        work.wait()
    _SECONDS[kind] += time.perf_counter() - t0


def _low(dtype) -> bool:
    return dtype in (torch.bfloat16, torch.float16)


def _size(group) -> int:
    return dist.get_world_size(group[0])


def _all_reduce(x: torch.Tensor, group, op, kind: str) -> torch.Tensor:
    """A new tensor: ``x`` reduced by ``op`` over ``group`` (float32 for
    bfloat16 or float16, rounded back once)."""
    low = _low(x.dtype)
    out = (x.float() if low else x.clone()).contiguous()
    flat = out.view(-1)
    t0 = time.perf_counter()
    _wait([dist.all_reduce(flat[lo:hi], op=op, group=g, async_op=True)
           for lo, hi, g in _stripes(flat, group)], kind, t0)
    n = _size(group)
    _MOVED[kind] += 2 * (n - 1) * out.numel() * out.element_size() // n
    return out.to(x.dtype) if low else out


def _all_reduce_many(xs, group, kind: str) -> list:
    """The sum over ``group`` of each of ``xs`` (one dtype), as one
    all-reduce of their concatenated values."""
    flat = _all_reduce(torch.cat([x.reshape(-1) for x in xs]), group,
                       dist.ReduceOp.SUM, kind)
    out, lo = [], 0
    for x in xs:
        out.append(flat[lo:lo + x.numel()].view(x.shape))
        lo += x.numel()
    return out


def _gather_raw(xs, group, dims) -> list:
    n = _size(group)
    flat = torch.cat([x.reshape(-1) for x in xs])
    parts = flat.new_empty((n, flat.numel()))
    t0 = time.perf_counter()
    _wait([dist.all_gather([parts[r, lo:hi] for r in range(n)], flat[lo:hi],
                           group=g, async_op=True)
           for lo, hi, g in _stripes(flat, group)], "gather", t0)
    _MOVED["gather"] += (n - 1) * flat.numel() * flat.element_size()
    out, lo = [], 0
    for x, dim in zip(xs, dims):
        hi = lo + x.numel()
        out.append(torch.cat([p[lo:hi].view(x.shape) for p in parts], dim=dim))
        lo = hi
    return out


def _reduce_scatter_raw(gs, shapes, group, dims) -> list:
    """The transpose of ``_gather_raw``: each cotangent ``gs[i]`` of a
    gathered tensor cut along ``dims[i]`` in the group's blocks, every
    block summed over the group (float32 for bfloat16 or float16), and
    this rank's block kept, at ``shapes[i]``."""
    n = _size(group)
    low = _low(gs[0].dtype)
    parts = torch.cat([torch.stack(g.chunk(n, dim=dim)).reshape(n, -1)
                       for g, dim in zip(gs, dims)], dim=1)
    parts = parts.float() if low else parts
    width = parts.shape[1]
    flat = parts.new_empty(width)
    t0 = time.perf_counter()
    _wait([dist.reduce_scatter_tensor(
        flat[lo:hi], parts[:, lo:hi].contiguous().view(-1),
        op=dist.ReduceOp.SUM, group=g, async_op=True)
        for lo, hi, g in _stripes(flat, group)], "reduce_scatter", t0)
    _MOVED["reduce_scatter"] += (n - 1) * width * flat.element_size()
    out, lo = [], 0
    for g, shape in zip(gs, shapes):
        hi = lo + math.prod(shape)
        block = flat[lo:hi].view(shape)
        out.append(block.to(g.dtype) if low else block)
        lo = hi
    return out


class _Sum(torch.autograd.Function):
    """``x`` summed over ``group`` (replicated there); the cotangent
    unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, dist.ReduceOp.SUM, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedInputs(torch.autograd.Function):
    """Values every rank of ``group`` holds alike, each rank's use its
    own: the identity; the cotangents summed over the group (one
    all-reduce for all of them)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = list(gs)
        for dtype in dict.fromkeys(g.dtype for g in gs):
            idx = [i for i, g in enumerate(gs) if g.dtype == dtype]
            for i, g in zip(idx, _all_reduce_many([gs[i] for i in idx],
                                                  ctx.group, "sum_bwd")):
                out[i] = g
        return (None, *out)


class _Gather(torch.autograd.Function):
    """Each of ``xs`` gathered along its dim over ``group``, one
    all-gather; backward each cotangent's block of this rank kept
    (``"slice"``) or reduce-scattered (``"sum"``), by ``modes``."""

    @staticmethod
    def forward(ctx, group, dims, modes, *xs):
        ctx.group, ctx.dims, ctx.modes = group, dims, modes
        ctx.shapes = [x.shape for x in xs]
        ctx.index = dist.get_rank(group[0])
        return tuple(_gather_raw(xs, group, dims))

    @staticmethod
    def backward(ctx, *gs):
        out = [None] * len(gs)
        summed = [i for i, m in enumerate(ctx.modes) if m == "sum"]
        for i, m in enumerate(ctx.modes):
            if m == "slice":
                n = ctx.shapes[i][ctx.dims[i]]
                out[i] = gs[i].narrow(ctx.dims[i], ctx.index * n, n)
        for dtype in dict.fromkeys(gs[i].dtype for i in summed):
            idx = [i for i in summed if gs[i].dtype == dtype]
            got = _reduce_scatter_raw([gs[i].contiguous() for i in idx],
                                      [ctx.shapes[i] for i in idx], ctx.group,
                                      [ctx.dims[i] for i in idx])
            for i, g in zip(idx, got):
                out[i] = g
        return (None, None, None, *out)


def _recording(xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def gather(x: torch.Tensor, group, dim: int,
           backward: str = "slice") -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order (``x`` itself for None); its gradient by ``backward``
    (``gather_fused``)."""
    return gather_fused([x], group, [dim], backward)[0]


def gather_fused(xs: "list[torch.Tensor]", group, dims: "list[int]",
                 backward="slice") -> "list[torch.Tensor]":
    """``gather`` of each of ``xs`` (one dtype) along its dim of ``dims``
    over ``group``, as one all-gather of their concatenated values. Each
    one's gradient keeps this rank's block of its cotangent (``"slice"``:
    the gathered value is read alike on every rank) or sums the
    cotangent over the group first (``"sum"``, a reduce-scatter: each
    rank reads it on its own rows); ``backward`` is one mode for all or
    a list of one a tensor."""
    if group is None:
        return list(xs)
    modes = ([backward] * len(xs) if isinstance(backward, str)
             else list(backward))
    if not _recording(xs):
        return _gather_raw(xs, group, dims)
    return list(_Gather.apply(group, tuple(dims), tuple(modes), *xs))


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, on every rank of it; the
    cotangent passes through."""
    if group is None:
        return x
    if not _recording([x]):
        return _all_reduce(x, group, dist.ReduceOp.SUM, "sum")
    return _Sum.apply(x, group)


def sum_of_squares(x: torch.Tensor, group) -> torch.Tensor:
    """The float32 sum of squares of ``x`` over its last dim, (..., 1),
    summed over ``group``: the rank's block of a norm's width, the
    whole width's sum on every rank."""
    xf = x.float()
    return sum_over((xf * xf).sum(dim=-1, keepdim=True), group)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, on every rank of it,
    without a gradient (a softmax's shift)."""
    if group is None:
        return x.detach()
    with torch.no_grad():
        return _all_reduce(x.detach(), group, dist.ReduceOp.MAX, "max")


def replicated_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, held alike by every rank of ``group`` and entering a
    computation split over it: its cotangent summed over the group."""
    return replicated_inputs([x], group)[0]


def replicated_inputs(xs: "list[torch.Tensor]", group) -> "list[torch.Tensor]":
    """``replicated_input`` of each of ``xs``, their cotangents summed in
    one all-reduce a dtype."""
    if group is None or not _recording(xs):
        return list(xs)
    return list(_ReplicatedInputs.apply(group, *xs))


# -- the rank's place on the mesh ---------------------------------------------

@dataclasses.dataclass(eq=False)
class Layout:
    """This process's coordinates on ``mesh`` (a ``DeviceMesh``) and its
    groups over named axes, each ``STRIPES`` process groups of the same
    ranks; a group is None where the axes hold one rank."""

    mesh: object
    sizes: "dict[str, int]" = dataclasses.field(init=False)
    coord: "dict[str, int]" = dataclasses.field(init=False)

    def __post_init__(self):
        self.sizes = axis_sizes(self.mesh)
        self.coord = rules.coordinate(self.mesh)
        self._groups: dict = {}

    def size(self, axes) -> int:
        return math.prod(self.sizes.get(a, 1) for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major block index over ``axes``."""
        idx = 0
        for a in _axes(axes):
            if a in self.sizes:
                idx = idx * self.sizes[a] + self.coord[a]
        return idx

    def group(self, axes):
        axes = tuple(a for a in _axes(axes) if a in self.sizes)
        if self.size(axes) == 1:
            return None
        if axes not in self._groups:
            self._groups[axes] = tuple(axis_group(self.mesh, axes, k)
                                       for k in range(STRIPES))
        return self._groups[axes]

    @property
    def model(self):
        return self.group("model")

    @property
    def model_index(self) -> int:
        return self.coord.get("model", 0)

    def block(self, spec, dim: int, length: int) -> "tuple[int, int, object]":
        """(offset, length, group) of this rank's block of a dim of global
        ``length`` sharded by ``spec`` (the group over the dim's axes)."""
        axes = spec[dim] if dim < len(spec) else None
        if axes is None:
            return 0, length, None
        n = self.size(axes)
        return self.index(axes) * (length // n), length // n, self.group(axes)


def model_block(length: int) -> "tuple[Layout | None, int, int]":
    """(layout, offset, length) of this rank's ``model`` block of a dim
    of ``length`` under the active mesh, as the rules' guard cuts it:
    (None, 0, ``length``) without a mesh, where ``model`` holds one rank
    or where ``length`` does not divide over it."""
    mesh = get_mesh()
    if mesh is None:
        return None, 0, length
    lay = layout(mesh)
    m = lay.size("model")
    if m == 1 or length % m:
        return None, 0, length
    return lay, lay.model_index * (length // m), length // m


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


_LAYOUTS: dict = {}


def layout(mesh) -> Layout:
    """The ``Layout`` of this process on ``mesh`` (made once a mesh)."""
    key = id(mesh)
    if key not in _LAYOUTS or _LAYOUTS[key].mesh is not mesh:
        _LAYOUTS[key] = Layout(mesh)
    return _LAYOUTS[key]


def unshard_all(items, lay: Layout) -> "list[torch.Tensor]":
    """Each (x, spec, keep) or (x, spec, keep, reduce) of ``items``:
    ``x``, this rank's shard under ``spec``, gathered over every sharded
    dim whose axes are not all in ``keep`` (a weight's FSDP dims on use,
    a state leaf's whole global value); the gradient of a gather over
    axes named in ``reduce`` is reduce-scattered, of any other the
    rank's block kept (``gather_fused``'s ``"sum"`` and ``"slice"``). The
    gathers over one group of one dtype run as one all-gather (a unit's
    FSDP weights: one collective, not one a leaf)."""
    out = [item[0] for item in items]
    reduce = [item[3] if len(item) > 3 else () for item in items]
    todo = []
    for i, (_, spec, keep, *_) in enumerate(items):
        for dim, axes in enumerate(spec):
            names = _axes(axes)
            if not names or all(a in keep for a in names):
                continue
            if any(a in keep for a in names):
                raise NotImplementedError(
                    f"dim {dim} is sharded over {names}, of which only "
                    f"{tuple(a for a in names if a in keep)} would be kept")
            todo.append((i, dim, names))
    while todo:
        # one round: each item's first pending gather, bucketed
        buckets: dict = {}
        seen, rest = set(), []
        for i, dim, names in todo:
            if i in seen:
                rest.append((i, dim, names))
                continue
            seen.add(i)
            buckets.setdefault((names, out[i].dtype), []).append((i, dim))
        for (names, _), members in buckets.items():
            got = gather_fused([out[i] for i, _ in members], lay.group(names),
                               [dim for _, dim in members],
                               ["sum" if set(names) & set(reduce[i])
                                else "slice" for i, _ in members])
            for (i, _), x in zip(members, got):
                out[i] = x
        todo = rest
    return out
