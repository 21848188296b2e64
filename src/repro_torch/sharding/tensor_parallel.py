"""Forward collectives and a rank's place in an LM served over a mesh.

Under ``sharding.ctx.use_mesh`` the port's LMs hold the reference's
serving layout: weights as ``rules.serving_param_spec`` cuts them, the
decode state as ``rules.state_spec`` does. Where the reference's GSPMD
partitioner inserts collectives of its own, the port calls these
explicitly:

  * ``gather`` over ``data`` of a weight's FSDP-sharded dim, on use
    (``unshard_all``: a unit's weights in one collective), and over
    ``model`` of vocab-sharded logits, of the heads of q, K and V (a
    cross layer's K and V of the memory too), of
    the last dim of a recurrent block's column-parallel activation
    (mamba2's ``w_in`` product, the RG-LRU's ``w_x`` product) and of
    the RG-LRU's state;
  * ``sum_over`` ``model`` of row-parallel partial outputs (``wo``,
    ``w_down``, ``w_out``) and of a vocab-parallel embedding's rows,
    and ``sum_of_squares`` over ``model`` of mamba2's gated RMSNorm;
  * ``max_over`` and ``sum_over`` the cache's sequence shards (a
    right-sized ring's apart from a full cache's) of a softmax's max
    and sum, then of the probability-weighted V.

Serving has no backward, and these collectives have none either: each
raises when autograd records through it, where c10d's would give a
silently wrong gradient (ROADMAP section 3, fault P1). A group is a
tuple of ``STRIPES`` process groups of the same ranks: a payload of
``STRIPE_MIN_BYTES`` or more is cut in as many stripes, all in flight
at once (gloo moves one collective at a time over a group's TCP pairs,
which hold a gather of a layer's weights to a fraction of the host's
copy rate). A group of one rank is None, and each collective is then
the identity, so a 1 x 1 mesh runs the no-mesh arithmetic bit for bit.
Sums of bfloat16 or float16 partials run in float32 and are rounded
back once. ``moved_bytes`` counts what each collective kind received on
this rank, and ``collective_seconds`` the host time each kind spent
(the calls block until their result is here).
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

# bytes each collective kind brought to this rank, and the host seconds
# it took, since the last reset
_MOVED: "dict[str, int]" = {"gather": 0, "sum": 0, "max": 0}
_SECONDS: "dict[str, float]" = {"gather": 0.0, "sum": 0.0, "max": 0.0}


def reset_moved_bytes() -> None:
    """Zero ``moved_bytes`` and ``collective_seconds``."""
    for kind in _MOVED:
        _MOVED[kind] = 0
        _SECONDS[kind] = 0.0


def collective_seconds() -> "dict[str, float]":
    """Host seconds this rank spent in each collective kind."""
    return dict(_SECONDS)


def moved_bytes() -> "dict[str, int]":
    """Bytes received by this rank's collectives, by kind: a gather's
    other ranks' parts, an all-reduce's (n - 1) / n of its buffer twice
    (a ring's reduce-scatter and all-gather)."""
    return dict(_MOVED)


def _forward_only(x: torch.Tensor, what: str) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{what}: the serving collectives of an LM over a mesh are "
            f"forward-only (no gradient flows through them); run it under "
            f"torch.no_grad(), or train without a mesh")


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


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order (``x`` itself for None)."""
    return gather_fused([x], group, [dim])[0]


def _all_reduce(x: torch.Tensor, group, op, kind: str) -> torch.Tensor:
    _forward_only(x, kind)
    low = x.dtype in (torch.bfloat16, torch.float16)
    out = (x.float() if low else x.clone()).contiguous()
    flat = out.view(-1)
    t0 = time.perf_counter()
    _wait([dist.all_reduce(flat[lo:hi], op=op, group=g, async_op=True)
           for lo, hi, g in _stripes(flat, group)], kind, t0)
    n = dist.get_world_size(group[0])
    _MOVED[kind] += 2 * (n - 1) * out.numel() * out.element_size() // n
    return out.to(x.dtype) if low else out


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, on every rank of it."""
    if group is None:
        return x
    return _all_reduce(x, group, dist.ReduceOp.SUM, "sum")


def sum_of_squares(x: torch.Tensor, group) -> torch.Tensor:
    """The float32 sum of squares of ``x`` over its last dim, (..., 1),
    summed over ``group``: the rank's block of a norm's width, the
    whole width's sum on every rank."""
    xf = x.float()
    return sum_over((xf * xf).sum(dim=-1, keepdim=True), group)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, on every rank of it."""
    if group is None:
        return x
    return _all_reduce(x, group, dist.ReduceOp.MAX, "max")


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


def gather_fused(xs: "list[torch.Tensor]", group,
                 dims: "list[int]") -> "list[torch.Tensor]":
    """``gather`` of each of ``xs`` (one dtype) along its dim of ``dims``
    over ``group``, as one all-gather of their concatenated values."""
    if group is None:
        return list(xs)
    for x in xs:
        _forward_only(x, "gather")
    n = dist.get_world_size(group[0])
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


def unshard_all(items, lay: Layout) -> "list[torch.Tensor]":
    """Each (x, spec, keep) of ``items``: ``x``, this rank's shard under
    ``spec``, gathered over every sharded dim whose axes are not all in
    ``keep`` (a weight's FSDP dims on use, a state leaf's whole global
    value). The gathers over one group of one dtype run as one
    all-gather (a unit's FSDP weights: one collective, not one a leaf)."""
    out = [x for x, _, _ in items]
    todo = []
    for i, (_, spec, keep) in enumerate(items):
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
                               [dim for _, dim in members])
            for (i, _), x in zip(members, got):
                out[i] = x
        todo = rest
    return out

