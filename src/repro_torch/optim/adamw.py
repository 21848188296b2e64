"""AdamW (``repro.optim.adamw``) with a configurable state dtype: float32
by default, bfloat16 where float32 moments do not fit.

The arithmetic is the reference's: the global gradient norm in float32
over the leaves in ``jax.tree`` order, the clip scale applied in
float32, the moments updated in the state's dtype, and the step computed
in float32 and cast back to each parameter's dtype. The update returns
new tensors and leaves its inputs as they were, as the reference does.

Under a mesh (``sharding.ctx.use_mesh``) the parameters, gradients and
moments are the rank's shards, each leaf's block under the spec that
``specs`` gives it (``LM.param_specs``: ``rules.param_spec``, the
reference's ``train_4k`` layout). The update is elementwise on the
shards; the norm sums each leaf's squares over the axes that shard it
and counts them once over the axes that replicate it: the leaves that
share those axes are summed on the rank, then over their group, one
all-reduce a set of axes. Every rank gets the same norm.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.ctx import get_mesh
from repro_torch.tree import leaves, tree_map, unflatten


def adamw_init(params, *, state_dtype=torch.float32) -> dict:
    """Zero moments in ``state_dtype`` beside each parameter, and the step
    count (0-dim int32 on the first parameter's device)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)

    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _sum_of_squares(grads, specs) -> torch.Tensor:
    """The float32 sum of the squares of every gradient leaf: in leaf
    order without a mesh; on a mesh by sets of sharding axes (those of
    more than one rank in the leaf's spec of ``specs``), each set's sum
    all-reduced over its group, the sets in a fixed order."""
    mesh = get_mesh()
    sq = [torch.sum(torch.square(g.float())) for g in leaves(grads)]
    if mesh is not None:
        from repro_torch.sharding import tensor_parallel as tp

        lay = tp.layout(mesh)
        if lay.size(tuple(lay.sizes)) > 1:
            if specs is None:
                raise ValueError(
                    "adamw_update over a mesh needs the leaves' specs "
                    "(specs=model.param_specs()) for the gradient's norm")
            sets: dict = {}
            for x, spec in zip(sq, leaves(specs)):
                axes = tuple(a for a in lay.sizes if lay.sizes[a] > 1
                             and any(a == ax or (isinstance(ax, tuple)
                                                 and a in ax) for ax in spec))
                sets.setdefault(axes, []).append(x)
            return sum(tp.sum_over(torch.stack(xs).sum(), lay.group(axes))
                       for axes, xs in sorted(sets.items()))
    return sum(sq)


def adamw_update(params, grads, opt_state, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: "float | None" = 1.0, specs=None):
    """One AdamW step: (new params, new state, the gradient's global norm
    before clipping, 0 without a clip). ``lr`` is a number or a 0-dim
    tensor (a schedule's value). Under a mesh ``specs`` is the tree of
    the leaves' specs (``LM.param_specs()``), which the norm needs."""
    step = opt_state["step"] + 1
    dev = step.device
    if grad_clip is not None:
        gnorm = torch.sqrt(_sum_of_squares(grads, specs))
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=dev)
        scale = 1.0
    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    coef = {}  # the moments' coefficients in the state's dtype

    def upd(p, g, m, v):
        if m.dtype not in coef:
            # the reference's Python floats are weakly typed: a bfloat16
            # state multiplies by their bfloat16 roundings
            coef[m.dtype] = [torch.tensor(c, dtype=m.dtype)
                             for c in (b1, 1.0 - b1, b2, 1.0 - b2)]
        c1, c1m, c2, c2m = coef[m.dtype]
        gf = (g.float() * scale).to(m.dtype)
        m2 = c1 * m + c1m * gf
        v2 = c2 * v + c2m * torch.square(gf)
        mhat = m2.float() / bc1
        vhat = v2.float() / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    flat = [upd(*xs) for xs in zip(leaves(params), leaves(grads),
                                   leaves(opt_state["m"]),
                                   leaves(opt_state["v"]))]
    new_params = unflatten(params, [f[0] for f in flat])
    new_m = unflatten(params, [f[1] for f in flat])
    new_v = unflatten(params, [f[2] for f in flat])
    return new_params, {"m": new_m, "v": new_v, "step": step}, gnorm
