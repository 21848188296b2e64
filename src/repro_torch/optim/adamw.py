"""AdamW (``repro.optim.adamw``) with a configurable state dtype: float32
by default, bfloat16 where float32 moments do not fit.

The arithmetic is the reference's: the global gradient norm in float32
over the leaves in ``jax.tree`` order, the clip scale applied in
float32, the moments updated in the state's dtype, and the step computed
in float32 and cast back to each parameter's dtype. The update returns
new tensors and leaves its inputs as they were, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def adamw_init(params, *, state_dtype=torch.float32) -> dict:
    """Zero moments in ``state_dtype`` beside each parameter, and the step
    count (0-dim int32 on the first parameter's device)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)

    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(params, grads, opt_state, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: "float | None" = 1.0):
    """One AdamW step: (new params, new state, the gradient's global norm
    before clipping, 0 without a clip). ``lr`` is a number or a 0-dim
    tensor (a schedule's value)."""
    step = opt_state["step"] + 1
    dev = step.device
    if grad_clip is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in leaves(grads)))
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
