"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
the counterpart of ``repro.models.rglru``.

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(c * softplus(Lambda) * (-r_t))   in (0,1),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``rglru_scan`` runs the recurrence over T as a log-depth scan on whole
tensors (ceil(log2 T) elementwise stages), where the reference runs
``lax.associative_scan``: the same pairs combined in another order.
Decode is O(1). The residual block: linear -> causal conv(4) -> RG-LRU
on one branch, a gelu gate on the other, merged by an output projection.
``lam`` and the state ``h`` are float32 whatever ``cfg.param_dtype`` is.

On a mesh (``sharding.ctx.use_mesh``) a rank holds its ``model`` block
of the width in ``w_x``, ``w_gate``, ``w_a`` and ``w_i``'s columns and
``w_out``'s rows, the reference's constraint on x (``shard(x, BATCH,
None, MODEL)``). The gates contract x over the whole width, and the
conv state is whole over ``model``: the ``w_x`` product is all-gathered
over ``model`` and the conv runs over every channel. The recurrence is
diagonal, so each rank runs it on its block alone, and its block of
``h`` is all-gathered so that the stored state is whole; the gated
output's product with ``w_out`` is summed over ``model``.

In training each rank reads the gathered ``w_x`` product, the conv's
output and the whole leaves ``conv_w``, ``conv_b``, ``b_a``, ``b_i`` and
``lam`` on its block of the width alone: the gather's transpose is a
reduce-scatter (``"sum"``) and those leaves' cotangents are summed over
``model``, as is that of ``u``, which enters the products split over
``model``. The final state's gather stays out of a loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init, residual_out_init
from repro_torch.sharding import tensor_parallel as tp

_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """One block's parameters; ``lead`` prepends stacking axes."""
    d, k = cfg.d_model, cfg.rglru_conv
    dev, dt = gen.device, cfg.param_dtype
    w_x = dense_init(gen, (*lead, d, d), d, dt)  # input branch
    w_gate = dense_init(gen, (*lead, d, d), d, dt)  # gelu gate branch
    conv_w = torch.randn((*lead, k, d), generator=gen, dtype=torch.float32,
                         device=dev)
    w_a = dense_init(gen, (*lead, d, d), d, dt)
    w_i = dense_init(gen, (*lead, d, d), d, dt)
    return {
        "w_x": w_x,
        "w_gate": w_gate,
        "conv_w": (conv_w * (3.0 / k) ** 0.5).to(dt),
        "conv_b": torch.zeros((*lead, d), dtype=dt, device=dev),
        "w_a": w_a,
        "b_a": torch.zeros((*lead, d), dtype=dt, device=dev),
        "w_i": w_i,
        "b_i": torch.zeros((*lead, d), dtype=dt, device=dev),
        # Lambda so that a^c lies roughly in [0.9, 0.999] at r = 1
        "lam": torch.linspace(0.3, 1.5, d, dtype=torch.float32,
                              device=dev).expand(*lead, d).clone(),
        "w_out": residual_out_init(gen, (*lead, d, d), d, cfg),
    }


def _gates(params: dict, x: torch.Tensor, cols: slice = slice(None)):
    """The decay a_t and the gated input of each step, float32, of the
    channels ``cols`` (those of ``w_a``'s and ``w_i``'s columns). x
    (B, T, D), the whole width the gates contract."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"][cols].float())
    i = torch.sigmoid(xf @ params["w_i"].float() + params["b_i"][cols].float())
    lam = F.softplus(params["lam"][cols])  # (D,)
    a = torch.exp(-_C * lam * r)  # a_t, (B, T, D)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf[..., cols])
    return a, gated


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_0 = 0 along dim 1, for every t:
    Hillis-Steele doubling, stage s combining each step with the one 2^s
    before it, (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    t = a.shape[1]
    off = 1
    while off < t:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        if 2 * off < t:  # the last stage's products are not read
            a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


def rglru_scan(params: dict, x: torch.Tensor, h0=None,
               cols: slice = slice(None)):
    """The linear recurrence over T of the channels ``cols``. x (B, T, D)
    -> (y (B, T, D) in x's dtype, h_T (B, D) float32), of those
    channels; ``h0`` holds them too."""
    a, b = _gates(params, x, cols)
    if h0 is not None:
        # fold the initial state into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    y = _linear_scan(a, b)  # h_t for every t
    return y.to(x.dtype), y[:, -1]


def rglru_step(params: dict, x: torch.Tensor, h: torch.Tensor,
               cols: slice = slice(None)):
    """One-token recurrence of the channels ``cols``. x (B, 1, D), h
    (B, D) float32 of those channels."""
    a, b = _gates(params, x, cols)
    h_new = a[:, 0] * h + b[:, 0]
    return h_new[:, None, :].to(x.dtype), h_new


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 conv_state=None):
    """Depthwise causal conv over time, x (B, T, C), conv_w (K, C);
    returns (out, the last K-1 rows of [conv_state, x])."""
    k = conv_w.shape[0]
    bsz, t, c = x.shape
    if conv_state is None:
        conv_state = torch.zeros((bsz, k - 1, c), dtype=x.dtype,
                                 device=x.device)
    ext = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = ext[:, 0:t] * conv_w[0]
    for i in range(1, k):
        out = out + ext[:, i:i + t] * conv_w[i]
    out = out + conv_b
    return out, ext[:, ext.shape[1] - (k - 1):]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _width(cfg: ModelConfig) -> "tuple[tp.Layout | None, slice]":
    """(the layout, the channels) of the rank's ``model`` block of the
    width: (None, every channel) off a mesh or where it does not split."""
    lay, lo, n = tp.model_block(cfg.d_model)
    return lay, slice(lo, lo + n)


# the leaves every rank holds whole and reads on its block of the width
_WHOLE = ("conv_w", "conv_b", "b_a", "b_i", "lam")


def _split_inputs(params: dict, u: torch.Tensor, lay):
    """(``params``, ``u``) with the cotangents of ``_WHOLE``'s leaves and
    of ``u`` summed over ``lay.model`` (each rank reads them on its block
    of the width); unchanged off a mesh (``lay`` None)."""
    if lay is None:
        return params, u
    *got, u = tp.replicated_inputs([params[k] for k in _WHOLE] + [u],
                                   lay.model)
    return {**params, **dict(zip(_WHOLE, got))}, u


def _conv_whole(params: dict, u: torch.Tensor, lay, conv_state):
    """The conv of ``u @ w_x`` over every channel (the product of the
    rank's columns all-gathered over ``model`` on a mesh, each rank
    reading it on its block of the width): (out, the new conv state)."""
    x = u @ params["w_x"]
    if lay is not None:
        x = tp.gather(x, lay.model, -1, "sum")
    return _causal_conv(x, params["conv_w"].to(u.dtype),
                        params["conv_b"].to(u.dtype), conv_state)


def rglru_block_apply(params: dict, u: torch.Tensor, cfg: ModelConfig, *,
                      state=None, conv_state=None,
                      return_state: bool = False):
    """Full Griffin recurrent block. u (B, T, D); the states in and out
    are whole (on a mesh too)."""
    lay, cols = _width(cfg)
    params, u = _split_inputs(params, u, lay)
    gate = _gelu(u @ params["w_gate"])
    x, new_conv = _conv_whole(params, u, lay, conv_state)
    y, h_last = rglru_scan(params, x, None if state is None else
                           state[:, cols], cols)
    out = (gate * y) @ params["w_out"]
    if lay is not None:
        out = tp.sum_over(out, lay.model)
    if not return_state:
        return out
    if lay is not None:
        h_last = tp.gather(h_last, lay.model, -1)
    return out, h_last, new_conv


def rglru_decode_step(params: dict, u: torch.Tensor, cfg: ModelConfig, *,
                      state: torch.Tensor, conv_state: torch.Tensor):
    """One-token step. u (B, 1, D); returns (out, new h, new conv state),
    the states whole (on a mesh too)."""
    lay, cols = _width(cfg)
    gate = _gelu(u @ params["w_gate"])
    x, new_conv = _conv_whole(params, u, lay, conv_state)
    y, h_new = rglru_step(params, x, state[:, cols], cols)
    out = (gate * y) @ params["w_out"]
    if lay is not None:
        h_new = tp.gather(h_new, lay.model, -1)
        out = tp.sum_over(out, lay.model)
    return out, h_new, new_conv
