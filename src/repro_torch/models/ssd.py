"""Mamba-2 SSD (state-space duality) block, the counterpart of
``repro.models.ssd`` (arXiv:2405.21060).

After the input projection the block carries

  x  (B, T, H, P)   value heads          (P = head dim)
  dt (B, T, H)      softplus step sizes
  A  (H,)           negative decay rates
  B_ (B, T, N)      input maps  (n_groups = 1)
  C_ (B, T, N)      output maps
  D  (H,)           skip connection

``ssd_scan`` is the reference's chunked algorithm in float32: the
quadratic intra-chunk term and the chunk end states as batched matrix
products over (chunk x chunk) tiles, then a loop over the T/chunk chunk
states. Each of the reference's four-operand einsums is one product of a
scaled operand, so no (..., Q, Q, P) intermediate appears. ``a_log``,
``d_skip`` and ``dt_bias`` are float32 whatever ``cfg.param_dtype`` is,
and so is the recurrent state.

On a mesh (``sharding.ctx.use_mesh``) a rank runs the scan on its
``model`` block of the heads, the reference's constraint on ``xh``
(``shard(xh, BATCH, None, MODEL, None)``). ``w_in``'s columns are cut
into z | x | B | C | dt, so a ``model`` block of them crosses those
boundaries: its product is all-gathered over ``model`` and every rank
runs the depthwise conv over every channel (the conv state is whole over
``model``, and B and C are shared by all heads), then takes its heads of
x and dt. The gated RMSNorm spans all of d_inner: each rank's float32
sum of squares is summed over ``model`` and scales the rank's block,
whose product with ``w_out``'s rows is summed over ``model``.

In training (a backward through those collectives) each rank reads the
gathered product, the conv's output, the norm's summed squares and the
whole leaves ``conv_w``, ``conv_b``, ``a_log``, ``d_skip``, ``dt_bias``
and the norm's scale on its heads alone: each of their cotangents is a
part of the whole, so the gather's transpose is a reduce-scatter
(``"sum"``), and the summed squares' and the whole leaves' cotangents
are summed over ``model`` (``tensor_parallel.replicated_input``), as is
that of ``u``, which enters the product split over ``model``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ModelConfig,
    dense_init,
    residual_out_init,
    rmsnorm,
)
from repro_torch.sharding import tensor_parallel as tp


def ssd_init(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """One block's parameters; ``lead`` prepends stacking axes."""
    d, din = cfg.d_model, cfg.ssm_d_inner
    h, n, k = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv
    conv_dim = din + 2 * n  # conv over [x, B, C]
    dev, dt = gen.device, cfg.param_dtype
    w_in = dense_init(gen, (*lead, d, 2 * din + 2 * n + h), d, dt)
    conv_w = torch.randn((*lead, k, conv_dim), generator=gen,
                         dtype=torch.float32, device=dev)
    u = torch.rand((*lead, h), generator=gen, dtype=torch.float32, device=dev)
    # inverse-softplus of dt, log-uniform in [1e-3, 1e-1]
    dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev))
    return {
        # in_proj -> [z (din), x (din), B (n), C (n), dt (h)]
        "w_in": w_in,
        "conv_w": (conv_w * (3.0 / k) ** 0.5).to(dt),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dt, device=dev),
        "a_log": a_log.expand(*lead, h).clone(),
        "d_skip": torch.ones((*lead, h), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm": {"scale": torch.zeros((*lead, din), dtype=dt, device=dev)},
        "w_out": residual_out_init(gen, (*lead, din, d), din, cfg),
    }


# the leaves every rank holds whole and reads on its heads alone
_WHOLE = ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias")


def _read_on_heads(params: dict, heads) -> dict:
    """``params`` with the whole leaves a rank reads on its heads alone
    (``_WHOLE``, the norm's scale) summed over ``heads.model`` in the
    backward; ``params`` itself where the heads do not split (``heads``
    None)."""
    if heads is None:
        return params
    got = tp.replicated_inputs([params[k] for k in _WHOLE]
                               + [params["norm"]["scale"]], heads.model)
    return {**params, **dict(zip(_WHOLE, got)), "norm": {"scale": got[-1]}}


def _split_proj(params: dict, u: torch.Tensor, cfg: ModelConfig, heads):
    """z, [x, B, C] and the raw dt of every channel; on a mesh the
    product with the rank's block of ``w_in``'s columns is all-gathered
    over ``model``. ``heads`` is the layout where the rank reads them on
    its block of the heads (None where every rank reads all): their
    cotangent is then a part of the whole, summed over ``model``."""
    din, n = cfg.ssm_d_inner, cfg.ssm_state
    lay = tp.model_block(2 * din + 2 * n + cfg.ssm_heads)[0]
    if lay is not None:
        u = tp.replicated_input(u, lay.model)
    zxbcdt = u @ params["w_in"]
    if lay is not None:
        zxbcdt = tp.gather(zxbcdt, lay.model, -1,
                           "slice" if heads is None else "sum")
    elif heads is not None:
        zxbcdt = tp.replicated_input(zxbcdt, heads.model)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * n]
    dt_raw = zxbcdt[..., 2 * din + 2 * n:]
    return z, xbc, dt_raw


def _gated_out(params: dict, y: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig, lay, lo: int) -> torch.Tensor:
    """``rmsnorm(norm, y * silu(z)) @ w_out`` for y, channels [lo, lo +
    width) of d_inner (the rank's heads on a mesh, ``lay`` its layout,
    else all of them and None): the norm's sum of squares summed over
    ``model``, the product with ``w_out``'s rows of those channels
    summed over ``model`` where ``w_out`` holds a block of them."""
    din, width = cfg.ssm_d_inner, y.shape[-1]
    g = y * F.silu(z[..., lo:lo + width])
    if lay is None:
        g = rmsnorm(params["norm"], g)
    else:
        # the whole width's sum, read on the rank's block alone
        ss = tp.replicated_input(tp.sum_of_squares(g, lay.model), lay.model)
        scale = params["norm"]["scale"][lo:lo + width].float()
        g = (g.float() * torch.rsqrt(ss / din + 1e-6)
             * (1.0 + scale)).to(y.dtype)
    w = params["w_out"]
    if w.shape[-2] == din:
        return g @ w
    wlay, w0, wn = tp.model_block(din)
    if lay is None:  # every channel here, w_out's rows split
        g = tp.replicated_input(g, wlay.model)
    return tp.sum_over(g[..., w0 - lo:w0 - lo + wn] @ w, wlay.model)


def _post_conv(xbc: torch.Tensor, cfg: ModelConfig):
    din, n = cfg.ssm_d_inner, cfg.ssm_state
    xbc = F.silu(xbc)
    return xbc[..., :din], xbc[..., din:din + n], xbc[..., din + n:]


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, conv_state=None):
    """Depthwise causal conv over time. xbc (B, T, C), conv_w (K, C).

    conv_state (B, K-1, C): trailing inputs of the previous segment
    (decode). Returns (out (B, T, C), the new state: the last K-1 rows of
    [conv_state, xbc])."""
    k = conv_w.shape[0]
    b, t, c = xbc.shape
    if conv_state is None:
        conv_state = torch.zeros((b, k - 1, c), dtype=xbc.dtype,
                                 device=xbc.device)
    ext = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B, T+K-1, C)
    out = ext[:, 0:t] * conv_w[0]
    for i in range(1, k):
        out = out + ext[:, i:i + t] * conv_w[i]
    out = out + conv_b
    return out, ext[:, ext.shape[1] - (k - 1):]


def _segsum_decay(dA: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular decay logs, -inf above."""
    q = dA.shape[-1]
    cum = torch.cumsum(dA, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]  # log decay j -> i
    upper = torch.ones((q, q), dtype=torch.bool,
                       device=dA.device).triu(diagonal=1)
    return diff.masked_fill(upper, -math.inf)


def ssd_scan(x, dt, a_neg, b_, c_, d_skip, *, chunk: int, init_state=None):
    """Chunked SSD. x (B,T,H,P), dt (B,T,H), a_neg (H,), b_/c_ (B,T,N).

    Returns (y (B,T,H,P) float32, final_state (B,H,N,P) float32)."""
    bsz, t, h, p = x.shape
    n = b_.shape[-1]
    if t % chunk != 0:
        raise ValueError(f"sequence length {t} must be divisible by the "
                         f"SSD scan chunk {chunk}")
    nc = t // chunk
    f32 = torch.float32
    xf = x.to(f32).reshape(bsz, nc, chunk, h, p)
    dtf = dt.to(f32).reshape(bsz, nc, chunk, h)
    bf = b_.to(f32).reshape(bsz, nc, chunk, n)
    cf = c_.to(f32).reshape(bsz, nc, chunk, n)
    a_neg = a_neg.to(f32)
    d_skip = d_skip.to(f32)

    x_hqp = xf.permute(0, 1, 3, 2, 4)  # (B,nc,H,Q,P)
    dt_hq = dtf.permute(0, 1, 3, 2)  # (B,nc,H,Q)
    dA_hq = dt_hq * a_neg[:, None]  # log-decay per step
    cum = torch.cumsum(dA_hq, dim=-1)  # (B,nc,H,Q)
    decay_mat = torch.exp(_segsum_decay(dA_hq))  # (B,nc,H,Q,Q)

    # intra-chunk (diagonal) term: sum_j scores_ij decay_hij dt_jh x_jhp
    scores = cf @ bf.transpose(-1, -2)  # (B,nc,Q,Q)
    mix = scores[:, :, None] * decay_mat * dt_hq[:, :, :, None, :]
    y_diag = mix @ x_hqp  # (B,nc,H,Q,P)

    # chunk end states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[..., -1:] - cum)  # (B,nc,H,Q)
    xw = x_hqp * (decay_to_end * dt_hq)[..., None]
    s_chunk = bf.transpose(-1, -2)[:, :, None] @ xw  # (B,nc,H,N,P)

    # inter-chunk recurrence over the nc chunks: the state before each
    chunk_decay = torch.exp(cum[..., -1])  # (B,nc,H)
    s = (torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    before = []
    for c in range(nc):
        before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    states_before = torch.stack(before, dim=1)  # (B,nc,H,N,P)

    # off-diagonal (inter-chunk) term: sum_n C_in exp(cum_hi) S_hnp
    y_off = (cf[:, :, None] @ states_before) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4) + d_skip[:, None] * xf
    return y.reshape(bsz, t, h, p), s


def ssd_block_apply(params: dict, u: torch.Tensor, cfg: ModelConfig, *,
                    ssm_state=None, conv_state=None,
                    return_state: bool = False):
    """Full mamba2 block over a sequence. u (B, T, D); on a mesh the ssm
    state in and out holds the rank's heads."""
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    lay, h0, hn = tp.model_block(h)  # the rank's heads
    heads = slice(h0, h0 + hn)
    params = _read_on_heads(params, lay)
    z, xbc_raw, dt_raw = _split_proj(params, u, cfg, lay)
    xbc, new_conv_state = _causal_conv(
        xbc_raw, params["conv_w"].to(u.dtype), params["conv_b"].to(u.dtype),
        conv_state)
    x, b_, c_ = _post_conv(xbc, cfg)
    bsz, t, _ = u.shape
    dt = F.softplus(dt_raw[..., heads].float() + params["dt_bias"][heads])
    a_neg = -torch.exp(params["a_log"][heads])
    y, final_state = ssd_scan(
        x.reshape(bsz, t, h, p)[:, :, heads], dt, a_neg, b_, c_,
        params["d_skip"][heads], chunk=min(cfg.ssm_chunk, t),
        init_state=ssm_state)
    y = y.reshape(bsz, t, hn * p).to(u.dtype)
    out = _gated_out(params, y, z, cfg, lay, h0 * p)
    if return_state:
        return out, final_state, new_conv_state
    return out


def ssd_decode_step(params: dict, u: torch.Tensor, cfg: ModelConfig, *,
                    ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One-token step. u (B, 1, D); states from ``make_ssd_state`` or a
    prefill (on a mesh the ssm state holds the rank's heads). Returns
    (out (B, 1, D), new ssm state, new conv state)."""
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    lay, h0, hn = tp.model_block(h)  # the rank's heads, the state's
    heads = slice(h0, h0 + hn)
    z, xbc_raw, dt_raw = _split_proj(params, u, cfg, lay)
    xbc, new_conv_state = _causal_conv(
        xbc_raw, params["conv_w"].to(u.dtype), params["conv_b"].to(u.dtype),
        conv_state)
    x, b_, c_ = _post_conv(xbc, cfg)
    bsz = u.shape[0]
    xh = x.reshape(bsz, h, p)[:, heads].float()
    dt = F.softplus(dt_raw[:, 0, heads].float()
                    + params["dt_bias"][heads])  # (B, H)
    a_neg = -torch.exp(params["a_log"][heads])
    dec = torch.exp(dt * a_neg)  # (B, H)
    bf = b_[:, 0].float()  # (B, N)
    cf = c_[:, 0].float()
    # einsum("bh,bn,bhp->bhnp") and einsum("bn,bhnp->bhp")
    new_state = (ssm_state * dec[:, :, None, None]
                 + bf[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :])
    y = ((cf[:, None, None, :] @ new_state)[:, :, 0]
         + params["d_skip"][heads, None] * xh)
    y = y.reshape(bsz, 1, hn * p).to(u.dtype)
    return (_gated_out(params, y, z, cfg, lay, h0 * p), new_state,
            new_conv_state)


def make_ssd_state(cfg: ModelConfig, n_layers: int, batch: int,
                   device) -> dict:
    """Zeroed stacked states: ssm (L, B, H, N, P) float32, conv
    (L, B, K-1, d_inner + 2N) in ``cfg.dtype``."""
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.ssm_d_inner + 2 * n
    return {
        "ssm": torch.zeros((n_layers, batch, h, n, p), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=cfg.dtype, device=device),
    }
