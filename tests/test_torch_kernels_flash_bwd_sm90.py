"""The tensor-core flash-attention backward (``sm90`` route,
``csrc/flash_attention_bwd_sm90.cu``) on the host: the kernel itself runs
only on a Hopper card (tests/test_torch_kernels_cuda.py).

* a rehearsal of its numerics: a plain emulation of what its kernels
  compute, tile by tile (64-row query tiles and 64-key tiles, q scale
  applied to the float32 S accumulator, the softmax in log2 units from
  lse log2(e), P and dS rounded to bfloat16 where wgmma reads them, every
  sum in float32, the dk/dv partials of each run of query heads added in
  run order), against ``repro_torch.kernels.ref.mha_blocked_grad`` and
  ``jax.vjp`` of ``repro.kernels.ref.mha_blocked`` on the same numpy
  inputs, within the op's bfloat16 tolerance: 2e-2 of each gradient's
  largest |value| (the tolerance the card's check holds the kernel to);
* the route rule (``flash_bwd_route``) and the runs of heads
  (``bwd_sm90_splits``);
* the source's tile constants: both kernels' shared memory within the
  H100's 232,448 bytes a block at D 64, 128 and 256, the dk/dv block's
  warpgroups, and the grid within its limits.
"""
import functools
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref as tref

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

BF16_TOL = 2e-2
_LOG2E = 1.4426950408889634
SMEM_PER_BLOCK = 232448
CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "flash_attention_bwd_sm90.cu")


@functools.cache
def _jax_grad(causal, window):
    def vjp(q, k, v, do):
        _, pull = jax.vjp(lambda q, k, v: jref.mha_blocked(
            q, k, v, causal=causal, window=window), q, k, v)
        return pull(do)
    return jax.jit(vjp)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _visible(rows, keys, t, causal, window):
    r, c = rows[:, None], keys[None, :]
    ok = (r < t) & (c < t)
    if causal:
        ok &= c <= r
    if window:
        ok &= c > r - window
    return ok


def _bf16(x):
    return x.bfloat16().float()


def _emulate_bwd_sm90(q, k, v, do, o, lse, *, causal, window, splits):
    """The sm90 kernels' tiles in plain PyTorch: q, k, v, do, o bfloat16
    (B, T, heads, D), lse float32 (B, H, T); returns bfloat16 (dq, dk,
    dv)."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    per = group // splits
    bt = kflash.BWD_SM90_TILE
    tpad = -(-t // bt) * bt
    w = window if window else 0
    scale = 1.0 / d**0.5
    scale_log2 = torch.tensor(scale * _LOG2E, dtype=torch.float32)

    def pad(x):  # rows of (B, T, heads, D) zero past t
        out = torch.zeros(x.shape[0], tpad, *x.shape[2:])
        out[:, :t] = x.float()
        return out
    qf, kf, vf, dof = pad(q), pad(k), pad(v), pad(do)
    # the delta pass: (B, H, Tpad), zero past t
    lse2 = torch.zeros(b, h, tpad)
    lse2[..., :t] = lse * torch.tensor(_LOG2E, dtype=torch.float32)
    delta = torch.zeros(b, h, tpad)
    delta[..., :t] = (do.float() * o.float()).sum(-1).transpose(1, 2)

    def p_ds(s, dp, l2, de, ok):  # P and dS of a tile, before rounding
        p = torch.where(ok, torch.exp2(s * scale_log2 - l2), 0.0)
        return p, p * (dp - de)

    parts_k = torch.zeros(splits, b, tpad, hkv, d)
    parts_v = torch.zeros(splits, b, tpad, hkv, d)
    for bb in range(b):
        for kvh in range(hkv):
            for split in range(splits):
                for j0 in range(0, t, bt):
                    keys = torch.arange(j0, j0 + bt)
                    kt, vt = kf[bb, j0:j0 + bt, kvh], vf[bb, j0:j0 + bt, kvh]
                    j_hi = min(j0 + bt, t) - 1
                    i_lo = j0 if causal else 0
                    i_hi = min(t - 1, j_hi + w - 1) if w else t - 1
                    acc_k, acc_v = torch.zeros(bt, d), torch.zeros(bt, d)
                    for g in range(per):
                        head = kvh * group + split * per + g
                        for i0 in range(i_lo // bt * bt, i_hi + 1, bt):
                            rows = torch.arange(i0, i0 + bt)
                            qt = qf[bb, i0:i0 + bt, head]
                            dot = dof[bb, i0:i0 + bt, head]
                            # S^T and dP^T: keys in rows, queries in columns
                            pt, dst = p_ds(
                                kt @ qt.T, vt @ dot.T,
                                lse2[bb, head, i0:i0 + bt][None, :],
                                delta[bb, head, i0:i0 + bt][None, :],
                                _visible(rows, keys, t, causal, w).T)
                            acc_v += _bf16(pt) @ dot
                            acc_k += _bf16(dst) @ qt
                    parts_k[split, bb, j0:j0 + bt, kvh] = acc_k * scale
                    parts_v[split, bb, j0:j0 + bt, kvh] = acc_v
    if splits == 1:
        dk, dv = parts_k[0], parts_v[0]
    else:  # the sum pass, in run order
        dk, dv = torch.zeros_like(parts_k[0]), torch.zeros_like(parts_v[0])
        for split in range(splits):
            dk, dv = dk + parts_k[split], dv + parts_v[split]

    dq = torch.zeros(b, tpad, h, d)
    for bb in range(b):
        for head in range(h):
            kvh = head // group
            for i0 in range(0, t, bt):
                rows = torch.arange(i0, i0 + bt)
                qt, dot = qf[bb, i0:i0 + bt, head], dof[bb, i0:i0 + bt, head]
                l2 = lse2[bb, head, i0:i0 + bt][:, None]
                de = delta[bb, head, i0:i0 + bt][:, None]
                i_hi = min(i0 + bt, t) - 1
                j_lo = max(0, i0 - w + 1) if w else 0
                j_hi = i_hi if causal else t - 1
                acc = torch.zeros(bt, d)
                for j0 in range(j_lo // bt * bt, j_hi + 1, bt):
                    keys = torch.arange(j0, j0 + bt)
                    kt, vt = kf[bb, j0:j0 + bt, kvh], vf[bb, j0:j0 + bt, kvh]
                    _, ds = p_ds(qt @ kt.T, dot @ vt.T, l2, de,
                                 _visible(rows, keys, t, causal, w))
                    acc += _bf16(ds) @ kt
                dq[bb, i0:i0 + bt, head] = acc * scale
    return dq[:, :t].bfloat16(), dk[:, :t].bfloat16(), dv[:, :t].bfloat16()


def _forward_stats(q, k, v, *, causal, window):
    """The forward kernel's outputs the backward reads: o (bfloat16) and
    the row log-sum-exp of the scaled logits (float32 (B, H, T))."""
    b, t, h, d = q.shape
    group = h // k.shape[2]
    pos = torch.arange(t)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() / d**0.5,
                     k.float().repeat_interleave(group, 2))
    s = torch.where(_visible(pos, pos, t, causal, window), s, -math.inf)
    o = tref.mha_blocked(q, k, v, causal=causal, window=window)
    return o, torch.logsumexp(s, dim=-1)


# (b, t, H, Hkv, D, causal, window): GQA groups 1, 2 and 4; ragged T (not
# a multiple of 64) and T below one tile; causal with and without a window
# shorter than a tile, non-causal with and without one; D 8, 64, 128, 256
EMULATION_CASES = [(1, 100, 4, 4, 64, True, None),
                   (2, 70, 4, 2, 8, True, None), (1, 130, 8, 2, 64, True, 40),
                   (1, 65, 4, 1, 128, True, 3), (1, 90, 4, 2, 64, False, None),
                   (1, 80, 4, 1, 128, False, 20), (1, 37, 2, 2, 8, True, 5),
                   (1, 70, 2, 1, 256, True, 20)]


@pytest.mark.parametrize("runs", ["one", "each head"])
@pytest.mark.parametrize("b,t,h,hkv,d,causal,window", EMULATION_CASES)
def test_sm90_backward_emulation_matches_the_references(b, t, h, hkv, d,
                                                        causal, window,
                                                        runs):
    rng = np.random.default_rng(b * 1000 + t + d)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d),
                        (b, t, h, d))]
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrays)
    o, lse = _forward_stats(q, k, v, causal=causal, window=window)
    splits = 1 if runs == "one" else h // hkv
    got = _emulate_bwd_sm90(q, k, v, do, o, lse, causal=causal,
                            window=window, splits=splits)
    plain = tref.mha_blocked_grad(q, k, v, do, causal=causal, window=window)
    want = _jax_grad(causal, window)(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays))
    for name, x, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        assert x.dtype == torch.bfloat16 and x.shape == p.shape, name
        assert _rel_err(x.float().numpy(), p.float().numpy()) <= BF16_TOL, \
            (name, "plain")
        err = _rel_err(x.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert err <= BF16_TOL, (name, "jax", err)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configured_head_dims_route_the_backward_to_sm90(arch):
    d = get_config(arch).head_dim
    assert kflash.flash_bwd_route(torch.bfloat16, d) == "sm90"
    assert kflash.flash_bwd_route(torch.float32, d) == "tf32x3"


@pytest.mark.parametrize("d,route", [(8, "sm90"), (64, "sm90"), (72, "sm90"),
                                     (128, "sm90"), (136, "sm90"),
                                     (256, "sm90"), (12, "tf32x3"),
                                     (60, "tf32x3"), (255, "tf32x3")])
def test_backward_route_rule(d, route):
    # TMA strides rows in 16 bytes: d % 8 == 0 in bfloat16, as the forward;
    # the backward takes the forward's route
    assert kflash.flash_bwd_route(torch.bfloat16, d) == route
    assert kflash.flash_route(torch.bfloat16, d) == route
    assert kflash.flash_bwd_route(torch.float32, d) == "tf32x3"


@pytest.mark.parametrize("b,t,h,hkv,d,want", [
    (2, 2048, 32, 4, 64, 4), (1, 2048, 32, 4, 64, 8),
    (1, 2048, 64, 8, 128, 2), (1, 2048, 4, 4, 64, 1), (8, 4096, 8, 8, 64, 1),
    (1, 64, 32, 4, 64, 8), (4, 2048, 64, 8, 128, 1),
    (1, 2048, 4, 1, 256, 4), (8, 2048, 8, 4, 256, 1)])
def test_runs_of_heads_fill_the_dkdv_grid(b, t, h, hkv, d, want):
    splits = kflash.bwd_sm90_splits(b, t, h, hkv, d)
    group = h // hkv
    assert splits == want and group % splits == 0
    # the fewest runs that give the dk/dv grid its blocks, or one a head
    base = b * hkv * -(-t // kflash.BWD_SM90_TILE)
    need = kflash.BWD_SM90_DKDV_BLOCKS[next(w for w in (64, 128, 256)
                                            if d <= w)]
    assert base * splits >= need or splits == group
    assert all(base * s < need for s in range(1, splits) if group % s == 0)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m, name
    return int(m.group(1))


def test_tiles_fit_the_kernel_layout():
    """The source's tile and stages against the wrapper's constants, both
    kernels' shared memory at every instantiated width within a block's
    232,448 bytes, and the grid within its limits at the largest shapes
    the wrapper lets through."""
    src = CSRC.read_text()
    tile, stages = _constant("kTile"), _constant("kStages")
    threads = _constant("kThreads")
    assert tile == kflash.BWD_SM90_TILE == 64  # one wgmma M / N
    assert threads == 128  # one warpgroup
    widths = sorted(int(w) for w in re.findall(r"launch_d<(\d+)>", src))
    assert widths == [64, 128, 256] == sorted(kflash.BWD_SM90_DKDV_BLOCKS)
    assert max(widths) == kflash.MAX_HEAD_DIM
    assert "kWarpgroups = DT > 128 ? 2 : 1" in src
    for width in widths:
        tile_bytes = tile * width * 2
        assert tile_bytes % 1024 == 0  # whole 128-byte swizzle atoms
        # K, V once, Q and dO in each stage, each stage's lse2 and delta,
        # three barriers in 64 bytes, 1024 bytes of alignment slack
        dkdv = (2 + 2 * stages) * tile_bytes + stages * 2 * tile * 4 + 64 + 1024
        # Q, dO once, K and V in each stage
        dq = (2 + 2 * stages) * tile_bytes + 64 + 1024
        assert max(dkdv, dq) <= SMEM_PER_BLOCK, (width, dkdv, dq)
        # the dk/dv block: one warpgroup to D = 128, two at 256, each
        # thread keeping 64 x 64 float32 fragments of dK and dV for two
        # boxes of 64 columns at most (128 registers)
        warpgroups = 2 if width > 128 else 1
        assert width // 64 // warpgroups <= 2
        assert threads * warpgroups <= 1024
    # grid: y = T / 64 at the longest T check_bwd_args takes, x = Hkv runs
    # (<= H <= 65535), z = B
    t_max = 65535 * kflash.BWD_BLOCK_Q
    assert -(-t_max // tile) <= 65535
    q = torch.zeros(1, t_max + 1, 1, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="backward's grid"):
        kflash.check_bwd_args(q, q, q)
