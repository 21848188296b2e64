"""The flash-attention backward on the CPU: its plain version
(``repro_torch.kernels.ref.mha_blocked_grad``) against JAX's derivative
of ``repro.kernels.ref.mha_blocked`` on the same numpy inputs, the tile
schedule of ``csrc/flash_attention_bwd.cu`` emulated in PyTorch, and the
argument checks of the differentiable op.

Tolerances, on the largest |error| of each gradient over its largest
|value|: float32 2e-5 (the packages sum in different orders); bfloat16
1e-2 (both compute in float32 and round each gradient to bfloat16, where
a different last float32 bit can move a value by one bfloat16 ulp,
2^-8 of its size). The emulation is held to 2e-5 in float32.
"""
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "flash_attention_bwd.cu")


@functools.cache
def _jax_grad(causal, window, q_offset, block_q, block_k):
    def vjp(q, k, v, do):
        _, pull = jax.vjp(lambda q, k, v: jref.mha_blocked(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            block_q=block_q, block_k=block_k), q, k, v)
        return pull(do)
    return jax.jit(vjp)


def _arrays(seed, b, tq, tk, h, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d),
                           (b, tq, h, d)))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (b, tq, tk, H, Hkv, D, causal, window, q_offset, block_q, block_k):
# GQA groups 1, 2 and 4; causal, windows and none; ragged tails of both
# blockings (tq, tk not multiples of block_q, block_k); q_offset with
# tq < tk, as a decode chunk would have (the plain version takes any)
GRAD_CASES = [
    (2, 16, 16, 4, 4, 8, True, None, 0, 512, 1024),
    (1, 37, 37, 8, 2, 16, True, None, 0, 16, 8),
    (2, 33, 33, 4, 1, 32, True, 5, 0, 8, 16),
    (1, 40, 40, 4, 2, 8, False, None, 0, 16, 16),
    (1, 29, 29, 2, 2, 12, False, 6, 0, 7, 9),
    (1, 12, 30, 4, 2, 16, True, None, 18, 5, 7),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,tq,tk,h,hkv,d,causal,window,q_offset,block_q,"
                         "block_k", GRAD_CASES)
def test_plain_backward_matches_reference(dtype, b, tq, tk, h, hkv, d, causal,
                                          window, q_offset, block_q, block_k):
    arrays = _arrays(tq + tk + d, b, tq, tk, h, hkv, d)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    want = _jax_grad(causal, window, q_offset, block_q, block_k)(*jx)
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    got = tref.mha_blocked_grad(*tx, causal=causal, window=window,
                                q_offset=q_offset, block_q=block_q,
                                block_k=block_k)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert str(g.dtype).endswith(dtype) and g.shape == w.shape, name
        err = _rel_err(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert err <= TOL[dtype], (name, err)


def _tiles(width: int) -> "tuple[int, int]":
    """(kBQ, kBK) of the backward kernels at a head-dim width, read from
    the source."""
    m = re.search(rf"struct BwdTiles<{width}> {{\s*static constexpr int "
                  rf"kBQ = (\d+), kBK = (\d+);", CSRC.read_text())
    assert m, width
    return int(m.group(1)), int(m.group(2))


def _visible(rows, keys, t, causal, window):
    r, c = rows[:, None], keys[None, :]
    ok = (r < t) & (c < t)
    if causal:
        ok &= c <= r
    if window:
        ok &= c > r - window
    return ok


def _emulate_backward(q, k, v, do, causal, window):
    """The kernels' schedule in float32: delta, then a (batch row, KV
    head, key tile) block over the group's heads and the query tiles of
    [i_lo, i_hi], then a (batch row, head, query tile) block over the key
    tiles of [j_lo, j_hi], each block summing only what it visits."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    bq, bk = _tiles(64 if d <= 64 else 128 if d <= 128 else 256)
    scale = 1.0 / d**0.5
    qs = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    pos = torch.arange(t)
    vis = _visible(pos, pos, t, causal, window)
    # the forward's output and row log-sum-exp
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf.repeat_interleave(group, 2))
    s = torch.where(vis, s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)  # (b, h, t)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                     vf.repeat_interleave(group, 2))
    delta = torch.einsum("bqhd,bqhd->bhq", dof, o)

    def pad(x, lo, n):  # rows [lo, lo + n) of (t, d), zero past t
        out = torch.zeros(n, d)
        out[:max(0, min(n, t - lo))] = x[lo:lo + n]
        return out

    def tile(bb, head, kvh, i0, j0):
        rows, keys = torch.arange(i0, i0 + bq), torch.arange(j0, j0 + bk)
        ok = _visible(rows, keys, t, causal, window)
        qt, dot = pad(qs[bb, :, head], i0, bq), pad(dof[bb, :, head], i0, bq)
        kt, vt = pad(kf[bb, :, kvh], j0, bk), pad(vf[bb, :, kvh], j0, bk)
        ls = pad(lse[bb, head][:, None], i0, bq)[:, 0]
        dl = pad(delta[bb, head][:, None], i0, bq)[:, 0]
        p = torch.where(ok, torch.exp(qt @ kt.T - ls[:, None]), 0.0)
        ds = p * (dot @ vt.T - dl[:, None])
        return p, ds, qt, dot, kt

    dq, dk, dv = torch.zeros(b, t, h, d), torch.zeros(b, t, hkv, d), \
        torch.zeros(b, t, hkv, d)
    for bb in range(b):
        for kvh in range(hkv):
            for j0 in range(0, t, bk):
                j_hi = min(j0 + bk, t) - 1
                i_lo = j0 if causal else 0
                i_hi = min(t - 1, j_hi + window - 1) if window else t - 1
                acc_k, acc_v = torch.zeros(bk, d), torch.zeros(bk, d)
                for g in range(group):
                    for i0 in range(i_lo // bq * bq, i_hi + 1, bq):
                        p, ds, qt, dot, _ = tile(bb, kvh * group + g, kvh,
                                                 i0, j0)
                        acc_v += p.T @ dot
                        acc_k += ds.T @ qt
                n = min(bk, t - j0)
                dk[bb, j0:j0 + n, kvh] = acc_k[:n]
                dv[bb, j0:j0 + n, kvh] = acc_v[:n]
        for head in range(h):
            for i0 in range(0, t, bq):
                i_hi = min(i0 + bq, t) - 1
                j_lo = max(0, i0 - window + 1) if window else 0
                j_hi = i_hi if causal else t - 1
                acc = torch.zeros(bq, d)
                for j0 in range(j_lo // bk * bk, j_hi + 1, bk):
                    _, ds, _, _, kt = tile(bb, head, head // group, i0, j0)
                    acc += ds @ kt
                n = min(bq, t - i0)
                dq[bb, i0:i0 + n, head] = acc[:n] * scale
    return dq, dk, dv


# (b, t, H, Hkv, D, causal, window): every head-dim width's tiles (D 8
# and 64, 100 and 128, 200 and 256), ragged t, windows shorter and longer
# than a tile, non-causal with and without a window, t = 2 (at t = 1
# every dq is 0 in exact arithmetic, and the error has no scale)
SCHEDULE_CASES = [(2, 100, 4, 2, 64, True, None), (1, 130, 4, 1, 8, True, 40),
                  (1, 70, 2, 2, 100, True, None), (1, 65, 4, 2, 128, True, 3),
                  (1, 45, 2, 1, 200, True, None), (1, 70, 2, 1, 256, False, 20),
                  (1, 40, 4, 4, 64, False, None), (2, 2, 2, 1, 16, True, None)]


@pytest.mark.parametrize("b,t,h,hkv,d,causal,window", SCHEDULE_CASES)
def test_kernel_schedule_emulation_matches_plain(b, t, h, hkv, d, causal,
                                                 window):
    g = torch.Generator().manual_seed(t + d)
    q, do = (torch.randn(b, t, h, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, t, hkv, d, generator=g) for _ in range(2))
    got = _emulate_backward(q, k, v, do, causal, window)
    want = tref.mha_blocked_grad(q, k, v, do, causal=causal, window=window)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(x.numpy(), w.numpy()) <= 2e-5, name


def test_tiles_fit_the_kernel_layout():
    """Each width's tiles fit the 16 x 16 thread layout (2 or 4 values a
    thread each way), the wrapper's grid limit and shared memory."""
    for width in (64, 128, 256):
        bq, bk = _tiles(width)
        assert bq // 16 in (2, 4) and bk // 16 in (2, 4) and bq % 16 == 0
        assert bq >= kflash.BWD_BLOCK_Q
        pad = 4
        dkdv = 4 * (2 * width * (bk + pad) + 2 * width * (bq + pad)
                    + 2 * bq * width + 2 * bq * bk + 2 * bq)
        dq = 4 * (2 * width * (bq + pad) + 2 * width * (bk + pad)
                  + bk * width + bk * bq + 2 * bq)
        assert max(dkdv, dq) <= 232448, (width, dkdv, dq)
    assert kflash.BWD_BLOCK_Q == min(_tiles(w)[0] for w in (64, 128, 256))


def test_cpu_gradient_goes_through_the_plain_version():
    g = torch.Generator().manual_seed(3)
    q, do = (torch.randn(1, 20, 4, 16, generator=g) for _ in range(2))
    k, v = (torch.randn(1, 20, 2, 16, generator=g) for _ in range(2))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_attention(*leaves, window=5)
    got = torch.autograd.grad(out, leaves, do)
    want = tref.mha_blocked_grad(q, k, v, do, window=5)
    for x, w in zip(got, want):
        assert torch.equal(x, w)
    assert ops.launch_counts()["flash_attention_bwd"] == 0


def test_differentiable_op_refuses_what_the_backward_cannot_take():
    q = torch.randn(1, 8, 4, 64, requires_grad=True)
    kv = torch.randn(1, 8, 2, 64)
    with pytest.raises(ValueError, match="self-attention only"):
        kflash.check_bwd_args(q, kv, kv, q_offset=2)
    with pytest.raises(ValueError, match="self-attention only"):
        kv5 = torch.randn(1, 5, 2, 64)
        kflash.check_bwd_args(q, kv5, kv5)
    assert kflash.check_bwd_args(q.bfloat16(), kv.bfloat16(),
                                 kv.bfloat16()) == "sm90"
    # forcing the kernel without a card raises; nothing falls back
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        ops.flash_attention(q, kv, kv, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        kflash.flash_attention_grad_cuda(q, kv, kv)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        kflash.flash_attention_bwd_cuda(q.detach(), kv, kv, q.detach(),
                                        q.detach(), lse)
    assert ops.get_impl("flash_attention", "ref", q, grad=True) is \
        tref.mha_blocked
