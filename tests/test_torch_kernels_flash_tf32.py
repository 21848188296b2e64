"""The tf32x3 flash-attention kernel's arithmetic, rehearsed on the host
(the kernel itself runs only on a Hopper card:
tests/test_torch_kernels_cuda.py).

``csrc/flash_attention.cu`` computes float32 attention on the tensor
cores with ``mma.sync`` m16n8k8 TF32 products, each float32 operand split
into two TF32 halves (3xTF32). This file emulates what it computes:

* the TF32 rounding (``cvt.rna``'s rule, done on the bits) and the split
  a = big + small;
* the A, B and C fragment index maps of the PTX ISA against the
  kernel's loads, with the permuted k order of Q K^T and the key order
  that makes S's C fragment P's A fragment for P V;
* the kernel's tiles (pinned to the source), key-tile order, skipped
  tiles, masks, online softmax, the per-tile sum of P V and the closed
  form of rows that see no key;
* the tensor cores' float32 sums, modelled as rounded toward zero, and
  the kernel's separate sums of the small halves' products in Q K^T;

and holds the emulation to ``repro.kernels.ref.mha_blocked`` (under
``jax.jit``) in float32 within a fifth of the op's 2e-5 tolerance, while
the same emulation with one TF32 product misses the tolerance, and
without per-tile sums misses the rehearsal's at 16384 keys.
"""
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as kflash

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

SRC = (pathlib.Path(kflash.__file__).resolve().parent / "csrc"
       / "flash_attention.cu").read_text()
F32_TOL = 2e-5
REHEARSAL_TOL = F32_TOL / 5
_LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
_MASK = torch.tensor(-2.0**30, dtype=torch.float32)
_JREF = jax.jit(jref.mha_blocked, static_argnames=(
    "causal", "window", "q_offset", "block_q", "block_k"))
SMEM_PER_BLOCK = 232448  # bytes a block can use on an H100
# the A column (and B row) of an 8-wide k step -> the dim or key it
# holds: columns t and t + 4 are 2t and 2t + 1
PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def _tiles(width: int) -> tuple:
    """The source's Tiles<width>: (warps, 16-row m-tiles a warp, keys per
    tile)."""
    body = re.search(rf"struct Tiles<{width}> {{\s*static constexpr int "
                     rf"kWarps = (\d+), kM = (\d+), kBK = (\d+);", SRC)
    return tuple(int(x) for x in body.groups())


# head-dim width -> (warps, 16-row m-tiles a warp, keys per tile)
TILES = {w: _tiles(w) for w in (64, 128, 256)}


def qk_stride(dp: int) -> int:
    return dp + ((8 - dp) & 31)


def v_stride(dp: int) -> int:
    return dp + ((4 - dp) & 15)


def test_tile_constants_match_the_source():
    assert "int qk_stride(int dp) { return dp + ((8 - dp) & 31); }" in SRC
    assert "int v_stride(int dp) { return dp + ((4 - dp) & 15); }" in SRC
    assert "constexpr int kBQ = kWarps * 16 * kM;" in SRC
    assert "constexpr float kMask = -1073741824.0f;" in SRC
    # the key tiles a warp skips (emulated in ``emulate``)
    for line in ("const int w_lo = q_offset + i0 + w0, w_hi = w_lo + 16 * kM - 1;",
                 "const int w_first = window > 0 ? max(0, w_lo - window + 1) : 0;",
                 "const int w_last = causal ? min(tk - 1, w_hi) : tk - 1;",
                 "if (k0 <= w_last && k0 + BK - 1 >= w_first) {"):
        assert line in SRC, line
    for width, (warps, mt, bk) in TILES.items():
        assert warps in (4, 8) and mt in (1, 2) and bk in (16, 32, 64)
        # the q tile and two K and two V stages fit a block's shared memory
        smem = 4 * ((16 * warps * mt + 2 * bk) * qk_stride(width)
                    + 2 * bk * v_stride(width))
        assert smem <= SMEM_PER_BLOCK, (width, smem)
    # the wrapper's grid check uses the smallest q tile
    assert kflash.TF32X3_BLOCK_Q == min(16 * w * mt
                                        for w, mt, _ in TILES.values())


@pytest.mark.parametrize("dp", range(8, 257, 8))
def test_fragment_loads_are_free_of_bank_conflicts(dp):
    g, t = np.arange(32) // 4, np.arange(32) % 4
    sqk, sv = qk_stride(dp), v_stride(dp)
    assert sqk % 32 == 8 and sv % 4 == 0  # 8- and 16-byte aligned rows
    # Q and K: 8-byte loads of (row g, columns 2t, 2t + 1), half a warp a phase
    for half in (slice(0, 16), slice(16, 32)):
        words = np.concatenate([g[half] * sqk + 2 * t[half],
                                g[half] * sqk + 2 * t[half] + 1])
        assert len(set(words % 32)) == 32
    # V: 4-byte loads of (rows 2t and 2t + 1, column g)
    for r in (0, 1):
        assert len(set(((2 * t + r) * sv + g) % 32)) == 32


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (float32 with 13 low bits zero), to nearest with
    ties away from zero: (bits + 0x1000) & 0xffffe000."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _split(x: torch.Tensor):
    """x = big + small: big = tf32(x), small = x - big as an mma.sync TF32
    operand reads it (its top 19 bits: truncated to TF32)."""
    big = _tf32(x)
    small = (x - big).contiguous().view(torch.int32) & -0x2000
    return big, small.view(torch.float32)


def test_tf32_rounding_is_cvt_rna():
    assert "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in SRC
    assert "small = __float_as_uint(x - __uint_as_float(big));" in SRC
    tie = 1.0 + 2.0**-11  # halfway between two TF32 values: away from zero
    x = torch.tensor([tie, -tie, 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-12,
                      3.0e38, float("inf"), 0.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0,
                         1.0 + 2.0**-10, _tf32(torch.tensor([3.0e38])).item(),
                         float("inf"), 0.0], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.integers(-20, 20, 100_000))
                         .astype(np.float32))
    big, small = _split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert (x - big).abs().le(2.0**-11 * x.abs()).all()
    # big + small recovers x to 2^-21 of it (small keeps 11 bits of x - big,
    # which is at most 2^-11 of x)
    err = (x.double() - big.double() - small.double()).abs()
    assert err.le(2.0**-21 * x.double().abs()).all()


# PTX ISA, mma.m16n8k8 with .tf32 operands: register i of lane 4g + t
def _ptx_a(i, g, t):
    return g + 8 * (i % 2), t + 4 * (i // 2)


def _ptx_b(i, g, t):
    return t + 4 * i, g


def _ptx_c(i, g, t):
    return g + 8 * (i // 2), 2 * t + i % 2


def _mma_ptx(a_regs, b_regs):
    """One warp's m16n8k8 product from its lanes' registers, as the PTX
    ISA places them: a_regs (32, 4), b_regs (32, 2) -> c_regs (32, 4)."""
    a = torch.full((16, 8), math.nan, dtype=torch.float64)
    b = torch.full((8, 8), math.nan, dtype=torch.float64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i in range(4):
            a[_ptx_a(i, g, t)] = a_regs[lane, i]
        for i in range(2):
            b[_ptx_b(i, g, t)] = b_regs[lane, i]
    assert not (a.isnan().any() or b.isnan().any())  # every element once
    c = a @ b
    return torch.tensor([[c[_ptx_c(i, *divmod(lane, 4))] for i in range(4)]
                         for lane in range(32)], dtype=torch.float64)


def test_fragment_maps_compose_to_the_products():
    # the kernel's register choices, pinned to the source
    for line in ("split(x0.x, ab[mt][0], as[mt][0]);  // a0: row g, dim 2t",
                 "split(x1.x, ab[mt][1], as[mt][1]);  // a1: row g + 8, dim 2t",
                 "split(x0.y, ab[mt][2], as[mt][2]);  // a2: row g, dim 2t + 1",
                 "split(x1.y, ab[mt][3], as[mt][3]);  // a3: row g + 8, dim 2t + 1",
                 "split(s[mt][c][0], pb[mt][c][0], ps[mt][c][0]);  // a0: row g, key 2t",
                 "split(s[mt][c][2], pb[mt][c][1], ps[mt][c][1]);  // a1: row g + 8, key 2t",
                 "split(s[mt][c][1], pb[mt][c][2], ps[mt][c][2]);  // a2: row g, key 2t + 1",
                 "split(s[mt][c][3], pb[mt][c][3], ps[mt][c][3]);  // a3: row g + 8, key 2t + 1",
                 "const float* vb = vst + 2 * t4 * sv + g;",
                 "halves<kExactKV>(vb[8 * c * sv + 8 * nn], bb[0], bs[0]);",
                 "halves<kExactKV>(vb[(8 * c + 1) * sv + 8 * nn], bb[1], bs[1]);",
                 "acc[mt][n][0] = fmaf(acc[mt][n][0], alpha[mt][0], pv[mt][0]);",
                 "acc[mt][n][3] = fmaf(acc[mt][n][3], alpha[mt][1], pv[mt][3]);",
                 "const float* qa = qs + (w0 + g) * sqk + 2 * t4;",
                 "const float* kb = kst + g * sqk + 2 * t4;",
                 "halves<kExactKV>(y.x, bb[0], bs[0]);",
                 "mma(sc[mt][j], as[mt], bb);",
                 "if constexpr (!kExactKV) mma(sc[mt][j], ab[mt], bs);",
                 "mma(s[mt][j], ab[mt], bb);",
                 "for (int e = 0; e < 4; ++e) s[mt][j][e] += sc[mt][j][e];",
                 "halves<kExactKV>(y.y, bb[1], bs[1]);"):
        assert line in SRC, line
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(-9, 9, (16, 8))).double()
    k = torch.from_numpy(rng.integers(-9, 9, (8, 8))).double()  # keys x dims
    v = torch.from_numpy(rng.integers(-9, 9, (8, 8))).double()  # keys x dims
    lanes = [divmod(lane, 4) for lane in range(32)]
    # S = Q K^T: a_i = Q[g + 8 (i % 2)][2t + i // 2], b_i = K[g][2t + i];
    # s_e is (row g + 8 (e // 2), key 2t + e % 2)
    s = _mma_ptx(
        torch.tensor([[q[g + 8 * (i % 2), 2 * t + i // 2] for i in range(4)]
                      for g, t in lanes]),
        torch.tensor([[k[g, 2 * t + i] for i in range(2)] for g, t in lanes]))
    want = q @ k.T
    assert torch.equal(s, torch.tensor(
        [[want[g + 8 * (e // 2), 2 * t + e % 2] for e in range(4)]
         for g, t in lanes], dtype=torch.float64))
    # O = P V with P taken from S's C fragment without a shuffle: a0 = s0,
    # a1 = s2, a2 = s1, a3 = s3; b_i = V[2t + i][g]
    p = torch.from_numpy(rng.integers(-9, 9, (16, 8))).double()
    p_c = torch.tensor([[p[g + 8 * (e // 2), 2 * t + e % 2] for e in range(4)]
                        for g, t in lanes], dtype=torch.float64)
    o = _mma_ptx(p_c[:, [0, 2, 1, 3]],
                 torch.tensor([[v[2 * t + i, g] for i in range(2)]
                               for g, t in lanes]))
    want = p @ v
    assert torch.equal(o, torch.tensor(
        [[want[g + 8 * (e // 2), 2 * t + e % 2] for e in range(4)]
         for g, t in lanes], dtype=torch.float64))
    # both k orders are PERM: A column c holds dim (key) PERM[c]
    assert [2 * (c % 4) + c // 4 for c in range(8)] == PERM.tolist()


def _mma(c, a, b):
    """c + a b^T as one mma.sync adds it: a (..., M, 8), b (..., N, 8)
    TF32 values in float32; each product exact, the 8-term sum added to
    the float32 accumulator and rounded once, toward zero (the tensor
    cores' float32 sums do not round to nearest)."""
    exact = c.double() + a.double() @ b.double().transpose(-1, -2)
    near = exact.float()
    return torch.where(near.double().abs() > exact.abs(),
                       torch.nextafter(near, torch.zeros_like(near)), near)


def _step(c, a, b, products):
    """One 8-wide k step of 3xTF32 in the kernel's order of P V: c +=
    a_small b_big, c += a_big b_small, c += a_big b_big; products = 1
    keeps only the last."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    if products == 3:
        c = _mma(_mma(c, as_, bb), ab, bs)
    return _mma(c, ab, bb)


def emulate(q, k, v, *, causal, window, q_offset, block_k, products=3,
            tile_sums=True):
    """What the tf32x3 kernel computes, in plain PyTorch on the host: q, k,
    v float32 (B, T, H, D); returns float32 (B, Tq, H, D). tile_sums=False
    adds P V into the running O on the tensor cores instead of summing
    each key tile apart."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    width = 64 if d <= 64 else 128 if d <= 128 else 256
    warps, mt, bk = TILES[width]
    bq = 16 * warps * mt
    dp = -(-d // 8) * 8
    w = window if window is not None and window > 0 else 0
    scale = torch.tensor(1.0 / d**0.5, dtype=torch.float32)
    bkc = min(block_k, tk)
    empty_denom = float(math.ceil(tk / bkc) * bkc)
    kvh = torch.arange(h) // (h // hkv)
    tkp = -(-tk // bk) * bk
    out = torch.zeros(b, tq, h, d)
    for bb in range(b):
        # (H, keys, dp): each q head's KV head, zero past tk and d
        kf = torch.zeros(h, tkp, dp)
        vf = torch.zeros(h, tkp, dp)
        kf[:, :tk, :d] = k[bb][:, kvh].permute(1, 0, 2)
        vf[:, :tk, :d] = v[bb][:, kvh].permute(1, 0, 2)
        vsum = vf[:, :tk].sum(dim=1)
        for i0 in range(0, tq, bq):
            n = min(bq, tq - i0)
            qt = torch.zeros(h, n, dp)
            qt[..., :d] = q[bb, i0:i0 + n].permute(1, 0, 2) * scale
            qpos = q_offset + i0 + torch.arange(n)
            # the keys each row's warp (16 mt rows) sees: [w_first, w_last]
            w_lo = q_offset + i0 + torch.arange(n) // (16 * mt) * (16 * mt)
            w_first = (w_lo - w + 1).clamp(min=0) if w else torch.zeros_like(w_lo)
            w_last = ((w_lo + 16 * mt - 1).clamp(max=tk - 1) if causal
                      else torch.full_like(w_lo, tk - 1))
            q_lo, q_hi = q_offset + i0, q_offset + i0 + n - 1
            b_lo = max(0, q_lo - w + 1) if w else 0
            b_hi = min(tk - 1, q_hi) if causal else tk - 1
            m = torch.full((h, n), -math.inf)
            l = torch.zeros(h, n)
            acc = torch.zeros(h, n, dp)
            tiles = range(b_lo // bk, b_hi // bk + 1) if b_hi >= b_lo else ()
            for t in tiles:
                k0 = t * bk
                kt, vt = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
                # the big product sums in s, the small halves' in sc
                s, sc = torch.zeros(h, n, bk), torch.zeros(h, n, bk)
                for kk in range(0, dp, 8):
                    cols = kk + PERM
                    q_big, q_small = _split(qt[..., cols])
                    k_big, k_small = _split(kt[..., cols])
                    if products == 3:
                        sc = _mma(_mma(sc, q_small, k_big), q_big, k_small)
                    s = _mma(s, q_big, k_big)
                s = s + sc
                key = k0 + torch.arange(bk)
                ok = (key < tk)[None, :].expand(n, bk)
                if causal:
                    ok = ok & (key[None, :] <= qpos[:, None])
                if w:
                    ok = ok & (key[None, :] > qpos[:, None] - w)
                s = torch.where(ok, s, _MASK)
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp2((m - m_new) * _LOG2E)
                p = torch.exp2((s - m_new[..., None]) * _LOG2E)
                l_new = l * alpha + p.sum(dim=-1)
                # the tile's P V on the tensor cores, then O = alpha O + it
                # in one float32 fma
                pv = torch.zeros(h, n, dp) if tile_sums else acc * alpha[..., None]
                for c in range(bk // 8):
                    keys = 8 * c + PERM
                    pv = _step(pv, p[..., keys], vt[:, keys].transpose(-1, -2),
                               products)
                acc_new = ((acc.double() * alpha[..., None].double()
                            + pv.double()).float() if tile_sums else pv)
                # a warp skips a tile that none of its rows sees
                seen = (k0 <= w_last) & (k0 + bk - 1 >= w_first)
                m = torch.where(seen, m_new, m)
                l = torch.where(seen, l_new, l)
                acc = torch.where(seen[:, None], acc_new, acc)
            lo = (qpos - w + 1).clamp(min=0) if w else torch.zeros_like(qpos)
            hi = qpos.clamp(max=tk - 1) if causal else torch.full_like(qpos, tk - 1)
            empty = lo > hi
            acc[:, empty] = vsum[:, None, :]
            l[:, empty] = empty_denom
            o = acc / l.clamp(min=1e-30)[..., None]
            out[bb, i0:i0 + n] = o[..., :d].permute(1, 0, 2)
    return out


# (tq, tk, H, Hkv, D, causal, window, q_offset, block_k): D 8, 12, 64,
# 128, 256; several q and key tiles with ragged ends, GQA groups 8 and 1,
# windows, q_offset, non-causal, and rows that see no key
REHEARSAL_CASES = [
    (300, 300, 8, 1, 64, True, None, 0, 1024),
    (130, 130, 2, 2, 128, True, None, 0, 1024),
    (200, 200, 4, 1, 256, True, 48, 0, 1024),
    (192, 320, 2, 1, 256, True, 128, 128, 1024),
    (100, 100, 4, 2, 12, True, None, 0, 1024),
    (90, 77, 2, 1, 12, True, 20, 10, 1024),
    (48, 200, 4, 2, 64, False, 16, 70, 32),
    (70, 150, 2, 1, 128, False, None, 0, 1024),
    (4, 8, 1, 1, 8, True, 2, 20, 4),
    (64, 200, 8, 2, 64, True, 16, 300, 64),
    (100, 100, 4, 4, 8, True, 1, 0, 1024),
]


def _case(tq, tk, h, hkv, d, causal, window, q_offset, block_k):
    rng = np.random.default_rng(tq * 7 + tk + d)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, tq, h, d), (1, tk, hkv, d), (1, tk, hkv, d))]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = np.asarray(_JREF(*(jnp.asarray(a) for a in arrays),
                            block_k=block_k, **kw))
    return [torch.from_numpy(a) for a in arrays], dict(kw, block_k=block_k), want


@pytest.mark.parametrize("tq,tk,h,hkv,d,causal,window,q_offset,block_k",
                         REHEARSAL_CASES)
def test_tf32x3_arithmetic_matches_the_reference_in_f32(tq, tk, h, hkv, d,
                                                        causal, window,
                                                        q_offset, block_k):
    (q, k, v), kw, want = _case(tq, tk, h, hkv, d, causal, window, q_offset,
                                block_k)
    got = emulate(q, k, v, **kw)
    assert got.dtype == torch.float32 and got.shape == (1, tq, h, d)
    err = np.abs(got.numpy() - want).max()
    assert err <= REHEARSAL_TOL, err


# rows that see 4096 and 8192 keys: one q tile at the end of a long
# causal context, at each width
LONG_ROW_CASES = [(64, 4096, 2, 1, 64, True, None, 4032, 1024),
                  (32, 8192, 2, 1, 128, True, None, 8160, 1024),
                  (16, 8192, 1, 1, 256, True, None, 8176, 1024),
                  (32, 32768, 1, 1, 64, True, None, 32736, 1024)]


@pytest.mark.parametrize("case", LONG_ROW_CASES)
def test_long_rows_match_the_reference_in_f32(case):
    (q, k, v), kw, want = _case(*case)
    err = np.abs(emulate(q, k, v, **kw).numpy() - want).max()
    assert err <= REHEARSAL_TOL, err


def test_tile_sums_bound_the_tensor_cores_rounding():
    # P V added into the running O on the tensor cores rounds toward zero
    # once per 8 keys, over all of a row's keys; summed per key tile and
    # added in float32, it stays two orders under the rehearsal tolerance
    (q, k, v), kw, want = _case(32, 16384, 2, 1, 64, True, None, 16352, 1024)
    err_tiles = np.abs(emulate(q, k, v, **kw).numpy() - want).max()
    err_running = np.abs(emulate(q, k, v, tile_sums=False, **kw).numpy()
                         - want).max()
    assert err_running > REHEARSAL_TOL > 10 * err_tiles, (err_running,
                                                          err_tiles)


def test_one_tf32_product_misses_the_tolerance():
    (q, k, v), kw, want = _case(130, 130, 2, 2, 128, True, None, 0, 1024)
    err1 = np.abs(emulate(q, k, v, products=1, **kw).numpy() - want).max()
    err3 = np.abs(emulate(q, k, v, **kw).numpy() - want).max()
    assert err1 > F32_TOL > REHEARSAL_TOL >= err3, (err1, err3)
