"""The tf32x3 flash-attention backward's arithmetic, rehearsed on the host
(the kernels themselves run only on a Hopper card:
tests/test_torch_kernels_cuda.py).

``csrc/flash_attention_bwd.cu`` computes the gradients of float32 (and
bfloat16 head dims that are not a multiple of 8) attention on the tensor
cores with ``mma.sync`` m16n8k8 TF32 products, each float32 operand split
into two TF32 halves (3xTF32), on the sm90 backward's schedule. This file
emulates what it computes:

* the tiles, strides and fragment orders, pinned to the source;
* the dk/dv kernel's split of S^T and dP^T over the dims at D = 128 and
  256 (each warp of a key slice sums its part, the parts added in order);
* the C fragments of S^T, dP^T (dk/dv kernel) and dS (dq kernel) reused as
  A fragments of the next products, with the rows of each 8-row group in
  the kernel's order perm8(j) = j ^ (j >> 2), checked against the PTX
  ISA's fragment maps, and the row strides free of bank conflicts in both
  of the patterns they are read in;
* the TF32 rounding and split (the helpers of
  ``tests/test_torch_kernels_flash_tf32.py``), the small halves' products
  summed apart in every product, the tensor cores' float32 sums rounded
  toward zero, each query step's dV and dK and each key step's dQ summed
  in zeroed fragments and added in float32, and the runs of heads'
  partials added in run order;

and holds the emulation to ``jax.vjp`` of ``repro.kernels.ref.mha_blocked``
(under ``jax.jit``) on the same numpy inputs: float32 within 2e-5 of each
gradient's largest |value| (a fifth of the card's 1e-4), bfloat16 at d % 8
!= 0 within 2e-2. bfloat16 q, k, v and dO are exact in TF32, so there every
product is one mma and P and dS are rounded to TF32 once: the rehearsal
shows that moves no gradient by more than one bfloat16 ulp of its largest
|value| (2^-7 of it) from the same arithmetic with P and dS split into
three products. Negative controls: with one TF32
product the float32 emulation misses 1e-4, and at T = 4096, where key 0
sums over every row, running sums on the tensor cores without the per-tile
sums miss 2e-5.
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
from test_torch_kernels_flash_tf32 import _mma, _mma_ptx, _split, _tf32

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

SRC = (pathlib.Path(kflash.__file__).resolve().parent / "csrc"
       / "flash_attention_bwd.cu").read_text()
F32_TOL = 1e-4           # the card's check of the float32 backward
REHEARSAL_TOL = 2e-5     # the emulation's, float32
BF16_TOL = 2e-2
SMEM_PER_BLOCK = 232448  # bytes a block can use on an H100
_LOG2E = 1.4426950408889634


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, name
    return int(m.group(1))


def _tiles(width: int) -> tuple:
    """The source's BwdTiles<width>: (dk/dv warps, warps sharing a key
    slice, dk/dv query rows a step, keys a dk/dv tile, dk/dv blocks its
    launch bounds ask for, dq key rows a step)."""
    m = re.search(rf"struct BwdTiles<{width}> {{\s*static constexpr int "
                  rf"kKvWarps = (\d+), kSplitD = (\d+), kBQ = (\d+), "
                  rf"kBK = (\d+), kMinBlocks = (\d+), kBKq = (\d+);", SRC)
    assert m, width
    return tuple(int(x) for x in m.groups())


TILES = {w: _tiles(w) for w in (64, 128, 256)}
DQ_ROWS = _constant("kDqRows")


def qk_stride(dp: int) -> int:
    return dp + ((8 - dp) & 31)


def perm8(j):
    return j ^ (j >> 2)


def test_tiles_match_the_source_and_fit_a_block():
    assert "int qk_stride(int dp) { return dp + ((8 - dp) & 31); }" in SRC
    assert "int perm8(int j) { return j ^ (j >> 2); }" in SRC
    assert "constexpr int kQWarps = kDqRows / 16;" in SRC
    assert ("__launch_bounds__(BwdTiles<DMAX>::kKvWarps * 32, "
            "BwdTiles<DMAX>::kMinBlocks)") in SRC
    assert DQ_ROWS == 64 and kflash.BWD_TF32X3_TILE == {
        w: bk for w, (_, _, _, bk, _, _) in TILES.items()}
    # the grid check takes the smallest tile of either route
    assert kflash.BWD_BLOCK_Q == min(DQ_ROWS, kflash.BWD_SM90_TILE,
                                     *kflash.BWD_TF32X3_TILE.values()) == 32
    widths = sorted(int(w) for w in re.findall(r"launch_a<T, (\d+)>", SRC))
    assert widths == [64, 128, 256] == sorted(kflash.BWD_TF32X3_DKDV_BLOCKS)
    assert max(widths) == kflash.MAX_HEAD_DIM
    for width, (kv_warps, split_d, bq, bk, min_blocks, bkq) in TILES.items():
        # a warp owns 16 keys and 64 columns of dK and dV (64 float32
        # accumulators a lane); the steps are whole k-steps of 8
        assert 16 * kv_warps // split_d == bk and width // split_d == 64
        assert bq % 8 == 0 and bkq % 8 == 0 and kv_warps * 32 <= 1024
        sqk = qk_stride(width)
        # K, V; two stages of Q, dO and the statistics; the partial sums
        # traded by the warps of a key slice
        dkdv = 4 * (2 * bk * sqk + 4 * bq * sqk + 4 * bq
                    + (kv_warps * bq * 32 if split_d > 1 else 0))
        dq = 4 * (2 * DQ_ROWS * sqk + 4 * bkq * sqk)
        assert max(dkdv, dq) <= SMEM_PER_BLOCK, (width, dkdv, dq)
        # the launch bounds' resident blocks fit the shared memory
        assert min_blocks * dkdv <= 228 * 1024
        # every dp of the width takes a stride no larger than the width's
        assert max(qk_stride(dp) for dp in range(8, width + 1, 8)) == sqk
        # the dq warp's float32 dQ fragments take at most 128 registers a
        # lane, its split dS at most 32
        assert width // 2 <= 128 and bkq <= 32


@pytest.mark.parametrize("dp", range(8, 257, 8))
def test_row_strides_are_free_of_bank_conflicts(dp):
    g, t = np.arange(32) // 4, np.arange(32) % 4
    s = qk_stride(dp)
    assert s % 32 == 8  # 8-byte aligned rows, 16-byte aligned for cp.async
    # A: 8-byte loads of rows g (and g + 8), columns 2t, 2t + 1; B of the
    # products over dims: rows perm8(g) likewise; half a warp a phase
    for rows in (g, perm8(g)):
        for half in (slice(0, 16), slice(16, 32)):
            words = np.concatenate([rows[half] * s + 2 * t[half],
                                    rows[half] * s + 2 * t[half] + 1])
            assert len(set(words % 32)) == 32
    # B of dV, dK and dQ: 4-byte loads of rows perm8(2t + r), column g
    for r in (0, 1):
        assert len(set((perm8(2 * t + r) * s + g) % 32)) == 32
    # without the row order the 4-byte loads of rows 2t + r meet in pairs
    assert len(set(((2 * t) * s + g) % 32)) == 16


def test_fragment_maps_compose_to_the_products():
    # the kernel's register choices, pinned to the source
    for line in (
            "halves<kSplit>(x0.x, ab[0], as[0]);  // a0: row g, dim 2t",
            "halves<kSplit>(x1.x, ab[1], as[1]);  // a1: row g + 8, dim 2t",
            "halves<kSplit>(x0.y, ab[2], as[2]);  // a2: row g, dim 2t + 1",
            "halves<kSplit>(x1.y, ab[3], as[3]);  // a3: row g + 8, dim 2t + 1",
            "const float2 y = *reinterpret_cast<const float2*>(b + 8 * j * stride + kk);",
            "halves<kSplit>(c[j][0], big[j][0], small[j][0]);  // a0: row g, column 2t",
            "halves<kSplit>(c[j][2], big[j][1], small[j][1]);  // a1: row g + 8, column 2t",
            "halves<kSplit>(c[j][1], big[j][2], small[j][2]);  // a2: row g, column 2t + 1",
            "halves<kSplit>(c[j][3], big[j][3], small[j][3]);  // a3: row g + 8, column 2t + 1",
            "const int brow = perm8(g) * sq + 2 * t4 + d0;",
            "const int arow = (16 * kw + g) * sq + 2 * t4 + d0;",
            "const int brow = perm8(g) * sq + 2 * t4;",
            "const int arow = r0 * sq + 2 * t4;",
            "const int qc = perm8(2 * t4);",
            "const int kc = perm8(2 * t4);",
            "const int col = 8 * j + (qc ^ (e & 1));",
            "k0 + 8 * c + (kc ^ (e & 1))",
            "accumulate<kNQ, kNT, kSplit>(dv_acc, ab, as, dost + qc * sq + cb + g, other, sq, cb, dpo);",
            "accumulate<kNQ, kNT, kSplit>(dk_acc, ab, as, qst + qc * sq + cb + g, other, sq, cb, dpo);",
            "accumulate<kNK, kNT, kSplit>(acc, ab, as, kst + kc * sq + g, (kc ^ 1) * sq - kc * sq, sq, 0,",
            "const int other = (qc ^ 1) * sq - qc * sq;",
            "halves<kSplit>(b[at], bb[0], bs[0]);",
            "halves<kSplit>(b[at + other], bb[1], bs[1]);",
            "const int at = 8 * k * stride + 8 * nn;"):
        assert line in SRC, line
    # perm8(2t + 1) is perm8(2t) ^ 1: b1's row is b0's ^ 1
    assert all(perm8(2 * t + 1) == perm8(2 * t) ^ 1 for t in range(4))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-9, 9, (16, 8))).double()  # rows x dims
    y = torch.from_numpy(rng.integers(-9, 9, (8, 8))).double()   # 8 rows x dims
    z = torch.from_numpy(rng.integers(-9, 9, (8, 8))).double()   # the same rows x columns
    lanes = [divmod(lane, 4) for lane in range(32)]
    # the first product: a_i = X[g + 8 (i % 2)][2t + i // 2] (dims in the
    # permuted k order), b_i = Y[perm8(g)][2t + i]; C column 2t + e holds
    # row perm8(2t + e) of Y
    c = _mma_ptx(
        torch.tensor([[x[g + 8 * (i % 2), 2 * t + i // 2] for i in range(4)]
                      for g, t in lanes]),
        torch.tensor([[y[perm8(g), 2 * t + i] for i in range(2)]
                      for g, t in lanes]))
    want = x @ y.T
    assert torch.equal(c, torch.tensor(
        [[want[g + 8 * (e // 2), perm8(2 * t + e % 2)] for e in range(4)]
         for g, t in lanes], dtype=torch.float64))
    # the next product over those 8 rows: A from the C registers (a0 = c0,
    # a1 = c2, a2 = c1, a3 = c3), b_i = Z[perm8(2t + i)][g]
    p = torch.from_numpy(rng.integers(-9, 9, (16, 8))).double()  # rows x the 8 rows
    p_c = torch.tensor([[p[g + 8 * (e // 2), perm8(2 * t + e % 2)]
                         for e in range(4)] for g, t in lanes],
                       dtype=torch.float64)
    o = _mma_ptx(p_c[:, [0, 2, 1, 3]],
                 torch.tensor([[z[perm8(2 * t + i), g] for i in range(2)]
                               for g, t in lanes]))
    want = p @ z
    assert torch.equal(o, torch.tensor(
        [[want[g + 8 * (e // 2), 2 * t + e % 2] for e in range(4)]
         for g, t in lanes], dtype=torch.float64))


def test_mma_orders_and_sums_match_the_source():
    for line in (
            "big = tf32_rna(x);",
            "small = kSplit ? __float_as_uint(x - __uint_as_float(big)) : 0u;",
            "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
            # dot_rows and accumulate: a_small b_big, a_big b_small into the
            # small halves' fragment, a_big b_big into the big one, joined at
            # the end
            "        mma(cs[j], as, bb);\n        mma(cs[j], ab, bs);\n      }\n"
            "      mma(c[j], ab, bb);",
            "for (int e = 0; e < 4; ++e) c[j][e] += cs[j][e];",
            "        mma(cs, as[k], bb);\n        mma(cs, ab[k], bs);\n      }\n"
            "      mma(c, ab[k], bb);",
            # per-step sums added in float32
            "for (int e = 0; e < 4; ++e) acc[n][e] += c[e] + cs[e];",
            # the dims' partial sums of S^T and dP^T, traded and added in
            # order of the dims
            "const int part = ((dpo >> 3) + L::kSplitD - 1) / L::kSplitD * 8;",
            "const int d0 = min(dpo, cw * part), nd = min(dpo, d0 + part) - d0;",
            "mine[(4 * j + e) * 32] = s[j][e];",
            'asm volatile("bar.sync %0, %1;\\n" ::"r"(1 + kw), "r"(32 * L::kSplitD) : "memory");',
            "const float* theirs = xs + (c * kKeyWarps + kw) * 8 * kNQ * 32 + lane;",
            "s[j][e] += theirs[(4 * j + e) * 32];",
            "float p = fast_exp2(fmaf(s[j][e], scale_log2, -ls[col]));",
            "dpt[j][e] = p * (dpt[j][e] - dl[col]);",
            "float p = fast_exp2(fmaf(s[c][e], scale_log2, -l2[ri]));",
            "dpv[c][e] = p * (dpv[c][e] - de[ri]);",
            "stat[2 * s * BQ + r] = in ? lse[row + r] * kLog2e : 0.0f;",
            "const float gk = dk_acc[n2][2 * ri + e] * scale, gv = dv_acc[n2][2 * ri + e];",
            "if (col < d) out[col] = from_f32<T>(acc[n][2 * ri + e] * scale);",
            # the runs' partials in run order
            "sk += dk_part[s * n + i];",
            "constexpr bool kSplit = std::is_same<T, float>::value;"):
        assert line in SRC, line
    # no atomics (CUDA's atomic*() or PTX red./atom.): a second call
    # repeats bit for bit
    assert not re.search(r"\batomic[A-Z]\w*\s*\(|\b(red|atom)\.", SRC)


def _visible(rows, keys, t, causal, window):
    r, c = rows[:, None], keys[None, :]
    ok = (r < t) & (c < t)
    if causal:
        ok &= c <= r
    if window:
        ok &= r - c < window
    return ok


def _pad(x, tp, dp):
    """(B, T, heads, D) -> float32 (B, heads, tp, dp), zero past T and D."""
    b, t, n, d = x.shape
    out = torch.zeros(b, n, tp, dp)
    out[:, :, :t, :d] = x.float().transpose(1, 2)
    return out


def emulate(q, k, v, do, o, lse, *, causal, window, splits, products=3,
            tile_sums=True, split=None):
    """What the tf32x3 backward computes, in plain PyTorch: q, k, v, do, o
    (B, T, heads, D) of one dtype, lse float32 (B, H, T); returns (dq, dk,
    dv) in that dtype. products=1 keeps one TF32 product (a_big b_big) of
    each float32 pair; tile_sums=False adds every product into the running
    dK, dV and dQ on the tensor cores; split (default: float32 inputs)
    takes every operand as two TF32 halves."""
    split = q.dtype == torch.float32 if split is None else split
    three = split and products == 3
    b, t, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    per = group // splits
    width = 64 if d <= 64 else 128 if d <= 128 else 256
    _, split_d, bq, bk, _, bkq = TILES[width]
    dp = -(-d // 8) * 8
    tp = -(-t // DQ_ROWS) * DQ_ROWS
    w = window if window is not None and window > 0 else 0
    scale = torch.tensor(1.0 / d**0.5, dtype=torch.float32)
    scale_log2 = torch.tensor(1.0 / d**0.5 * _LOG2E, dtype=torch.float32)
    qf, kf, vf, dof = (_pad(x, tp, dp) for x in (q, k, v, do))
    lse2 = torch.zeros(b, h, tp)
    lse2[..., :t] = lse * torch.tensor(_LOG2E, dtype=torch.float32)
    delta = torch.zeros(b, h, tp)
    delta[..., :t] = (do.double() * o.double()).sum(-1).transpose(1, 2).float()

    def halves(x):
        return _split(x) if split else (_tf32(x), None)

    def small_big(cs, c, a, y):  # one k-step: the small halves' products into cs
        (ab, as_), (yb, ys) = a, y
        if three:
            cs = _mma(_mma(cs, as_, yb), ab, ys)
        return cs, _mma(c, ab, yb)

    def dot(a, y):  # dot_rows: a (..., M, n) y (..., N, n)^T over n dims
        shape = torch.broadcast_shapes(a.shape[:-2], y.shape[:-2])
        c = torch.zeros(*shape, a.shape[-2], y.shape[-2])
        cs = torch.zeros_like(c)
        for kk in range(0, a.shape[-1], 8):
            cs, c = small_big(cs, c, halves(a[..., kk:kk + 8]),
                              halves(y[..., kk:kk + 8]))
        return c + cs if three else c

    def dot_parts(a, y):  # the dk/dv kernel: each warp of a key slice
        part = -(-dp // 8 // split_d) * 8  # sums its part of the dims, the
        total = None                      # parts added in order
        for lo in range(0, dp, part):
            x = dot(a[..., lo:lo + part], y[..., lo:lo + part])
            total = x if total is None else total + x
        return total

    def accumulate(acc, a, y):  # acc += a y over k-steps of 8 rows
        if not tile_sums:  # every product into the running sum
            for c in range(0, a.shape[-1], 8):
                (ab, as_), (yb, ys) = (halves(a[..., c:c + 8]),
                                       halves(y[..., c:c + 8, :].transpose(-1, -2)))
                if three:
                    acc = _mma(_mma(acc, as_, yb), ab, ys)
                acc = _mma(acc, ab, yb)
            return acc
        c = torch.zeros_like(acc)
        cs = torch.zeros_like(acc)
        for kk in range(0, a.shape[-1], 8):
            cs, c = small_big(cs, c, halves(a[..., kk:kk + 8]),
                              halves(y[..., kk:kk + 8, :].transpose(-1, -2)))
        return acc + (c + cs if three else c)

    def p_ds(s, dpv, l2, de, ok):  # fast_exp2(fmaf(s, scale_log2, -l2))
        x = (s.double() * scale_log2.double() - l2.double()).float()
        p = torch.where(ok, torch.exp2(x), 0.0)
        return p, p * (dpv - de)

    # the dk/dv kernel: run s of each KV head's group takes heads s per + r
    # in order of r, each over its query steps in order; keys that no query
    # of a step sees would add zero fragments, and are left out
    acc_k = torch.zeros(b, hkv, splits, tp, dp)
    acc_v = torch.zeros(b, hkv, splits, tp, dp)
    kx, vx = kf[:, :, None], vf[:, :, None]
    for r in range(per):
        idx = torch.tensor([[kvh * group + s * per + r for s in range(splits)]
                            for kvh in range(hkv)])
        qr, dor, l2r, der = qf[:, idx], dof[:, idx], lse2[:, idx], delta[:, idx]
        for i0 in range(0, t, bq):
            lo = max(0, i0 - w + 1) if w else 0
            hi = min(tp, i0 + bq) if causal else tp
            qt, dot_ = qr[..., i0:i0 + bq, :], dor[..., i0:i0 + bq, :]
            ok = _visible(torch.arange(i0, i0 + bq), torch.arange(lo, hi), t,
                          causal, w).T
            p, ds = p_ds(dot_parts(kx[..., lo:hi, :], qt),
                         dot_parts(vx[..., lo:hi, :], dot_),
                         l2r[..., None, i0:i0 + bq], der[..., None, i0:i0 + bq], ok)
            acc_v[..., lo:hi, :] = accumulate(acc_v[..., lo:hi, :], p, dot_)
            acc_k[..., lo:hi, :] = accumulate(acc_k[..., lo:hi, :], ds, qt)
    # the runs' float32 partials (dk with its scale) added in run order
    dk, dv = torch.zeros(b, hkv, tp, dp), torch.zeros(b, hkv, tp, dp)
    for s in range(splits):
        dk, dv = dk + acc_k[:, :, s] * scale, dv + acc_v[:, :, s]

    # the dq kernel: each query tile over its key steps in order; queries
    # that see no key of a step would add zero fragments, and are left out
    kvh = torch.arange(h) // group
    kq, vq = kf[:, kvh], vf[:, kvh]
    acc = torch.zeros(b, h, tp, dp)
    for k0 in range(0, t, bkq):
        lo = k0 if causal else 0
        hi = min(tp, k0 + bkq - 1 + w) if w else tp
        kt, vt = kq[..., k0:k0 + bkq, :], vq[..., k0:k0 + bkq, :]
        ok = _visible(torch.arange(lo, hi), torch.arange(k0, k0 + bkq), t,
                      causal, w)
        _, ds = p_ds(dot(qf[..., lo:hi, :], kt), dot(dof[..., lo:hi, :], vt),
                     lse2[..., lo:hi, None], delta[..., lo:hi, None], ok)
        acc[..., lo:hi, :] = accumulate(acc[..., lo:hi, :], ds, kt)
    dq = acc * scale

    def out(x):
        return x[:, :, :t, :d].transpose(1, 2).to(q.dtype)
    return out(dq), out(dk), out(dv)


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


def _case(b, t, h, hkv, d, causal, window, dtype):
    """numpy inputs from a seed, the forward's o (in the dtype) and row
    log-sum-exp (float32) from float64 softmax, and the JAX gradients."""
    rng = np.random.default_rng(b * 1000 + t + d)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d),
                        (b, t, h, d))]
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    pos = torch.arange(t)
    group = h // hkv
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() / d**0.5,
                     k.double().repeat_interleave(group, 2))
    s = torch.where(_visible(pos, pos, t, causal, window), s, -math.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                     v.double().repeat_interleave(group, 2)).to(dtype)
    lse = torch.logsumexp(s, dim=-1).float()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _jax_grad(causal, window)(*(jnp.asarray(a, jdt) for a in arrays))
    return (q, k, v, do, o, lse), [np.asarray(x.astype(jnp.float32)) for x in want]


def _errors(got, want):
    return {n: _rel_err(x.float().numpy(), w)
            for n, x, w in zip(("dq", "dk", "dv"), got, want)}


# (b, t, H, Hkv, D, causal, window): GQA groups 1, 2 and 4; ragged T (not a
# multiple of a tile) and T below one step; causal with windows shorter
# and longer than a step, non-causal with and without one; D 8, 12, 64
# (the D <= 64 tiles), 100, 128 (<= 128), 200, 256 (<= 256)
F32_CASES = [(1, 100, 4, 4, 64, True, None), (2, 70, 4, 2, 8, True, None),
             (1, 130, 8, 2, 64, True, 40), (1, 65, 4, 1, 128, True, 3),
             (1, 90, 4, 2, 100, False, None), (1, 80, 4, 1, 200, False, 20),
             (1, 70, 2, 1, 256, True, 20), (1, 37, 2, 2, 12, True, 5),
             (2, 5, 2, 1, 8, True, None)]


@pytest.mark.parametrize("runs", ["one", "each head"])
@pytest.mark.parametrize("b,t,h,hkv,d,causal,window", F32_CASES)
def test_tf32x3_backward_matches_the_reference_in_f32(b, t, h, hkv, d,
                                                      causal, window, runs):
    inputs, want = _case(b, t, h, hkv, d, causal, window, torch.float32)
    splits = 1 if runs == "one" else h // hkv
    got = emulate(*inputs, causal=causal, window=window, splits=splits)
    assert all(x.dtype == torch.float32 for x in got)
    errs = _errors(got, want)
    assert max(errs.values()) <= REHEARSAL_TOL, errs
    # and the plain version (the card's yardstick) agrees as closely
    plain = tref.mha_blocked_grad(*inputs[:4], causal=causal, window=window)
    assert max(_rel_err(x.numpy(), p.numpy())
               for x, p in zip(got, plain)) <= REHEARSAL_TOL


# bfloat16 at head dims that are not a multiple of 8 (the route's bf16
# calls): one product each, P and dS rounded to TF32
BF16_CASES = [(1, 100, 4, 2, 60, True, None), (1, 77, 2, 1, 12, True, 9),
              (1, 90, 4, 1, 100, False, None), (1, 70, 2, 2, 250, True, 30)]


@pytest.mark.parametrize("b,t,h,hkv,d,causal,window", BF16_CASES)
def test_tf32x3_backward_matches_the_reference_in_bf16(b, t, h, hkv, d,
                                                       causal, window):
    assert kflash.flash_bwd_route(torch.bfloat16, d) == "tf32x3"
    inputs, want = _case(b, t, h, hkv, d, causal, window, torch.bfloat16)
    splits = kflash.bwd_tf32x3_splits(b, t, h, hkv, d)
    got = emulate(*inputs, causal=causal, window=window, splits=splits)
    assert all(x.dtype == torch.bfloat16 for x in got)
    errs = _errors(got, want)
    assert max(errs.values()) <= BF16_TOL, errs
    # P and dS rounded to TF32 once move no gradient by more than one
    # bfloat16 ulp of its largest |value| (2^-7 of it) from the same
    # arithmetic with them split in three
    exact = emulate(*inputs, causal=causal, window=window, splits=splits,
                    split=True)
    assert max(_rel_err(x.float().numpy(), y.float().numpy())
               for x, y in zip(got, exact)) <= 2.0**-7


def test_one_tf32_product_misses_the_tolerance():
    case = (1, 130, 2, 2, 128, True, None)
    inputs, want = _case(*case, torch.float32)
    kw = dict(causal=True, window=None, splits=1)
    err1 = max(_errors(emulate(*inputs, products=1, **kw), want).values())
    err3 = max(_errors(emulate(*inputs, **kw), want).values())
    assert err1 > F32_TOL > REHEARSAL_TOL >= err3, (err1, err3)


def test_long_rows_need_the_per_tile_sums():
    # T = 4096 causal: key 0 sums over all 2 x 4096 rows of its group, every
    # dq row over its keys; summed per tile the rounding stays flat in T,
    # summed on the tensor cores it grows past the rehearsal's tolerance
    case = (1, 4096, 2, 1, 8, True, None)
    inputs, want = _case(*case, torch.float32)
    kw = dict(causal=True, window=None, splits=1)
    tiles = _errors(emulate(*inputs, **kw), want)
    running = _errors(emulate(*inputs, tile_sums=False, **kw), want)
    assert max(tiles.values()) <= REHEARSAL_TOL, tiles
    assert max(running.values()) > REHEARSAL_TOL, running


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_float32_backward_of_every_configured_head_dim_is_tf32x3(arch):
    d = get_config(arch).head_dim
    assert kflash.flash_bwd_route(torch.float32, d) == "tf32x3"
    assert kflash.flash_bwd_route(torch.bfloat16, d) == "sm90"


@pytest.mark.parametrize("b,t,h,hkv,d,want", [
    (2, 2048, 32, 4, 64, 4), (1, 2048, 64, 8, 128, 2),
    (1, 2048, 4, 1, 256, 4), (1, 1024, 8, 2, 60, 4), (8, 4096, 8, 8, 64, 1)])
def test_runs_of_heads_fill_the_tf32x3_dkdv_grid(b, t, h, hkv, d, want):
    splits = kflash.bwd_tf32x3_splits(b, t, h, hkv, d)
    group = h // hkv
    assert splits == want and group % splits == 0
    width = next(w for w in (64, 128, 256) if d <= w)
    base = b * hkv * -(-t // kflash.BWD_TF32X3_TILE[width])
    need = kflash.BWD_TF32X3_DKDV_BLOCKS[width]
    assert base * splits >= need or splits == group
    assert all(base * s < need for s in range(1, splits) if group % s == 0)
