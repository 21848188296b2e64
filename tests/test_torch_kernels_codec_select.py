"""The selection of csrc/codec.cu's top-k kernels, rehearsed on the host
(the kernels themselves run only on a Hopper card:
tests/test_torch_kernels_cuda.py).

* ``topk_mask_warp_kernel`` (rows of P <= ``codec.WARP_MAX_P``): a numpy
  emulation of its register/lane layout (value 32 r + lane in register r
  of lane ``lane``, the slots past the row's end holding the sign bit),
  the warp AND and OR in 32-bit halves that skip the bits every value
  shares, the bit-serial candidate counts (per lane, then summed as
  ``__reduce_add_sync`` does) with their early stop, the skip of the bits
  the candidates share when a count finds one, and the ballot tie rank;
* ``topk_mask_kernel`` (longer rows): the byte-wise histogram passes with
  the warp-parallel bin search (8 bins a lane, a suffix sum by
  ``__shfl_down_sync``, a ballot for the highest lane that reaches the
  count still needed, the bin within that lane);

both bit-equal to ``ref.topk_mask`` for every ``kept`` from 1 to P, and to
the JAX reference (``repro.kernels.ref.topk_mask``, x64) for a spread of
``kept``, on random rows, rows of small integers (ties), all-zero rows,
±0, ±inf, subnormals and NaN, with P on both sides of the route limit;
and the route rule, ``codec.codec_route``, with the constants read from
the source.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import codec as kcodec
from repro_torch.kernels import ref

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

SRC = (pathlib.Path(kcodec.__file__).resolve().parent / "csrc"
       / "codec.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+)(?: \* (\d+))?;", SRC)
    return int(m.group(1)) * int(m.group(2) or 1)


WARP_MAX_P = _const("kWarpMaxP")
DTYPES = [np.float64, np.float32]
UINT = {np.float64: np.uint64, np.float32: np.uint32}
KINDS = ("random", "ties", "zeros", "signed_zeros", "inf", "subnormal", "nan")
# P = 1, the register-count steps of the warp route, the main path's
# payloads (10, 18, 55, 100) and both sides of the route limit
WIDTHS = [1, 2, 10, 18, 31, 32, 33, 55, 64, 100, 257, WARP_MAX_P,
          WARP_MAX_P + 1]


def _rows(dt, p: int, seed: int) -> np.ndarray:
    """One row of each kind in KINDS."""
    rng = np.random.default_rng(seed)
    x = np.zeros((len(KINDS), p))
    x[0] = rng.standard_normal(p) * 10.0 ** rng.uniform(-3, 3, p)
    x[1] = rng.integers(-3, 4, p)
    x[2] = 0.0
    x[3] = np.where(rng.random(p) < 0.5, -0.0, 0.0)
    x[3, rng.integers(p)] = 0.5
    x[4] = rng.standard_normal(p)
    x[4, rng.random(p) < 0.3] = np.inf
    x[4, rng.random(p) < 0.3] = -np.inf
    tiny = np.finfo(dt).tiny
    x = x.astype(dt)
    x[5] = (rng.integers(-4, 5, p) * (tiny / 8)).astype(dt)  # subnormal
    x[5, rng.random(p) < 0.2] = dt(tiny)
    x[6] = rng.standard_normal(p)
    x[6, rng.random(p) < 0.3] = np.nan
    return x


def _keeps(p: int) -> np.ndarray:
    return np.arange(1, p + 1)


def _batch(x: np.ndarray, keeps: np.ndarray):
    """Every row with every kept: (rows * len(keeps), P), kept per row."""
    return (np.repeat(x, len(keeps), axis=0),
            np.tile(keeps, x.shape[0]))


def _popc(a: np.ndarray) -> np.ndarray:
    return np.bitwise_count(a).astype(np.int64)


# ---------------------------------------------------------------------------
# topk_mask_warp_kernel
# ---------------------------------------------------------------------------

def _warp_regs(p: int) -> int:
    r = 1
    while 32 * r < p:
        r *= 2
    return r


def _warp_reduce(v: np.ndarray, valid: np.ndarray, op, identity, ut):
    """__reduce_{and,or}_sync over the warp's valid slots (rows, R, 32),
    in 32-bit halves as the source does for 64-bit patterns."""
    v = np.where(valid, v, identity)
    if ut == np.uint32:
        return op.reduce(v.reshape(v.shape[0], -1), axis=1)
    hi = op.reduce((v >> np.uint64(32)).astype(np.uint32).reshape(v.shape[0], -1), axis=1)
    lo = op.reduce(v.astype(np.uint32).reshape(v.shape[0], -1), axis=1)
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _msb(d: np.ndarray, ut, bits: int) -> np.ndarray:
    """The highest bit set in each pattern (-1 for 0)."""
    top = np.full(d.shape, -1, np.int64)
    for b in range(bits):
        top = np.where((d >> ut(b)) & ut(1), b, top)
    return top


def _above(t: np.ndarray, ut):
    """The bits above bit t: ~((2 << t) - 1)."""
    return ~((ut(2) << np.maximum(t, 0).astype(ut)) - ut(1))


def _emulate_warp(x: np.ndarray, kept: np.ndarray) -> tuple:
    """topk_mask_warp_kernel on rows x (n, P), row i keeping kept[i];
    returns the output and, per row, the bit-serial steps taken."""
    ut = UINT[x.dtype.type]
    bits = 8 * x.itemsize
    one = ut(1)
    all_ones = ut(np.iinfo(ut).max)
    sign = ut(1) << ut(bits - 1)
    n, p = x.shape
    regs = _warp_regs(p)
    lane = np.arange(32)
    idx = 32 * np.arange(regs)[:, None] + lane[None, :]  # (R, 32)
    valid = np.broadcast_to(idx < p, (n, regs, 32))
    raw = np.full((n, regs * 32), sign, ut)
    raw[:, :p] = x.view(ut)
    raw = raw.reshape(n, regs, 32)
    v = np.where(valid, raw & ~sign, sign)  # past the end: the sign bit
    neg = np.where(valid, raw >> ut(bits - 1), ut(0))
    all_and = _warp_reduce(v, valid, np.bitwise_and, all_ones, ut)
    all_or = _warp_reduce(v, valid, np.bitwise_or, ut(0), ut)
    diff = all_and ^ all_or
    top = _msb(diff, ut, bits)
    assert (top < bits - 1).all()  # |x| has no sign bit
    fixed = np.where(diff != 0, _above(top, ut), all_ones)
    prefix = all_and & fixed
    need = kept.astype(np.int64)
    cands = np.full(n, p, np.int64)
    steps = np.zeros(n, np.int64)
    cur = top.copy()  # the bit each row decides next
    while True:
        active = (cur >= 0) & (cands != need)
        if not active.any():
            break
        bit = one << np.maximum(cur, 0).astype(ut)
        cand = (v & fixed[:, None, None]) == prefix[:, None, None]
        per_lane = (cand & ((v & bit[:, None, None]) != 0)).sum(axis=1)
        c = per_lane.sum(axis=1)  # __reduce_add_sync
        # a bit every candidate shares: skip the bits they share, or stop
        # where they are all equal
        common = active & ((c == 0) | (c == cands))
        c_and = _warp_reduce(v, cand, np.bitwise_and, all_ones, ut)
        c_or = _warp_reduce(v, cand, np.bitwise_or, ut(0), ut)
        d = c_and ^ c_or
        t = _msb(d, ut, bits)
        equal = common & (d == 0)
        jump = common & (d != 0)
        assert (t[jump] < cur[jump]).all()
        step = active & ~common
        up = step & (c >= need)
        down = step & (c < need)
        prefix = np.where(up, prefix | bit, prefix)
        cands = np.where(up, c, np.where(down, cands - c, cands))
        need = np.where(down, need - c, need)
        fixed = np.where(step, fixed | bit, fixed)
        prefix = np.where(jump, c_and & _above(t, ut),
                          np.where(equal, c_and, prefix))
        fixed = np.where(jump, _above(t, ut), np.where(equal, all_ones, fixed))
        cur = np.where(step, cur - 1, np.where(jump, t, np.where(equal, -1, cur)))
        steps += active
        assert (cands >= need).all() and (need >= 1).all()
    # the loop ends with as many candidates as are needed, or with every
    # bit of the threshold decided
    assert ((cands == need) | (fixed == all_ones)).all()
    below = ((1 << lane) - 1).astype(np.uint32)
    ties = np.zeros(n, np.int64)
    out = np.zeros((n, regs, 32), ut)
    for r in range(regs):
        m = v[:, r] & fixed[:, None]
        at = m == prefix[:, None]
        ballot = (at.astype(np.uint32) << lane.astype(np.uint32)).sum(
            axis=1, dtype=np.uint64).astype(np.uint32)
        rank = ties[:, None] + _popc(ballot[:, None] & below[None, :])
        keep = (m > prefix[:, None]) | (at & (rank < need[:, None]))
        ties += _popc(ballot)
        out[:, r] = np.where(keep, v[:, r] | (neg[:, r] << ut(bits - 1)), 0)
    return out.reshape(n, regs * 32)[:, :p].view(x.dtype), steps


# ---------------------------------------------------------------------------
# topk_mask_kernel
# ---------------------------------------------------------------------------

def _bin_search(hist: np.ndarray, need: np.ndarray) -> tuple:
    """Warp 0's search for the threshold's bin: lane l holds bins
    8l..8l+7; returns (bin, count above it)."""
    n = hist.shape[0]
    h = hist.reshape(n, 32, 8)
    local = h.sum(axis=2)
    suffix = local.copy()
    d = 1
    while d < 32:  # __shfl_down_sync, added where lane + d < 32
        o = suffix.copy()
        o[:, :32 - d] = suffix[:, d:]
        suffix = np.where(np.arange(32) + d < 32, suffix + o, suffix)
        d *= 2
    reach = suffix >= need[:, None]
    assert reach[:, 0].all()  # lane 0's suffix is every candidate
    top_lane = 31 - np.argmax(reach[:, ::-1], axis=1)  # 31 - clz(ballot)
    rows = np.arange(n)
    above = suffix[rows, top_lane] - local[rows, top_lane]
    j = np.full(n, 7)
    for t in range(7, 0, -1):
        step = (j == t) & (above + h[rows, top_lane, t] < need)
        above = np.where(step, above + h[rows, top_lane, t], above)
        j = np.where(step, t - 1, j)
    return 8 * top_lane + j, above


def _emulate_block(x: np.ndarray, kept: np.ndarray) -> np.ndarray:
    """topk_mask_kernel on rows x (n, P), row i keeping kept[i]."""
    ut = UINT[x.dtype.type]
    bits = 8 * x.itemsize
    n, p = x.shape
    v = x.view(ut) & ut(np.iinfo(ut).max >> 1)
    prefix = np.zeros(n, ut)
    fixed = np.zeros(n, ut)
    need = kept.astype(np.int64)
    rows = np.repeat(np.arange(n), p).reshape(n, p)
    for shift in range(bits - 8, -1, -8):
        cand = (v & fixed[:, None]) == prefix[:, None]
        bins = ((v >> ut(shift)) & ut(0xff)).astype(np.int64)
        hist = np.bincount((rows * 256 + bins)[cand],
                           minlength=n * 256).reshape(n, 256)
        b, above = _bin_search(hist, need)
        need = need - above
        prefix = prefix | (b.astype(ut) << ut(shift))
        fixed = fixed | (ut(0xff) << ut(shift))
    at = v == prefix[:, None]
    rank = np.cumsum(at, axis=1) - at  # the block-wide prefix count
    keep = (v > prefix[:, None]) | (at & (rank < need[:, None]))
    return np.where(keep, x, x.dtype.type(0))


def _emulate(x: np.ndarray, kept: np.ndarray) -> np.ndarray:
    if x.shape[1] <= kcodec.WARP_MAX_P:
        return _emulate_warp(x, kept)[0]
    return _emulate_block(x, kept)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _torch_ref(x: np.ndarray, kept: np.ndarray) -> np.ndarray:
    """ref.topk_mask row by row, each row with its own kept."""
    out = np.empty_like(x)
    xt = torch.from_numpy(x)
    for k in np.unique(kept):
        sel = kept == k
        out[sel] = ref.topk_mask(xt[torch.from_numpy(sel)], int(k)).numpy()
    return out


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("p", WIDTHS)
def test_route_emulation_bit_equal_to_ref_for_every_kept(dt, p):
    x, kept = _batch(_rows(dt, p, seed=p), _keeps(p))
    got = _emulate(x, kept)
    np.testing.assert_array_equal(_bits(got), _bits(_torch_ref(x, kept)))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("p", [1, 10, 18, 100, WARP_MAX_P, WARP_MAX_P + 1])
def test_route_emulation_bit_equal_to_jax(dt, p):
    rows = _rows(dt, p, seed=1000 + p)
    for k in sorted({1, max(1, p // 10), max(1, p // 2), p}):
        want = np.asarray(jax.vmap(lambda r: jref.topk_mask(r, k))(
            jnp.asarray(rows)))
        got = _emulate(rows, np.full(rows.shape[0], k))
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("p", [1, 7, 33, 100, 300])
def test_block_route_emulation_at_short_rows(dt, p):
    """The block route's passes and bin search at widths the warp route
    serves (its algorithm does not depend on P)."""
    x, kept = _batch(_rows(dt, p, seed=2000 + p), _keeps(p))
    np.testing.assert_array_equal(_bits(_emulate_block(x, kept)),
                                  _bits(_torch_ref(x, kept)))


def test_warp_route_stops_early():
    """Distinct magnitudes: the search ends once the candidates left are
    the values still needed, well before every bit is decided; ties: the
    skip of the bits the candidates share ends it where they are all
    equal, a few steps in, not one step a bit."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((200, 100))
    kept = np.full(200, 25)
    got, steps = _emulate_warp(x, kept)
    np.testing.assert_array_equal(got, _torch_ref(x, kept))
    assert steps.max() < 24 and np.median(steps) < 12
    ties = rng.integers(-3, 4, (200, 100)).astype(np.float64)
    got, steps = _emulate_warp(ties, kept)
    np.testing.assert_array_equal(got, _torch_ref(ties, kept))
    assert steps.max() <= 6
    # kept = P, an all-equal row: no bit-serial step at all
    assert _emulate_warp(x, np.full(200, 100))[1].max() == 0
    assert _emulate_warp(np.ones((2, 50)), np.array([1, 7]))[1].max() == 0


def test_bin_search_matches_a_serial_scan():
    """The warp-parallel search finds the bin the serial scan from the top
    found (the highest bin whose suffix sum reaches the count needed)."""
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 4, (500, 256)) * (rng.random((500, 256)) < 0.2)
    hist[0] = 0
    hist[0, 0] = 5  # every candidate in bin 0
    total = hist.sum(axis=1)
    hist[total == 0, 17] = 1
    total = hist.sum(axis=1)
    need = 1 + (rng.random(500) * total).astype(np.int64)
    got_bin, got_above = _bin_search(hist, need)
    for i in range(500):
        above, b = 0, 255
        while b > 0 and above + hist[i, b] < need[i]:
            above += hist[i, b]
            b -= 1
        assert (got_bin[i], got_above[i]) == (b, above)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

def test_route_constants_match_the_source():
    assert kcodec.WARP_MAX_P == WARP_MAX_P == 32 * 32
    assert kcodec.CACHE_BYTES == _const("kCacheBytes")
    # every register count of codec_route is instantiated
    for r in (1, 2, 4, 8, 16):
        assert f"case {r}: f(std::integral_constant<int, {r}>{{}})" in SRC
    assert "default: f(std::integral_constant<int, 32>{})" in SRC


@pytest.mark.parametrize("op", ["topk_mask", "qint8_roundtrip"])
def test_codec_route_is_pinned(op):
    warp = "topk_mask_warp_kernel" if op == "topk_mask" else "qint8_warp_kernel"
    for dtype in (torch.float64, torch.float32):
        assert kcodec.codec_route(op, 1, dtype) == f"{warp}<1>"
        assert kcodec.codec_route(op, 10, dtype) == f"{warp}<1>"
        assert kcodec.codec_route(op, 32, dtype) == f"{warp}<1>"
        assert kcodec.codec_route(op, 33, dtype) == f"{warp}<2>"
        assert kcodec.codec_route(op, 100, dtype) == f"{warp}<4>"
        assert kcodec.codec_route(op, 1024, dtype) == f"{warp}<32>"
    if op == "topk_mask":
        route = "topk_mask_kernel (shared-memory cache)"
        assert kcodec.codec_route(op, 1025, torch.float64) == route
        assert kcodec.codec_route(op, 4096, torch.float64) == route
        assert kcodec.codec_route(op, 8192, torch.float32) == route
        streamed = "topk_mask_kernel (streamed)"
        assert kcodec.codec_route(op, 4097, torch.float64) == streamed
        assert kcodec.codec_route(op, 16384, torch.float64) == streamed
        assert kcodec.codec_route(op, 8193, torch.float32) == streamed
    else:
        vec = "qint8_kernel (16-byte loads)"
        assert kcodec.codec_route(op, 1026, torch.float64) == vec
        assert kcodec.codec_route(op, 16384, torch.float64) == vec
        assert kcodec.codec_route(op, 1028, torch.float32) == vec
        assert kcodec.codec_route(op, 1025, torch.float64) == "qint8_kernel"
        assert kcodec.codec_route(op, 1026, torch.float32) == "qint8_kernel"
    with pytest.raises(TypeError):
        kcodec.codec_route(op, 10, torch.float16)
    with pytest.raises(KeyError):
        kcodec.codec_route("fwht", 10, torch.float64)
