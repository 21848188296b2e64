"""The register kernels of csrc/srht.cu, rehearsed on the host (the
kernels themselves run only on a Hopper card:
tests/test_torch_kernels_cuda.py).

* ``fwht_reg_kernel``: a plain-Python emulation of its index arithmetic
  in the formulas of the source (which lane and register hold which
  coordinate in each phase, the shuffle partner of each stage, the
  swizzled shared-memory exchange between phases), run on torch tensors,
  reproduces ``ref.fwht`` and the JAX reference bit for bit; the
  exchange is a permutation and free of bank conflicts;
* ``srht_fwd_reg_kernel``: the same layout with lanes on consecutive
  values; the slab of a chunk's rows split into the bulk copy's aligned
  middle and the head and tail loaded by threads, the padding and sign
  flip on the way into registers, the phases, the gather through the
  inverse of ``rows`` into staged outputs, against ``ref.srht_apply`` and
  the JAX reference; its shared memory fits a block;
* ``fwht_strided_kernel``: the strided pass of rows past 2^14, a lane on
  a column and the rows in its registers, phases and exchanges past 16
  rows, against plain stages and, behind ``fwht_reg_kernel``'s first
  pass, ``ref.fwht`` and the JAX reference;
* ``srht_t_warp_kernel``: the same for the lane layout, the lookup in the
  inverse of ``rows`` that replaces the scatter, and the stages, against
  ``ref.srht_apply_t`` and the JAX reference;
* the route rule, ``fwht.kernel_route``: which kernel serves which (op,
  n), in either dtype, with the constants read from the source.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import fwht as kfwht
from repro_torch.kernels import ref

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

SRC = (pathlib.Path(kfwht.__file__).resolve().parent / "csrc" / "srht.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


LOG_REGS = _const("kLogRegs")
LOG_MIN_WARPS = _const("kLogMinWarps")
WARP_T_MAX_N = _const("kWarpTMaxN")
DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]


# ---------------------------------------------------------------------------
# fwht_reg_kernel
# ---------------------------------------------------------------------------

def _layout(log_n: int, tdt: torch.dtype, log_v: "int | None" = None) -> dict:
    """RegFwht<T, LOG_N, LOG_V> of the source (LOG_V by default a
    16-byte vector)."""
    if log_v is None:
        log_v = min(1 if tdt == torch.float64 else 2, log_n)
    bits = LOG_REGS + 5
    log_c = max(log_n, bits + LOG_MIN_WARPS)
    phases = 1 if log_n <= bits else -(-log_n // bits)
    return dict(log_v=log_v, bits=bits, log_c=log_c, log_w=log_c - bits,
                phases=phases, last=min((phases - 1) * bits, log_c - bits))


def _reg_index(m, w, lane, u, log_v: int, bits: int):
    f = (u & ((1 << log_v) - 1)) | (lane << log_v) | ((u >> log_v) << (log_v + 5))
    return (w & ((1 << m) - 1)) | (f << m) | ((w >> m) << (m + bits))


def _swizzle(e, tdt: torch.dtype, log_c: int):
    g = 4 if tdt == torch.float64 else 5
    x = torch.zeros_like(e)
    for s in range(g, log_c, g):
        x = x ^ (e >> s)
    return e ^ (x & ((1 << g) - 1))


def _grid(lay: dict):
    """(w, lane, u) index tensors broadcast to (W, 32, Q)."""
    w = torch.arange(1 << lay["log_w"])[:, None, None]
    lane = torch.arange(32)[None, :, None]
    u = torch.arange(1 << LOG_REGS)[None, None, :]
    return w, lane, u


def _index(lay, m, w, lane, u):
    return _reg_index(m, w, lane, u, lay["log_v"], lay["bits"])


def _reg_stage(v, h):
    lo = torch.tensor([u for u in range(v.shape[-1]) if not u & h])
    a, b = v[..., lo], v[..., lo + h]
    v = v.clone()
    v[..., lo] = a + b
    v[..., lo + h] = a - b
    return v


def _lane_stage(v, m, lane):
    """v (..., 32, P): lanes l and l ^ m, the lower keeping a + b."""
    partner = v[..., torch.arange(32) ^ m, :]
    return torch.where((lane & m) != 0, partner - v, v + partner)


def _phases(v, lay, tdt, log_n, w, lane, u):
    """reg_phases: the stages of v (..., W, 32, Q), held in the layout based
    at bit 0, phase by phase; v ends in the layout based at lay["last"]."""
    m_prev = 0
    for p in range(lay["phases"]):
        m = min(p * lay["bits"], lay["log_w"])
        if p:
            v = _exchange(v, lay, tdt, _index(lay, m_prev, w, lane, u),
                          _index(lay, m, w, lane, u))
        for b in range(p * lay["bits"], min((p + 1) * lay["bits"], log_n)):
            t = b - m
            if t < lay["log_v"]:
                v = _reg_stage(v, 1 << t)
            elif t < lay["log_v"] + 5:
                v = _lane_stage(v, 1 << (t - lay["log_v"]), lane)
            else:
                v = _reg_stage(v, 1 << (t - 5))
        m_prev = m
    assert m_prev == lay["last"]
    return v


def _emulate_fwht(x: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """fwht_reg_kernel on x (rows, n), chunk by chunk as the grid-stride
    loop takes them (all chunks at once here)."""
    rows, n = x.shape
    log_n = n.bit_length() - 1
    lay = _layout(log_n, x.dtype)
    c = 1 << lay["log_c"]
    chunks = -(-rows * n // c)
    flat = torch.zeros(chunks * c, dtype=x.dtype)  # masked loads read 0
    flat[:rows * n] = x.reshape(-1)
    flat = flat.view(chunks, c)
    w, lane, u = _grid(lay)
    home = _index(lay, 0, w, lane, u)
    v = _phases(flat[:, home], lay, x.dtype, log_n, w, lane, u)
    if lay["phases"] > 1:
        v = _exchange(v, lay, x.dtype, _index(lay, lay["last"], w, lane, u), home)
    out = torch.empty_like(flat)
    out[:, home] = v * norm
    return out.reshape(-1)[:rows * n].view(rows, n)


def _exchange(v, lay, tdt, src, dst):
    s = torch.full((v.shape[0], 1 << lay["log_c"]), float("nan"), dtype=tdt)
    s[:, _swizzle(src, tdt, lay["log_c"])] = v
    return s[:, _swizzle(dst, tdt, lay["log_c"])]


FWHT_N = [1, 2, 4, 32, 64, 512, 1024, 4096, 1 << 14]


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("n", FWHT_N)
@pytest.mark.parametrize("normalize", [False, True])
def test_fwht_reg_emulation_bit_equal_to_ref(dt, tdt, n, normalize):
    lay = _layout(n.bit_length() - 1, tdt)
    rows = max(3, 3 * (1 << lay["log_c"]) // n + 5)  # a ragged last chunk
    x = np.random.default_rng(n).standard_normal((rows, n)).astype(dt)
    norm = ref.norm_factor(n, tdt) if normalize else torch.tensor(1.0, dtype=tdt)
    got = _emulate_fwht(torch.from_numpy(x), norm)
    np.testing.assert_array_equal(
        got.numpy(), ref.fwht(torch.from_numpy(x), normalize=normalize).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.fwht(jnp.asarray(x), normalize=normalize,
                                          impl="ref")))


@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("log_n", range(15))
def test_fwht_reg_layouts_are_permutations_without_bank_conflicts(tdt, log_n):
    lay = _layout(log_n, tdt)
    c = 1 << lay["log_c"]
    w, lane, u = _grid(lay)
    assert lay["log_w"] >= LOG_MIN_WARPS
    assert lay["phases"] == (1 if log_n <= 9 else 2)
    for p in range(lay["phases"]):
        e = _index(lay, min(p * lay["bits"], lay["log_w"]), w, lane, u)
        assert torch.equal(e.reshape(-1).sort().values, torch.arange(c))
        slot = _swizzle(e, tdt, lay["log_c"])
        assert torch.equal(slot.reshape(-1).sort().values, torch.arange(c))
        if tdt == torch.float64:  # 8-byte words: 16 bank pairs a half-warp
            banks = (slot % 16).view(-1, 2, 16, slot.shape[-1])
        else:  # 4-byte words: 32 banks a warp
            banks = (slot % 32).view(-1, 1, 32, slot.shape[-1])
        distinct = banks.sort(dim=2).values.diff(dim=2) != 0
        assert distinct.all(), f"bank conflict in phase {p}"
    # loads and stores: neighbouring lanes on neighbouring vectors
    home = _index(lay, 0, w, lane, u)
    first = home[:, :, ::1 << lay["log_v"]]
    assert torch.equal(first.diff(dim=1), torch.full_like(
        first[:, 1:], 1 << lay["log_v"]))
    vec = home.view(*home.shape[:2], -1, 1 << lay["log_v"])
    assert torch.equal(vec - vec[..., :1], torch.arange(vec.shape[-1]).expand_as(vec))


# ---------------------------------------------------------------------------
# srht_fwd_reg_kernel
# ---------------------------------------------------------------------------

LOG_MAX_N = _const("kLogMaxN")
LOG_LOW_N = _const("kLogLowN")
SMEM_PER_BLOCK = 232448  # the opt-in limit of a Hopper block (227 KB)


def _srht_fwd_layout(log_n: int, tdt: torch.dtype) -> dict:
    """SrhtFwdReg<T, LOG_N> of the source: RegFwht with LOG_V = 0, the
    rows of a chunk and the shared memory."""
    lay = _layout(log_n, tdt, log_v=0)
    item = torch.finfo(tdt).bits // 8
    inv = 16 + (item << lay["log_c"]) + 16
    neg = inv + (4 << log_n)
    return dict(lay, rows=1 << (lay["log_c"] - log_n), smem=neg + (4 << (log_n - 5)))


def _emulate_srht_fwd(x, signs, rows, offset: int = 0):
    """srht_fwd_reg_kernel on x (nrows, dim), whose first value lies
    ``offset`` bytes past a 16-byte boundary, chunk by chunk."""
    nrows, dim = x.shape
    n, k = signs.shape[0], rows.shape[0]
    log_n = n.bit_length() - 1
    tdt = x.dtype
    lay = _srht_fwd_layout(log_n, tdt)
    r_chunk, c = lay["rows"], 1 << lay["log_c"]
    item = torch.finfo(tdt).bits // 8
    align = 16 // item
    norm = ref.norm_factor(n, tdt)
    scale = ref.subsample_scale(n, k, tdt)
    # once a block: the inverse of rows and each register's sign, from
    # its bit where every sign is +1 or -1, else as read
    inv = torch.full((n,), -1, dtype=torch.int64)
    inv[rows] = torch.arange(k)
    w, lane, u = _grid(lay)
    home = _index(lay, 0, w, lane, u)
    if bool(((signs == 1) | (signs == -1)).all()):
        flip = torch.signbit(signs)[home & (n - 1)]
        sign = torch.where(flip, torch.tensor(-1.0, dtype=tdt),
                           torch.tensor(1.0, dtype=tdt))
    else:
        sign = signs[home & (n - 1)]
    last = _index(lay, lay["last"], w, lane, u)
    col = inv[last & (n - 1)]
    kept = col >= 0
    slot = ((last >> log_n) * k + col)[kept]
    assert slot.unique().numel() == slot.numel() == r_chunk * k  # all, once
    flat = x.reshape(-1)
    out = torch.empty(nrows, k, dtype=tdt)
    for r0 in range(0, nrows, r_chunk):
        nr = min(r_chunk, nrows - r0)
        count = nr * dim
        addr = offset + r0 * dim * item  # of the slab, from a 16-byte boundary
        lead = addr % 16 // item
        head = min(count, (align - lead) % align)
        body = (count - head) // align * align
        assert (addr + head * item) % 16 == 0 and (lead + head) % align == 0
        assert 0 <= count - head - body < align
        smem = torch.full((c + align,), float("nan"), dtype=tdt)
        src = flat[r0 * dim:r0 * dim + count]
        smem[lead:lead + head] = src[:head]  # threads
        smem[lead + head:lead + head + body] = src[head:head + body]  # bulk copy
        smem[lead + head + body:lead + count] = src[head + body:]  # threads
        r, j = home >> log_n, home & (n - 1)
        valid = (j < dim) & (r < nr)
        idx = torch.where(valid, lead + r * dim + j, 0)
        val = torch.where(valid, smem[idx], torch.zeros((), dtype=tdt))
        v = _phases((val * sign)[None], lay, tdt, log_n, w, lane, u)[0]
        staged = torch.full((c,), float("nan"), dtype=tdt)
        staged[slot] = ((v * norm) * scale)[kept]
        out[r0:r0 + nr] = staged[:nr * k].view(nr, k)
    return out


SRHT_FWD_CASES = [(n, dim, k) for n in (64, 128, 1024, 1 << 14)
                  for dim in sorted({d for d in (54, 68, n - 1, n) if d <= n})
                  for k in sorted({kk for kk in (1, 17, 20, n) if kk <= n})]


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("n,dim,k", SRHT_FWD_CASES)
def test_srht_fwd_reg_emulation_bit_equal_to_ref(dt, tdt, n, dim, k):
    assert kfwht.kernel_route("srht_apply", n).startswith("srht_fwd_reg_kernel")
    rng = np.random.default_rng(n * 7 + dim * 3 + k)
    signs = rng.choice([-1.0, 1.0], n).astype(dt)
    rows = rng.permutation(n)[:k].astype(np.int64)
    r_chunk = _srht_fwd_layout(n.bit_length() - 1, tdt)["rows"]
    nrows = 2 * r_chunk + 3  # a ragged last chunk
    x = rng.standard_normal((nrows, dim)).astype(dt)
    item = np.dtype(dt).itemsize
    want = ref.srht_apply(torch.from_numpy(x), torch.from_numpy(signs),
                          torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(want, np.asarray(jops.srht_apply(
        jnp.asarray(x), jnp.asarray(signs), jnp.asarray(rows), impl="ref")))
    for offset in range(0, 16, item):  # x as a view off a 16-byte boundary
        got = _emulate_srht_fwd(torch.from_numpy(x), torch.from_numpy(signs),
                                torch.from_numpy(rows), offset)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("n,dim,k", [(64, 54, 20), (128, 68, 17),
                                     (1024, 1023, 50), (1 << 14, 16383, 20)])
def test_srht_fwd_reg_emulation_takes_any_signs(dt, tdt, n, dim, k):
    """Signs other than +1 and -1 (normal draws, with an exact +1, -1 and
    -0.0) are multiplied as read: bit-equal to the plain version. XLA on
    the CPU may contract that multiply into the first stage's add, so the
    JAX reference is held to a tolerance (1e-12 in float64, 1e-5 in
    float32); with signs of +1 and -1 the product is exact and it agrees
    bit for bit (test above)."""
    rng = np.random.default_rng(n + dim + k)
    signs = rng.standard_normal(n).astype(dt)
    signs[:3] = [1.0, -1.0, -0.0]
    rows = rng.permutation(n)[:k].astype(np.int64)
    x = rng.standard_normal((2 * _srht_fwd_layout(n.bit_length() - 1, tdt)
                             ["rows"] + 1, dim)).astype(dt)
    want = ref.srht_apply(torch.from_numpy(x), torch.from_numpy(signs),
                          torch.from_numpy(rows)).numpy()
    tol = 1e-12 if dt == np.float64 else 1e-5
    np.testing.assert_allclose(want, np.asarray(jops.srht_apply(
        jnp.asarray(x), jnp.asarray(signs), jnp.asarray(rows), impl="ref")),
        rtol=tol, atol=tol)
    got = _emulate_srht_fwd(torch.from_numpy(x), torch.from_numpy(signs),
                            torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("log_n", range(6, LOG_MAX_N + 1))
def test_srht_fwd_reg_layout_reads_without_conflicts_and_fits(tdt, log_n):
    lay = _srht_fwd_layout(log_n, tdt)
    assert lay["smem"] <= SMEM_PER_BLOCK
    c = 1 << lay["log_c"]
    w, lane, u = _grid(lay)
    assert lay["phases"] == (1 if log_n <= 9 else 2)
    for p in range(lay["phases"]):
        e = _index(lay, min(p * lay["bits"], lay["log_w"]), w, lane, u)
        assert torch.equal(e.reshape(-1).sort().values, torch.arange(c))
        slot = _swizzle(e, tdt, lay["log_c"])
        assert torch.equal(slot.reshape(-1).sort().values, torch.arange(c))
        if tdt == torch.float64:
            banks = (slot % 16).view(-1, 2, 16, slot.shape[-1])
        else:
            banks = (slot % 32).view(-1, 1, 32, slot.shape[-1])
        assert (banks.sort(dim=2).values.diff(dim=2) != 0).all(), p
    # a warp's reads of the slab: for every register, 32 consecutive
    # coordinates of one row (so consecutive words, whatever dim is)
    home = _index(lay, 0, w, lane, u)
    assert torch.equal(home.diff(dim=1), torch.ones_like(home[:, 1:]))
    assert torch.equal(home[:, :1] >> log_n, home[:, -1:] >> log_n)


# ---------------------------------------------------------------------------
# fwht_strided_kernel
# ---------------------------------------------------------------------------

def _strided_layout(log_r: int) -> dict:
    """StridedFwht<LOG_R> of the source."""
    log_q = min(log_r, LOG_REGS)
    log_cols = 5 if log_r <= LOG_REGS + 5 else LOG_MAX_N - log_r
    log_u = log_r + log_cols - 5
    log_w = log_u - log_q
    phases = -(-log_u // log_q)
    return dict(log_q=log_q, log_cols=log_cols, log_u=log_u, log_w=log_w,
                phases=phases, tiles=8 if log_w == 0 else 1,
                smem_values=(1 << (log_r + log_cols)) if phases > 1 else 0)


def _strided_index(base, w, lane, u, log_q):
    upper = (w & ((1 << base) - 1)) | (u << base) | ((w >> base) << (base + log_q))
    return lane | (upper << 5)


def _emulate_strided(buf: torch.Tensor, log_r: int, log_lo: int, norm):
    """fwht_strided_kernel<T, LOG_R> on the flat buf: its stages h = lo,
    ..., lo 2^(LOG_R - 1), lo = 2^log_lo, tile by tile (all at once)."""
    lay = _strided_layout(log_r)
    cols, q = 1 << lay["log_cols"], 1 << lay["log_q"]
    tile_values = 1 << (log_r + lay["log_cols"])
    # a group's column tiles fill the block's tiles
    assert log_lo >= lay["log_cols"] + lay["tiles"].bit_length() - 1
    grid = buf.view(-1, 1 << log_r, (1 << log_lo) // cols, cols)
    tiles = grid.permute(0, 2, 1, 3).reshape(-1, tile_values)  # e = row * cols + col
    w = torch.arange(1 << lay["log_w"])[:, None, None]
    lane = torch.arange(32)[None, :, None]
    u = torch.arange(q)[None, None, :]

    def index(base):
        return _strided_index(base, w, lane, u, lay["log_q"])
    v = tiles[:, index(0)]  # (tiles, W, 32, Q)
    for b in range(lay["log_cols"], 5):  # row bits on lanes, by shuffles
        v = _lane_stage(v, 1 << b, lane)
    prev = 0
    for p in range(lay["phases"]):
        at = min(p * lay["log_q"], lay["log_u"] - lay["log_q"])
        if p:
            s = torch.full_like(tiles, float("nan"))
            s[:, index(prev)] = v
            v = s[:, index(at)]
        for b in range(p * lay["log_q"], min((p + 1) * lay["log_q"], lay["log_u"])):
            v = _reg_stage(v, 1 << (b - at))
        prev = at
    out = torch.full_like(tiles, float("nan"))
    out[:, index(prev)] = v * norm
    return out.view(grid.shape[0], grid.shape[2], 1 << log_r, cols).permute(
        0, 2, 1, 3).reshape(buf.shape)


def _plain_stages(x: torch.Tensor, log_lo: int, log_r: int) -> torch.Tensor:
    """ref.fwht's stages h = 2^log_lo ... 2^(log_lo + log_r - 1) alone."""
    y = x.reshape(-1, x.shape[-1])
    n = y.shape[-1]
    for log_h in range(log_lo, log_lo + log_r):
        h = 1 << log_h
        y = y.reshape(y.shape[0], n // (2 * h), 2, h)
        y = torch.stack([y[:, :, 0, :] + y[:, :, 1, :],
                         y[:, :, 0, :] - y[:, :, 1, :]], dim=2)
    return y.reshape(x.shape)


@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("log_r", range(1, LOG_MAX_N + 1))
def test_strided_emulation_bit_equal_to_plain_stages(tdt, log_r):
    """Every pass length, on rows with a narrow stride (the kernel's
    arithmetic does not depend on lo past the tile's width)."""
    lay = _strided_layout(log_r)
    log_lo = lay["log_cols"] + lay["tiles"].bit_length() - 1
    n = 1 << (log_lo + log_r + 1)  # two groups a row
    x = torch.from_numpy(np.random.default_rng(log_r).standard_normal(
        (2, n))).to(tdt)
    norm = ref.norm_factor(n, tdt)
    got = _emulate_strided(x.reshape(-1).clone(), log_r, log_lo, norm)
    want = _plain_stages(x, log_lo, log_r) * norm
    assert torch.equal(got.view(2, n), want)


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("log_n", [15, 17, 20])
def test_long_fwht_emulation_bit_equal_to_ref(dt, tdt, log_n):
    """fwht past 2^14: fwht_reg_kernel on chunks of 2^kLogLowN (launch_fwht's
    rule), then the strided pass, against ref.fwht and the JAX reference."""
    n = 1 << log_n
    log_lo = min(max(log_n - LOG_MAX_N, LOG_LOW_N), LOG_MAX_N)
    assert kfwht.kernel_route("fwht", n).startswith(f"fwht_reg_kernel<2^{log_lo}>")
    x = np.random.default_rng(log_n).standard_normal((2, n)).astype(dt)
    norm = ref.norm_factor(n, tdt)
    low = _emulate_fwht(torch.from_numpy(x).view(-1, 1 << log_lo),
                        torch.tensor(1.0, dtype=tdt))
    got = _emulate_strided(low.reshape(-1).clone(), log_n - log_lo, log_lo,
                           norm).view(2, n).numpy()
    np.testing.assert_array_equal(
        got, ref.fwht(torch.from_numpy(x), normalize=True).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jops.fwht(jnp.asarray(x), normalize=True, impl="ref")))


@pytest.mark.parametrize("log_r", range(1, LOG_MAX_N + 1))
def test_strided_layout_is_coalesced_and_fits(log_r):
    lay = _strided_layout(log_r)
    assert lay["smem_values"] * 8 <= SMEM_PER_BLOCK
    assert (32 << lay["log_w"]) * lay["tiles"] <= 1024
    assert (lay["phases"] == 1) == (log_r <= LOG_REGS)
    assert lay["log_cols"] == 5 or log_r > LOG_REGS + 5
    w = torch.arange(1 << lay["log_w"])[:, None, None]
    lane = torch.arange(32)[None, :, None]
    u = torch.arange(1 << lay["log_q"])[None, None, :]
    for p in range(lay["phases"]):
        at = min(p * lay["log_q"], lay["log_u"] - lay["log_q"])
        e = _strided_index(at, w, lane, u, lay["log_q"])
        assert torch.equal(e.reshape(-1).sort().values,
                           torch.arange(1 << (log_r + lay["log_cols"])))
        # a warp's 32 lanes on 32 consecutive slots: no bank conflicts in
        # the exchange, and one contiguous run of columns in device memory
        assert torch.equal(e.diff(dim=1), torch.ones_like(e[:, 1:]))


# ---------------------------------------------------------------------------
# srht_t_warp_kernel
# ---------------------------------------------------------------------------

def _emulate_srht_t(y, signs, rows, dim):
    """srht_t_warp_kernel on y (..., k)."""
    n, k = signs.shape[0], rows.shape[0]
    log_n = n.bit_length() - 1
    log_p = max(0, log_n - 5)
    p, log_l = 1 << log_p, log_n - log_p
    per_warp = 32 >> log_l
    norm = ref.norm_factor(n, y.dtype)
    scale = ref.subsample_scale(n, k, y.dtype)
    inv = torch.full((n,), -1, dtype=torch.int64)
    inv[rows] = torch.arange(k)
    lane = torch.arange(32)[:, None]
    q, slot = lane & ((1 << log_l) - 1), lane >> log_l
    j = q * p + torch.arange(p)[None, :]  # (32, P): the lane's coordinates
    src, sign = inv[j], signs[j]
    y2 = y.reshape(-1, k)
    nrows = y2.shape[0]
    groups = -(-nrows // per_warp)
    row = torch.arange(groups)[:, None, None] * per_warp + slot  # (G, 32, 1)
    live = row < nrows
    picked = y2[row.clamp(max=nrows - 1), src.clamp(min=0)]  # (G, 32, P)
    v = torch.where(live & (src >= 0), picked * scale, torch.zeros((), dtype=y.dtype))
    h = 1
    while h < p:
        v = _reg_stage(v, h)
        h *= 2
    m = 1
    while m < 1 << log_l:
        v = _lane_stage(v, m, lane)
        m *= 2
    out = torch.empty(nrows, dim, dtype=y.dtype)
    keep = live & (j < dim)
    out[row.expand_as(v)[keep], j.expand_as(v)[keep]] = ((v * norm) * sign)[keep]
    return out.view(y.shape[:-1] + (dim,))


SRHT_T_CASES = [(n, dim, k) for n in (1, 2, 4, 32, 64, 1024)
                for dim in sorted({n, max(1, n - n // 3)})
                for k in sorted({1, max(1, n // 2), n})]


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("n,dim,k", SRHT_T_CASES)
def test_srht_t_warp_emulation_bit_equal_to_ref(dt, tdt, n, dim, k):
    assert kfwht.kernel_route("srht_apply_t", n) == "srht_t_warp_kernel"
    rng = np.random.default_rng(n * 31 + dim + k)
    signs = rng.choice([-1.0, 1.0], n).astype(dt)
    rows = rng.permutation(n)[:k].astype(np.int64)
    for batch in ((5,), (3, 7), (1,)):
        y = rng.standard_normal(batch + (k,)).astype(dt)
        args = (torch.from_numpy(y), torch.from_numpy(signs),
                torch.from_numpy(rows), dim)
        got = _emulate_srht_t(*args).numpy()
        np.testing.assert_array_equal(got, ref.srht_apply_t(*args).numpy())
        np.testing.assert_array_equal(got, np.asarray(jops.srht_apply_t(
            jnp.asarray(y), jnp.asarray(signs), jnp.asarray(rows), dim,
            impl="ref")))


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

ROUTES = {
    "fwht": {1: "fwht_reg_kernel", 32: "fwht_reg_kernel",
             512: "fwht_reg_kernel",
             1024: "fwht_reg_kernel (shared-memory exchange)",
             1 << 14: "fwht_reg_kernel (shared-memory exchange)",
             1 << 15: "fwht_reg_kernel<2^12> + fwht_strided_kernel",
             1 << 16: "fwht_reg_kernel<2^12> + fwht_strided_kernel",
             1 << 17: "fwht_reg_kernel<2^12> + fwht_strided_kernel "
                      "(shared-memory exchange)",
             1 << 20: "fwht_reg_kernel<2^12> + fwht_strided_kernel "
                      "(shared-memory exchange)",
             1 << 27: "fwht_reg_kernel<2^13> + fwht_strided_kernel "
                      "(shared-memory exchange)",
             1 << 28: "fwht_reg_kernel<2^14> + fwht_strided_kernel "
                      "(shared-memory exchange)"},
    "srht_apply_t": {1: "srht_t_warp_kernel", 32: "srht_t_warp_kernel",
                     64: "srht_t_warp_kernel", 1024: "srht_t_warp_kernel",
                     2048: "srht_t_kernel", 1 << 14: "srht_t_kernel",
                     1 << 15: "srht_apply_t long-row path"},
    "srht_apply": {1: "srht_fwd_warp_kernel", 32: "srht_fwd_warp_kernel",
                   64: "srht_fwd_reg_kernel", 512: "srht_fwd_reg_kernel",
                   1024: "srht_fwd_reg_kernel (shared-memory exchange)",
                   1 << 14: "srht_fwd_reg_kernel (shared-memory exchange)",
                   1 << 15: "srht_apply long-row path"},
}


@pytest.mark.parametrize("op", sorted(ROUTES))
def test_kernel_route_is_pinned(op):
    for n, kernel in ROUTES[op].items():
        assert kfwht.kernel_route(op, n) == kernel, (op, n)


def test_route_constants_match_the_source():
    assert kfwht.SINGLE_PASS_N == 1 << _const("kLogMaxN")
    assert kfwht.REG_PHASE_N == 1 << (LOG_REGS + 5)
    assert kfwht.WARP_T_MAX_N == WARP_T_MAX_N
    assert kfwht.WARP_N == _const("kWarpN") == 1 << _const("kLogWarpN")
    assert kfwht.STRIDED_REG_ROWS == 1 << LOG_REGS
    assert kfwht.LOW_PASS_N == 1 << LOG_LOW_N
    # the forward register kernel's instantiations: kLogWarpN + 1 to kLogMaxN
    assert re.search(r"int LOG_N = kLogWarpN \+ 1>\ncudaError_t srht_fwd_reg\(", SRC)
    with pytest.raises(KeyError, match="no CUDA kernel route"):
        kfwht.kernel_route("topk_mask", 32)
