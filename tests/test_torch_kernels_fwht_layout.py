"""The register kernels of csrc/srht.cu, rehearsed on the host (the
kernels themselves run only on a Hopper card:
tests/test_torch_kernels_cuda.py).

* ``fwht_reg_kernel``: a plain-Python emulation of its index arithmetic
  in the formulas of the source (which lane and register hold which
  coordinate in each phase, the shuffle partner of each stage, the
  swizzled shared-memory exchange between phases), run on torch tensors,
  reproduces ``ref.fwht`` and the JAX reference bit for bit; the
  exchange is a permutation and free of bank conflicts;
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

def _layout(log_n: int, tdt: torch.dtype) -> dict:
    """RegFwht<T, LOG_N> of the source."""
    log_v = min(1 if tdt == torch.float64 else 2, log_n)
    bits = LOG_REGS + 5
    log_c = max(log_n, bits + LOG_MIN_WARPS)
    return dict(log_v=log_v, bits=bits, log_c=log_c, log_w=log_c - bits,
                phases=1 if log_n <= bits else -(-log_n // bits))


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
    v = flat[:, home]  # (chunks, W, 32, Q)
    m_prev = 0
    for p in range(lay["phases"]):
        m = min(p * lay["bits"], lay["log_w"])
        if p:
            v = _exchange(v, lay, x.dtype, _index(lay, m_prev, w, lane, u),
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
    if lay["phases"] > 1:
        v = _exchange(v, lay, x.dtype, _index(lay, m_prev, w, lane, u), home)
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
             1 << 15: "fwht_reg_kernel<2^14> + fwht_strided_kernel",
             1 << 20: "fwht_reg_kernel<2^14> + fwht_strided_kernel"},
    "srht_apply_t": {1: "srht_t_warp_kernel", 32: "srht_t_warp_kernel",
                     64: "srht_t_warp_kernel", 1024: "srht_t_warp_kernel",
                     2048: "srht_t_kernel", 1 << 14: "srht_t_kernel",
                     1 << 15: "srht_apply_t long-row path"},
    "srht_apply": {1: "srht_fwd_warp_kernel", 32: "srht_fwd_warp_kernel",
                   64: "srht_fwd_kernel", 1 << 14: "srht_fwd_kernel",
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
    assert kfwht.WARP_N == _const("kWarpN")
    with pytest.raises(KeyError, match="no CUDA kernel route"):
        kfwht.kernel_route("topk_mask", 32)
