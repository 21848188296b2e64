"""srht_apply_rows: the forward SRHT along the rows of A (G, n_rows, M),
one operator a client (FedNS's and FedNDES's data-axis sketch), on the
CPU.

On the card ``srht_rows_kernel`` reads A in place and computes only the
k kept outputs of each column's transform. Held here:

  * its arithmetic, emulated in plain torch: the low c butterfly stages
    of each leaf block of 2^c rows in full, then for each kept row r the
    leaf output r mod 2^c, the tree over a slab's leaves (bits c.. of r
    pick lower + upper or lower - upper), the binary counter over slabs
    (bits log2(slab).. of r) with the stored subtrees taken in at the
    last slab, leaves and slabs past the data skipped; ``torch.equal`` to
    the plain version in float64 and float32, at n from 64 to 8192, dims
    off a power of two, k = 1 and k = n, signs other than +1 and -1, and
    several slab sizes and values of c (the kernel's c is 4);
  * the op's plain version: bit-equal to the transposed form (the batched
    ``srht_apply`` on A's contiguous transpose, transposed back), through
    ``sketch_sqrt_rows`` too, and to the reference's ``sketch_sqrt_rows``
    under ``jax.vmap`` with the same operators;
  * the route rule (``fwht.rows_route``) and the kernel's geometry
    against the constants of ``csrc/srht.cu``; the shape checks.
"""
import pytest

torch = pytest.importorskip("torch")

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import sketch as jsketch
from repro_torch.core import sketch as tsketch
from repro_torch.kernels import fwht as kfwht
from repro_torch.kernels import ops, ref

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]
SRC = pathlib.Path(kfwht.__file__).resolve().parent / "csrc" / "srht.cu"


def _operators(rng, g, n, k, dt, unit=True):
    signs = (rng.choice([-1.0, 1.0], (g, n)) if unit
             else rng.standard_normal((g, n))).astype(dt)
    rows = np.stack([rng.permutation(n)[:k] for _ in range(g)]).astype(np.int64)
    return signs, rows


def _emulate_rows(a, signs, rows, log_c, log_r):
    """srht_rows_kernel's arithmetic: a (G, n_rows, M) in slabs of 2^log_r
    rows, leaf blocks of 2^log_c rows -> (G, k, M)."""
    g, n_rows, m = a.shape
    n, k = signs.shape[1], rows.shape[1]
    c, r = 1 << log_c, 1 << log_r

    def minus(b):  # bit b of each kept row, as a (G, k, 1) mask
        return ((rows >> b) & 1).bool()[:, :, None]

    def node(lo, hi, b):
        return torch.where(minus(b), lo - hi, lo + hi)
    slabs = -(-n_rows // r)
    stack = {}
    for s in range(slabs):
        i0 = s * r
        nr = min(r, n_rows - i0)
        leaves = -(-nr // c)
        x = a[:, i0:i0 + nr] * signs[:, i0:i0 + nr, None]
        x = torch.nn.functional.pad(x, (0, 0, 0, leaves * c - nr))
        part = ref.fwht(x.reshape(g, leaves, c, m).transpose(2, 3))
        pick = (rows & (c - 1))[:, None, None, :].expand(g, leaves, m, k)
        v = list(torch.gather(part, 3, pick).transpose(2, 3).unbind(1))
        v += [None] * (r // c - leaves)
        width, b = 1, log_c
        while width < r // c:  # the slab's leaves
            for j in range(0, r // c, 2 * width):
                if v[j + width] is not None:
                    v[j] = node(v[j], v[j + width], b)
            width, b = 2 * width, b + 1
        val, lvl = v[0], 0
        while (s >> lvl) & 1:  # the counter over slabs
            val = node(stack[lvl], val, log_r + lvl)
            lvl += 1
        stack[lvl] = val
    for up in range(lvl + 1, slabs.bit_length()):
        if (slabs >> up) & 1:
            val = node(stack[up], val, log_r + up)
    norm = ref.norm_factor(n, a.dtype)
    return val * norm * ref.subsample_scale(n, k, a.dtype)


# (G, n_rows, M, n, k, log_c, log_r): n from 64 to 8192, dims off a power
# of two and on one, k = 1 and k = n, a slab of one leaf and of many, the
# kernel's c = 4 and others, one slab and many (a counter of 1-6 levels,
# slab counts with and without a carry at the end), SUSY's and covtype's
# shapes cut in clients and columns
EMULATED = [
    (3, 54, 5, 64, 20, 2, 4), (2, 64, 3, 64, 64, 4, 6), (2, 61, 4, 64, 1, 4, 4),
    (3, 500, 7, 512, 32, 4, 6), (2, 512, 2, 512, 512, 4, 5),
    (2, 1000, 4, 1024, 1, 3, 5), (2, 1000, 3, 1024, 17, 5, 8),
    (2, 2906, 6, 4096, 20, 4, 6), (2, 5000, 3, 8192, 10, 4, 7),
    (2, 5000, 2, 8192, 10, 4, 4), (1, 8191, 2, 8192, 8192, 4, 8),
    (2, 200, 3, 256, 256, 5, 8), (3, 17, 9, 32, 7, 4, 4),
]


@pytest.mark.parametrize("unit", [True, False], ids=["pm1", "normal"])
@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("g,n_rows,m,n,k,log_c,log_r", EMULATED)
def test_kernel_emulation_bit_equal(dt, tdt, unit, g, n_rows, m, n, k, log_c,
                                    log_r):
    rng = np.random.default_rng(n_rows * 7 + k + log_r)
    signs, rows = _operators(rng, g, n, k, dt, unit)
    a = torch.from_numpy(rng.standard_normal((g, n_rows, m)).astype(dt))
    ts, tr = torch.from_numpy(signs), torch.from_numpy(rows)
    want = ref.srht_apply_rows(a, ts, tr)
    got = _emulate_rows(a, ts, tr, log_c, log_r)
    assert got.dtype == tdt and got.shape == (g, k, m)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("g,n_rows,m,n,k", [
    (4, 54, 5, 64, 20), (3, 500, 64, 512, 32), (2, 2906, 6, 4096, 20),
    (2, 5000, 18, 8192, 10), (1, 33, 2, 64, 64), (5, 20, 4, 32, 10)])
def test_plain_version_is_the_transposed_srht_apply(dt, tdt, g, n_rows, m, n,
                                                    k):
    """ops.srht_apply_rows on the CPU (the plain version), and
    sketch_sqrt_rows through it (m operators) or through srht_apply (one),
    against the batched srht_apply on A's contiguous transpose transposed
    back: the same values."""
    rng = np.random.default_rng(g + n_rows + k)
    signs, rows = _operators(rng, g, n, k, dt)
    a = torch.from_numpy(rng.standard_normal((g, n_rows, m)).astype(dt))
    ts, tr = torch.from_numpy(signs), torch.from_numpy(rows)
    want = ops.srht_apply(a.transpose(-1, -2).contiguous(), ts, tr,
                          impl="ref").transpose(-1, -2)
    before = ops.launch_counts()
    got = ops.srht_apply_rows(a, ts, tr)
    assert ops.launch_counts() == before  # the plain path launches nothing
    assert got.is_contiguous() and torch.equal(got, want)
    sketch = tsketch.BatchedSrhtSketch(k, n_rows, ts, tr)
    assert torch.equal(tsketch.sketch_sqrt_rows(sketch, a), want)
    one = tsketch.SrhtSketch(k, n_rows, ts[0], tr[0])
    assert torch.equal(tsketch.sketch_sqrt_rows(one, a[0]), want[0])


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("g,n_rows,m,n,k", [
    (3, 54, 5, 64, 20), (2, 500, 9, 512, 32), (2, 2906, 4, 4096, 20),
    (2, 5000, 3, 8192, 10)])
def test_plain_version_matches_the_reference_under_vmap(dt, tdt, g, n_rows, m,
                                                        n, k):
    """The reference's sketch_sqrt_rows of each client under jax.vmap,
    with the same operators injected: bit-equal (tolerance 0: both
    transform in the input dtype in the same op order)."""
    rng = np.random.default_rng(n + k)
    signs, rows = _operators(rng, g, n, k, dt)
    a = rng.standard_normal((g, n_rows, m)).astype(dt)

    def client(aj, s, r):
        return jsketch.sketch_sqrt_rows(jsketch.SrhtSketch(k, n_rows, s, r),
                                        aj)
    want = jax.vmap(client)(jnp.asarray(a), jnp.asarray(signs),
                            jnp.asarray(rows))
    got = ops.srht_apply_rows(*(torch.from_numpy(x) for x in (a, signs, rows)))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the route rule and the kernel's geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_rows,m,k,item,want", [
    (8192, 5000, 18, 10, 8, True),    # SUSY, FedNS
    (4096, 2906, 54, 20, 8, True),    # covtype
    (8192, 5000, 18, 10, 4, True),    # SUSY in float32
    (512, 500, 64, 32, 8, True),      # the quickstart
    (64, 54, 5, 64, 8, True),         # k = n at ROWS_MIN_N
    (16384, 16000, 3, 64, 8, True),   # SINGLE_PASS_N
    (32, 20, 4, 10, 8, False),        # below ROWS_MIN_N
    (1 << 15, 20000, 3, 10, 8, False),  # past SINGLE_PASS_N
    (8192, 5000, 18, 129, 8, False),  # past ROWS_MAX_K
    (4096, 2906, 54, 96, 8, False),   # a counter past the shared memory
    (8192, 8192, 4000, 10, 8, False),  # a slab's values past the shared memory
])
def test_route_rule(n, n_rows, m, k, item, want):
    route = kfwht.rows_route(n, n_rows, m, k, item)
    if want:
        assert route == "srht_rows_kernel"
    else:
        assert route == "transpose copy + " + kfwht.kernel_route("srht_apply", n)
    assert want == (kfwht.ROWS_MIN_N <= n <= kfwht.SINGLE_PASS_N
                    and k <= kfwht.ROWS_MAX_K
                    and kfwht.rows_geometry(n, n_rows, m, k, item)[1]
                    <= kfwht.ROWS_MAX_SMEM)


@pytest.mark.parametrize("n,n_rows,m,k,item,log_p,smem", [
    # SUSY: 256-row slabs (36.9 KB), 20 slabs, a counter of 5 levels
    (8192, 5000, 18, 10, 8, 4, 16 + 48 + 2 * 2048 + 2 * 36880 + 5 * 180 * 8),
    # covtype: 64-row slabs of 54 columns, 46 slabs
    (4096, 2906, 54, 20, 8, 2, 16 + 80 + 2 * 512 + 2 * 27664 + 6 * 1080 * 8),
    # float32 takes twice the rows; one slab needs no counter
    (8192, 5000, 18, 10, 4, 4, 16 + 48 + 2 * 1024 + 2 * 18448 + 5 * 180 * 4),
    (64, 54, 5, 64, 8, 2, 16 + 256 + 2 * 512 + 2 * 2576),
    # one leaf block a slab where a row is wide
    (1024, 1000, 300, 8, 8, 0, 16 + 32 + 2 * 128 + 2 * 38416 + 6 * 2400 * 8),
])
def test_geometry(n, n_rows, m, k, item, log_p, smem):
    assert kfwht.rows_geometry(n, n_rows, m, k, item) == (log_p, smem)


def test_geometry_is_the_sources():
    """The constants and the shared-memory layout rows_geometry mirrors,
    as csrc/srht.cu states them."""
    src = SRC.read_text()
    consts = dict(re.findall(r"constexpr int (kRows\w+) = (\d+);", src))
    assert 1 << int(consts["kRowsLogC"]) == kfwht.ROWS_LEAF
    assert int(consts["kRowsMaxLogP"]) == kfwht.ROWS_MAX_LOG_P
    assert int(consts["kRowsThreads"]) == kfwht.ROWS_THREADS
    for line in ("sel = 16;",
                 "signs = sel + ((size_t)k * 4 + 15) / 16 * 16;",
                 "slab = signs + 2 * (size_t)r * item;",
                 "slab_stride = ((size_t)r * m * item + 16 + 15) / 16 * 16;",
                 "stack = slab + 2 * slab_stride;",
                 "total = stack + (size_t)levels * k * m * item;",
                 "const int levels = log2_int((n_rows + R - 1) / R);",
                 "v[u] = i < p.rows ? col[u * m_feat] * sgn[i] : T(0);",
                 "const T* col = x + (r & (C - 1)) * m_feat + m;",
                 "if (j + (1 << b) < leaves) {",
                 "val = ((r >> (kLogR + l)) & 1) ? lo - val : lo + val;",
                 "for (++l; slabs >> l; ++l) {",
                 "out[(long long)blockIdx.x * outs + t] = h * scale;"):
        assert line in src, line


def test_shapes_are_checked():
    signs = torch.ones(3, 64, dtype=torch.float64)
    rows = torch.zeros(3, 4, dtype=torch.int64)
    for a, s, r in ((torch.ones(3, 50), signs, rows),  # not (G, n_rows, M)
                    (torch.ones(2, 50, 4), signs, rows),  # G mismatch
                    (torch.ones(3, 50, 4), signs[0], rows),  # 1-D signs
                    (torch.ones(3, 50, 4), signs, rows[:2])):
        with pytest.raises(ValueError):
            ops.srht_apply_rows(a.double(), s, r)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.srht_apply_rows(torch.ones(3, 50, 4, dtype=torch.float64), signs,
                            rows, impl="cuda")
