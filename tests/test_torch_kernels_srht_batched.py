"""srht_apply with one operator per client (FedNS, FedNDES), on the CPU.

The reference applies ``srht_apply`` under ``jax.vmap`` with per-client
``signs`` (m, n) and ``rows`` (m, k); the port's op takes the same
batched form, x (G, ..., dim), in one call (one kernel launch on the
card). Held here:

  * the plain batched version is bit-equal, slice by slice, to the
    one-operator plain version and, in float64 and float32, to
    ``repro.kernels.ref.srht_apply`` under ``jax.vmap``; the Pallas kernel
    in interpret mode under ``jax.vmap`` computes in float32 and folds the
    two scale factors into one, so it is held to the reference suite's
    own tolerance (``tests/test_kernels_srht.py``), on one small shape;
  * the CUDA register kernel's batched chunk schedule, emulated on the
    host: every operator's rows cut into its own chunks (none straddles
    two operators), each block a run of consecutive chunks, the per-chunk
    arithmetic of ``srht_fwd_reg_kernel`` (emulated in
    ``test_torch_kernels_fwht_layout.py``) applied with each chunk's own
    operator, bit-equal to the plain version at every 16-byte offset;
  * the op's shape checks, and the batched sampler ``make_sketches``
    (distinct rows per operator, exact S S^T, dense kinds through one
    ``torch.bmm``).
"""
import pytest

torch = pytest.importorskip("torch")

import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import sketch as tsketch
from repro_torch.kernels import fwht as kfwht
from repro_torch.kernels import ops, ref
from repro_torch.keys import key_from_ints

from test_torch_kernels_fwht_layout import _emulate_srht_fwd, _srht_fwd_layout
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]

# (G, inner batch, dim, n, k): every forward route (n <= 32, 33..2^14,
# past 2^14), x (G, dim) and (G, R, dim), odd groups, k = 1 and k = n, the
# three FedNS shapes cut in clients
CASES = [
    (5, (), 18, 32, 10), (3, (7,), 30, 32, 32), (4, (3,), 1, 1, 1),
    (6, (9,), 500, 512, 32), (3, (54,), 2906 // 8, 512, 20),
    (2, (3,), 5000, 8192, 10), (7, (5,), 63, 64, 1), (3, (2,), 64, 64, 64),
    (2, (3, 2), 100, 128, 7), (2, (1,), 20000, 1 << 15, 64),
]


def _operators(rng, g, n, k, dt):
    signs = rng.choice([-1.0, 1.0], (g, n)).astype(dt)
    rows = np.stack([rng.permutation(n)[:k] for _ in range(g)]).astype(np.int64)
    return signs, rows


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("g,inner,dim,n,k", CASES)
def test_batched_plain_is_the_one_operator_version_per_slice(dt, tdt, g, inner,
                                                            dim, n, k):
    rng = np.random.default_rng(g * 131 + dim + k)
    signs, rows = _operators(rng, g, n, k, dt)
    x = rng.standard_normal((g,) + inner + (dim,)).astype(dt)
    tx, ts, tr = (torch.from_numpy(a) for a in (x, signs, rows))
    got = ops.srht_apply(tx, ts, tr)
    assert got.shape == (g,) + inner + (k,) and got.dtype == tdt
    for j in range(g):
        assert torch.equal(got[j], ref.srht_apply(tx[j], ts[j], tr[j]))
    want = jax.vmap(lambda a, s, r: jref.srht_apply(a, s, r))(
        jnp.asarray(x), jnp.asarray(signs), jnp.asarray(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dt,tdt", DTYPES)
def test_batched_plain_takes_any_signs(dt, tdt):
    """Signs other than +1 and -1 (normal draws, with an exact +1, -1 and
    -0.0): each slice bit-equal to the one-operator version."""
    rng = np.random.default_rng(5)
    g, n, k, dim = 4, 64, 20, 54
    signs = rng.standard_normal((g, n)).astype(dt)
    signs[:, :3] = [1.0, -1.0, -0.0]
    rows = np.stack([rng.permutation(n)[:k] for _ in range(g)])
    x = torch.from_numpy(rng.standard_normal((g, 11, dim)).astype(dt))
    ts, tr = torch.from_numpy(signs), torch.from_numpy(rows)
    got = ops.srht_apply(x, ts, tr)
    for j in range(g):
        assert torch.equal(got[j], ref.srht_apply(x[j], ts[j], tr[j]))


def test_batched_plain_against_the_pallas_kernel_interpreted():
    """One small shape through ``srht_apply_pallas`` in interpret mode
    under ``jax.vmap`` (float32 inside the kernel, one folded scale):
    the reference suite's tolerance, rtol 2e-4 and atol 2e-4 sqrt(n)."""
    rng = np.random.default_rng(9)
    g, n, k, dim = 3, 64, 8, 40
    signs, rows = _operators(rng, g, n, k, np.float32)
    x = rng.standard_normal((g, 5, dim)).astype(np.float32)
    want = jax.vmap(lambda a, s, r: jops.srht_apply(a, s, r, impl="interpret"))(
        jnp.asarray(x), jnp.asarray(signs), jnp.asarray(rows))
    got = ops.srht_apply(*(torch.from_numpy(a) for a in (x, signs, rows)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4 * n ** 0.5)


# ---------------------------------------------------------------------------
# the register kernel's batched chunk schedule (srht_fwd_reg_kernel)
# ---------------------------------------------------------------------------

def _schedule(nrows: int, group: int, r_chunk: int, blocks: int):
    """launch_srht_fwd_reg and srht_fwd_reg_kernel's chunk arithmetic:
    (block, chunk, operator, first row, rows, set up) in launch order.
    Below kFwdWaveN the grid is a block a chunk, blocks = chunks, where
    the run formula gives block b chunk b. (One operator takes the
    grid-stride loop of the parent kernel: group = nrows.)"""
    per_op = -(-group // r_chunk)
    nchunks = nrows // group * per_op
    out = []
    for b in range(blocks):
        first, last = b * nchunks // blocks, (b + 1) * nchunks // blocks
        for ci in range(first, last):
            g = ci // per_op
            c_in = ci - g * per_op
            setup = ci == first or c_in == 0
            r_in = c_in * r_chunk
            out.append((b, ci, g, g * group + r_in, min(r_chunk, group - r_in),
                        setup))
    return out


@pytest.mark.parametrize("group,ops_,r_chunk,blocks", [
    (18, 1000, 1, 264), (18, 100, 1, 1800), (64, 8, 8, 64), (64, 8, 8, 5),
    (13, 7, 4, 3), (1, 9, 16, 9), (100, 1, 32, 4), (54, 200, 8, 264)])
def test_batched_chunk_schedule_covers_each_row_once(group, ops_, r_chunk,
                                                     blocks):
    nrows = group * ops_
    sched = _schedule(nrows, group, r_chunk, blocks)
    seen = np.zeros(nrows, dtype=int)
    for b, ci, g, r0, rows, setup in sched:
        assert 1 <= rows <= r_chunk
        assert g * group <= r0 and r0 + rows <= (g + 1) * group  # no straddle
        seen[r0:r0 + rows] += 1
    assert (seen == 1).all()
    # a block walks one operator's chunks before the next's: it sets each
    # operator up at most once, and the grid sets up each operator at most
    # once per block that holds some of its chunks
    for b in range(blocks):
        ops_seen = [g for bb, _, g, _, _, s in sched if bb == b and s]
        assert ops_seen == sorted(set(ops_seen))
    setups = sum(s for *_, s in sched)
    assert ops_ <= setups <= ops_ + blocks - 1


def test_batched_chunk_schedule_is_the_sources():
    """The formulas _schedule mirrors, as the source states them."""
    src = (pathlib.Path(kfwht.__file__).resolve().parent / "csrc"
           / "srht.cu").read_text()
    for line in ("const long long per_op = (group + S::kRows - 1) / S::kRows;",
                 "const long long chunks = nrows / group * per_op;",
                 "} else if constexpr (n < kFwdWaveN) {  // a block a chunk",
                 "transform(blockIdx.x, set_up(blockIdx.x / chunks_per_op), 0);",
                 "const int first = (int)((long long)blockIdx.x * nchunks / gridDim.x);",
                 "const int last = (int)((long long)(blockIdx.x + 1) * nchunks / gridDim.x);",
                 "bool by_bit = set_up(first / chunks_per_op);",
                 "if (next < last && next % chunks_per_op == 0) by_bit = set_up(next / chunks_per_op);",
                 "const int g = ci / chunks_per_op;",
                 "r0 = (long long)g * group + r_in;",
                 "rows = (int)min((long long)S::kRows, group - r_in);"):
        assert line in src, line


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("n,dim,k,group", [(64, 54, 20, 13), (64, 61, 64, 1),
                                           (512, 500, 32, 9),
                                           (1024, 1000, 17, 3)])
def test_batched_register_kernel_emulation_bit_equal(dt, tdt, n, dim, k, group):
    """Each chunk of the schedule through the emulated register kernel
    with its own operator, x at every 16-byte offset: bit-equal to the
    plain batched version."""
    rng = np.random.default_rng(n + group)
    ops_ = 3
    signs, rows = _operators(rng, ops_, n, k, dt)
    x = rng.standard_normal((ops_, group, dim)).astype(dt)
    tx, ts, tr = (torch.from_numpy(a) for a in (x, signs, rows))
    want = ref.srht_apply(tx, ts, tr)
    r_chunk = _srht_fwd_layout(n.bit_length() - 1, tdt)["rows"]
    item = np.dtype(dt).itemsize
    flat = tx.reshape(-1, dim)
    for offset in range(0, 16, item):
        got = torch.full_like(want.reshape(-1, k), float("nan"))
        for _, _, g, r0, nr, _ in _schedule(ops_ * group, group, r_chunk, 2):
            addr = offset + r0 * dim * item
            got[r0:r0 + nr] = _emulate_srht_fwd(flat[r0:r0 + nr], ts[g], tr[g],
                                                addr % 16)
        assert torch.equal(got.view_as(want), want)


# ---------------------------------------------------------------------------
# checks and the batched sampler
# ---------------------------------------------------------------------------

def test_batched_shapes_are_checked():
    signs = torch.ones(3, 8, dtype=torch.float64)
    rows = torch.zeros(3, 2, dtype=torch.int64)
    for x, s, r in ((torch.ones(2, 5, 8), signs, rows),  # G mismatch
                    (torch.ones(8), signs, rows),  # no leading axis
                    (torch.ones(3, 8), signs, rows[0]),  # rows 1-D
                    (torch.ones(3, 8), signs[:2], rows)):
        with pytest.raises(ValueError, match="batched operators"):
            ops.srht_apply(x.double(), s, r)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.srht_apply(torch.ones(3, 8, dtype=torch.float64), signs,
                       rows, impl="cuda")


def test_make_sketches_draws_distinct_rows_and_exact_srht():
    key = key_from_ints(4, 2)
    s = tsketch.make_sketches(key, "srht", 50, 16, 64, dtype=torch.float64,
                              device="cpu")
    assert s.signs.shape == (50, 64) and s.rows.shape == (50, 16)
    srt = torch.sort(s.rows, dim=1).values
    assert (srt[:, 1:] != srt[:, :-1]).all()
    assert ((s.signs == 1) | (s.signs == -1)).all()
    # pure in the key; S_j S_j^T = (n/k) I exactly for dim = n
    again = tsketch.make_sketches(key, "srht", 50, 16, 64, dtype=torch.float64,
                                  device="cpu")
    assert torch.equal(again.rows, s.rows) and torch.equal(again.signs, s.signs)
    for j in (0, 49):
        one = tsketch.SrhtSketch(16, 64, s.signs[j], s.rows[j])
        sst = one.apply(one.apply_t(torch.eye(16, dtype=torch.float64)))
        torch.testing.assert_close(sst, 4.0 * torch.eye(16, dtype=torch.float64),
                                   rtol=0, atol=1e-12)
    # different operators across clients
    assert not torch.equal(s.rows[0], s.rows[1])
    with pytest.raises(ValueError, match="SRHT needs"):
        tsketch.make_sketches(key, "srht", 2, 65, 64, device="cpu")


@pytest.mark.parametrize("kind", ["gaussian", "sjlt"])
def test_dense_batched_sketches_apply_by_one_bmm(kind):
    s = tsketch.make_sketches(key_from_ints(1), kind, 6, 5, 30,
                              dtype=torch.float64, device="cpu")
    assert s.mat.shape == (6, 5, 30) and s.kind == kind
    x = torch.randn(6, 4, 30, dtype=torch.float64)
    got = s.apply(x)
    for j in range(6):
        torch.testing.assert_close(got[j], x[j] @ s.mat[j].T, rtol=1e-14,
                                   atol=1e-14)
    a = torch.randn(6, 30, 3, dtype=torch.float64)
    sa = tsketch.sketch_sqrt_rows(s, a)
    assert sa.shape == (6, 5, 3)
    torch.testing.assert_close(sa[2], s.mat[2] @ a[2], rtol=1e-14, atol=1e-14)
    if kind == "sjlt":  # min(4, k) nonzeros a column, +-1/2
        assert ((s.mat != 0).sum(dim=1) <= 4).all()


def test_sketch_sqrt_rows_one_and_many_operators():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((3, 20, 4)))
    signs, rows = _operators(rng, 3, 32, 6, np.float64)
    many = tsketch.BatchedSrhtSketch(6, 20, torch.from_numpy(signs),
                                     torch.from_numpy(rows))
    sa = tsketch.sketch_sqrt_rows(many, a)
    assert sa.shape == (3, 6, 4)
    for j in range(3):
        one = tsketch.SrhtSketch(6, 20, many.signs[j], many.rows[j])
        assert torch.equal(sa[j], tsketch.sketch_sqrt_rows(one, a[j]))
