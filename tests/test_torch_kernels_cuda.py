"""repro_torch's CUDA kernels against their plain versions, on a Hopper
card; every test here skips elsewhere. The file imports no JAX, so it
runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

The kernels are built with -fmad=false and keep the plain versions' op
order, so they are required to be bit-equal to them.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops

# (dim, n, k, batch): power-of-two and padded dims, batched leading axes,
# row counts that do not fill the last block,
# the quickstart's shapes (64 -> 32) and the full-size SUSY shape
# (1000 clients x 5000 rows, 18 -> 10); n = 16384 is the largest
# single-pass transform (128 KB of shared memory in float64), longer rows
# take the two-pass path
CASES = [(64, 64, 32, (3,)), (18, 32, 10, (2, 5)), (100, 128, 7, (4,)),
         (1, 1, 1, (2,)), (300, 512, 100, (2, 3)), (64, 64, 32, (8, 500)),
         (18, 32, 10, (1000, 5000)), (10000, 16384, 50, (3,)),
         (20000, 1 << 15, 64, (3,)), ((1 << 17) - 5, 1 << 17, 300, (2,)),
         (1 << 20, 1 << 20, 1000, (1,)),
         # every width of the register path (n <= 32), ragged row counts
         (2, 2, 1, (3,)), (3, 4, 2, (33,)), (5, 8, 3, (7, 9)),
         (16, 16, 16, (5,)), (20, 32, 32, (129,))]


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0)[0] < 9:
        pytest.skip("needs a Hopper card (compute capability 9.x)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim,n,k,batch", CASES)
def test_cuda_kernels_bit_equal_to_plain(hopper, tdt, dim, n, k, batch):
    g = torch.Generator(device=hopper).manual_seed(dim + k)
    x = torch.randn(batch + (dim,), generator=g, dtype=tdt, device=hopper)
    y = torch.randn(batch + (k,), generator=g, dtype=tdt, device=hopper)
    signs = (2 * torch.randint(0, 2, (n,), generator=g, device=hopper)
             - 1).to(tdt)
    rows = torch.randperm(n, generator=g, device=hopper)[:k]
    assert torch.equal(ops.srht_apply(x, signs, rows, impl="cuda"),
                       ops.srht_apply(x, signs, rows, impl="ref"))
    assert torch.equal(ops.srht_apply_t(y, signs, rows, dim, impl="cuda"),
                       ops.srht_apply_t(y, signs, rows, dim, impl="ref"))
    xp = torch.randn(batch + (n,), generator=g, dtype=tdt, device=hopper)
    for normalize in (False, True):
        assert torch.equal(ops.fwht(xp, normalize=normalize, impl="cuda"),
                           ops.fwht(xp, normalize=normalize, impl="ref"))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_kernels_count_launches(hopper):
    x = torch.randn(3, 18, dtype=torch.float64, device=hopper)
    signs = torch.ones(32, dtype=torch.float64, device=hopper)
    rows = torch.arange(10, device=hopper)
    ops.reset_launch_counts()
    ops.srht_apply(x, signs, rows)
    ops.srht_apply_t(ops.srht_apply(x, signs, rows), signs, rows, 18)
    ops.fwht(torch.zeros(2, 32, device=hopper, dtype=torch.float64))
    ops.topk_mask(x, 4)
    ops.qint8_roundtrip(x, torch.rand_like(x))
    ops.qint8_roundtrip(x, torch.rand_like(x), impl="ref")
    assert ops.launch_counts() == {"fwht": 1, "srht_apply": 2,
                                   "srht_apply_t": 1, "topk_mask": 1,
                                   "qint8_roundtrip": 1}


@pytest.mark.gpu
def test_cuda_kernels_reject_what_they_do_not_take(hopper):
    x = torch.randn(4, 18, dtype=torch.float64, device=hopper)
    signs = torch.ones(32, dtype=torch.float64, device=hopper)
    rows = torch.arange(10, device=hopper)
    with pytest.raises(ValueError, match="contiguous"):
        ops.srht_apply(x.T.contiguous().T, signs, rows, impl="cuda")
    with pytest.raises(TypeError, match="signs"):
        ops.srht_apply(x, signs.float(), rows, impl="cuda")
    with pytest.raises(TypeError, match="int64"):
        ops.srht_apply(x, signs, rows.int(), impl="cuda")
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.fwht(torch.zeros(2, 8, dtype=torch.float16, device=hopper),
                 impl="cuda")
    with pytest.raises(ValueError, match="power of two"):
        ops.fwht(torch.zeros(1, 24, device=hopper), impl="cuda")
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.topk_mask(x.half(), 2, impl="cuda")
    with pytest.raises(TypeError, match="must match"):
        ops.qint8_roundtrip(x, x.float(), impl="cuda")
    with pytest.raises(ValueError, match="kept"):
        ops.topk_mask(x, 19, impl="cuda")


# (rows, P): the main path's payloads (sympack-packed 10x10, sg, grad,
# a crushed 10x10, one broadcast), ragged widths, and rows long enough
# to be streamed from device memory instead of cached in shared memory
CODEC_SHAPES = [(1000, 55), (1000, 10), (1000, 18), (1000, 100), (1, 18),
                (7, 1), (5, 33), (3, 1000), (2, 5000), (4, 1 << 20)]


def _codec_inputs(hopper, tdt, rows, p, seed):
    g = torch.Generator(device=hopper).manual_seed(seed)
    x = torch.randn(rows, p, generator=g, dtype=tdt, device=hopper)
    x = x * 10.0 ** torch.randint(-3, 4, (rows, 1), generator=g,
                                  device=hopper).to(tdt)
    x[0] = torch.randint(-3, 4, (p,), generator=g, device=hopper).to(tdt)
    if rows > 1:
        x[1] = 0.0
    u = torch.rand(rows, p, generator=g, dtype=tdt, device=hopper)
    return x, u


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows,p", CODEC_SHAPES)
def test_codec_kernels_bit_equal_to_plain(hopper, tdt, rows, p):
    x, u = _codec_inputs(hopper, tdt, rows, p, rows + p)
    for kept in sorted({1, max(1, p // 10), max(1, p // 2), p}):
        got = ops.topk_mask(x, kept, impl="cuda")
        assert torch.equal(got, ops.topk_mask(x, kept, impl="ref"))
        assert int((got != 0).sum(dim=1).max()) <= kept
    assert torch.equal(ops.qint8_roundtrip(x, u, impl="cuda"),
                       ops.qint8_roundtrip(x, u, impl="ref"))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_topk_kernel_breaks_ties_by_index(hopper):
    x = torch.tensor([[1.0, -1.0, 0.5, 1.0], [0.5, -0.5, 0.5, 0.25],
                      [0.0, -0.0, 0.0, 0.0]], dtype=torch.float64,
                     device=hopper)
    for kept in range(1, 5):
        assert torch.equal(ops.topk_mask(x, kept, impl="cuda"),
                           ops.topk_mask(x, kept, impl="ref"))
    wide = torch.ones(3, 700, dtype=torch.float64, device=hopper)
    got = ops.topk_mask(wide, 300, impl="cuda")
    assert torch.equal((got != 0).nonzero()[:, 1].reshape(3, 300),
                       torch.arange(300, device=hopper).expand(3, 300))
