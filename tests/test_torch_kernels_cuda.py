"""repro_torch's CUDA kernels against their plain versions, on a Hopper
card; every test here skips elsewhere. The file imports no JAX, so it
runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

The SRHT and codec kernels are built with -fmad=false and keep the plain
versions' op order, so they are required to be bit-equal to them; the
flash-attention kernels sum in their own order and are held to a
tolerance (float32 2e-5, bfloat16 2e-2: one to two bfloat16 ulps of the
output). bfloat16 cases take the tensor-core kernel (route "sm90"),
float32 cases the 3xTF32 tensor-core kernel (route "tf32x3").
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

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
         (16, 16, 16, (5,)), (20, 32, 32, (129,)),
         # both sides of each route boundary (fwht.kernel_route), k = 1
         # and k = n: the register transpose to n = 1024, fwht without
         # shared memory to n = 512, with one exchange from n = 1024
         (2, 2, 2, (5,)), (32, 32, 1, (33,)), (32, 32, 32, (33,)),
         (64, 64, 1, (9,)), (61, 64, 64, (9,)), (512, 512, 256, (5,)),
         (1000, 1024, 1, (3,)), (1024, 1024, 1024, (3,)),
         (2048, 2048, 100, (2,)), (16384, 16384, 1, (2,)),
         (16383, 16384, 16384, (2,)),
         # covtype's and phishing's main-path shapes (A_j, gradients,
         # S^T I_k: 54 -> 64 and 68 -> 128, the register forward route),
         # dims just under n, and both sides of 32 | 64 and 2^14 | 2^15
         (54, 64, 20, (200, 2906)), (54, 64, 20, (200,)), (54, 64, 20, (20,)),
         (68, 128, 17, (40, 277)), (68, 128, 17, (40,)), (68, 128, 17, (17,)),
         (31, 32, 20, (65,)), (63, 64, 20, (65,)), (127, 128, 17, (33,)),
         (16383, 16384, 20, (3,)), (32768, 32768, 1, (2,)),
         # more chunks of n = 8192 than one wave of resident blocks: each
         # block of the forward register kernel walks several
         (5000, 8192, 10, (2000,))]


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


# (operators G, rows a operator as an inner batch, dim, n, k): batched
# srht_apply, one operator per leading index, on every forward route (n <=
# 32, 33..2^14, past 2^14): one row an operator, odd groups, groups that
# straddle a chunk of the register kernel (13 rows of n = 64, whose chunks
# hold 64 rows), k = 1 and k = n, and the three FedNS shapes (cut in
# operators)
BATCHED = [(5, (1,), 18, 32, 10), (7, (3,), 30, 32, 1), (3, (33,), 32, 32, 32),
           (9, (13,), 54, 64, 20), (4, (65,), 63, 64, 64), (3, (7,), 500, 512, 1),
           (6, (64,), 500, 512, 32), (3, (54,), 2906, 4096, 20),
           (11, (18,), 5000, 8192, 10), (2, (3,), 16383, 16384, 16384),
           (3, (2,), 20000, 1 << 15, 64), (2, (1,), (1 << 17) - 5, 1 << 17, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("g,inner,dim,n,k", BATCHED)
def test_batched_srht_apply_bit_equal_to_plain(hopper, tdt, g, inner, dim, n,
                                               k):
    gen = torch.Generator(device=hopper).manual_seed(g + dim + k)
    x = torch.randn((g,) + inner + (dim,), generator=gen, dtype=tdt,
                    device=hopper)
    signs = (2 * torch.randint(0, 2, (g, n), generator=gen, device=hopper)
             - 1).to(tdt)
    rows = torch.stack([torch.randperm(n, generator=gen, device=hopper)[:k]
                        for _ in range(g)])
    before = ops.launch_counts()["srht_apply"]
    got = ops.srht_apply(x, signs, rows, impl="cuda")
    assert ops.launch_counts()["srht_apply"] == before + 1  # one launch
    want = ops.srht_apply(x, signs, rows, impl="ref")
    assert torch.equal(got, want)
    # signs other than +1 and -1 (each operator's own), and x off a
    # 16-byte boundary
    signs = torch.randn((g, n), generator=gen, dtype=tdt, device=hopper)
    signs[:, 0] = -0.0
    assert torch.equal(ops.srht_apply(x, signs, rows, impl="cuda"),
                       ops.srht_apply(x, signs, rows, impl="ref"))
    flat = torch.randn(x.numel() + 1, generator=gen, dtype=tdt, device=hopper)
    xv = flat[1:].view(x.shape)
    assert xv.data_ptr() % 16
    assert torch.equal(ops.srht_apply(xv, signs, rows, impl="cuda"),
                       ops.srht_apply(xv, signs, rows, impl="ref"))
    torch.cuda.synchronize()


# (G, n_rows, M, n, k): srht_rows_kernel (srht_apply_rows read in place):
# the three FedNS shapes (SUSY's, covtype's, the quickstart's), one
# client, k = 1 and k = n, n_rows off and on a power of two and under one
# slab, a row wider than a slab of 32 KB, the longest single-pass n, and a
# k past the route's limit (the kernel takes it when called alone)
ROWS = [(1000, 5000, 18, 8192, 10), (200, 2906, 54, 4096, 20),
        (8, 500, 64, 512, 32), (1, 5000, 18, 8192, 10), (3, 100, 7, 128, 1),
        (2, 64, 5, 64, 64), (4, 61, 3, 64, 64), (5, 13, 4, 16, 16),
        (3, 1024, 6, 1024, 200), (2, 1000, 300, 1024, 8),
        (2, 16383, 2, 16384, 20), (2, 300, 3, 512, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("g,n_rows,m,n,k", ROWS)
def test_srht_rows_kernel_bit_equal_to_plain(hopper, tdt, g, n_rows, m, n, k):
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import srht as ksrht

    gen = torch.Generator(device=hopper).manual_seed(g + n_rows + k)
    a = torch.randn(g, n_rows, m, generator=gen, dtype=tdt, device=hopper)
    signs = (2 * torch.randint(0, 2, (g, n), generator=gen, device=hopper)
             - 1).to(tdt)
    rows = torch.stack([torch.randperm(n, generator=gen, device=hopper)[:k]
                        for _ in range(g)])
    want = ops.srht_apply_rows(a, signs, rows, impl="ref")
    before = ops.launch_counts()
    got = ksrht.srht_rows_kernel(a, signs, rows)
    after = ops.launch_counts()
    assert (after["srht_apply"] - before["srht_apply"],
            after["srht_apply_rows"] - before["srht_apply_rows"]) == (1, 1)
    assert got.shape == (g, k, m) and got.is_contiguous()
    assert torch.equal(got, want)
    # every slab the kernel has that fits
    item = a.element_size()
    for log_p in range(kfwht.ROWS_MAX_LOG_P + 1):
        if (kfwht.ROWS_LEAF << log_p <= n and kfwht.rows_smem(
                log_p, n_rows, m, k, item) <= kfwht.ROWS_MAX_SMEM):
            assert torch.equal(ksrht.srht_rows_kernel(a, signs, rows,
                                                      log_p=log_p), want)
    # the op by its route
    route = kfwht.rows_route(n, n_rows, m, k, item)
    before = ops.launch_counts()
    assert torch.equal(ops.srht_apply_rows(a, signs, rows, impl="cuda"), want)
    after = ops.launch_counts()
    assert after["srht_apply"] - before["srht_apply"] == 1
    assert after["srht_apply_rows"] - before["srht_apply_rows"] == (
        route == "srht_rows_kernel")
    # signs other than +1 and -1, and a off a 16-byte boundary
    signs = torch.randn((g, n), generator=gen, dtype=tdt, device=hopper)
    signs[:, 0] = -0.0
    want = ops.srht_apply_rows(a, signs, rows, impl="ref")
    assert torch.equal(ksrht.srht_rows_kernel(a, signs, rows), want)
    flat = torch.randn(a.numel() + 1, generator=gen, dtype=tdt, device=hopper)
    av = flat[1:].view(a.shape)
    assert av.data_ptr() % 16
    assert torch.equal(ksrht.srht_rows_kernel(av, signs, rows),
                       ops.srht_apply_rows(av, signs, rows, impl="ref"))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_srht_rows_kernel_rejects_what_it_cannot_take(hopper):
    from repro_torch.kernels import srht as ksrht

    a = torch.randn(3, 40, 4, dtype=torch.float64, device=hopper)
    signs = torch.ones(3, 64, dtype=torch.float64, device=hopper)
    rows = torch.zeros(3, 5, dtype=torch.int64, device=hopper)
    with pytest.raises(ValueError, match="batched operators"):
        ksrht.srht_rows_kernel(a[:2], signs, rows)
    with pytest.raises(ValueError, match="G, n_rows, M"):
        ksrht.srht_rows_kernel(a[0], signs, rows)
    with pytest.raises(ValueError, match="contiguous"):
        ksrht.srht_rows_kernel(a.transpose(1, 2), signs[:, :4], rows)
    with pytest.raises(ValueError, match="need 1 <= k <= n"):
        ksrht.srht_rows_kernel(torch.randn(3, 65, 4, dtype=torch.float64,
                                           device=hopper), signs, rows)
    with pytest.raises(TypeError, match="signs"):
        ksrht.srht_rows_kernel(a, signs.float(), rows)
    with pytest.raises(ValueError, match="log_p"):  # a slab past n rows
        ksrht.srht_rows_kernel(a, signs, rows, log_p=3)
    with pytest.raises(ValueError, match="shared memory"):  # a wide row
        ksrht.srht_rows_kernel(torch.randn(3, 40, 5000, dtype=torch.float64,
                                           device=hopper), signs, rows)
    with pytest.raises(ValueError, match="power of two"):
        ksrht.srht_rows_kernel(a, torch.ones(3, 48, dtype=torch.float64,
                                             device=hopper), rows)


@pytest.mark.gpu
def test_batched_srht_apply_rejects_what_it_cannot_take(hopper):
    from repro_torch.kernels import srht as ksrht

    x = torch.randn(3, 4, 40, dtype=torch.float64, device=hopper)
    signs = torch.ones(3, 64, dtype=torch.float64, device=hopper)
    rows = torch.zeros(3, 5, dtype=torch.int64, device=hopper)
    with pytest.raises(ValueError, match="batched operators"):
        ksrht.srht_apply_cuda(x[:2], signs, rows)
    with pytest.raises(ValueError, match="1-D"):
        ksrht.srht_apply_t_cuda(torch.randn(3, 5, dtype=torch.float64,
                                            device=hopper), signs, rows, 40)


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
def test_fwht_takes_a_view_off_a_16_byte_boundary(hopper, tdt):
    flat = torch.randn(1 + 6 * 32, dtype=tdt, device=hopper)
    x = flat[1:].view(6, 32)  # one element in: the kernel loads 16 bytes
    assert x.data_ptr() % 16
    assert torch.equal(ops.fwht(x, normalize=True, impl="cuda"),
                       ops.fwht(x, normalize=True, impl="ref"))


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim,n,k,batch", [(54, 64, 20, (200, 37)),
                                           (68, 128, 17, (33,)),
                                           (1023, 1024, 50, (3,)),
                                           (16383, 16384, 20, (2,)),
                                           (18, 32, 10, (40,))])
def test_srht_apply_takes_a_view_off_a_16_byte_boundary(hopper, tdt, dim, n,
                                                        k, batch):
    g = torch.Generator(device=hopper).manual_seed(dim)
    signs = (2 * torch.randint(0, 2, (n,), generator=g, device=hopper)
             - 1).to(tdt)
    rows = torch.randperm(n, generator=g, device=hopper)[:k]
    per = 16 // torch.empty((), dtype=tdt).element_size()
    count = dim
    for b in batch:
        count *= b
    flat = torch.randn(count + per, generator=g, dtype=tdt, device=hopper)
    for off in range(1, per):  # the kernel copies the slab's aligned middle
        x = flat[off:off + count].view(batch + (dim,))
        assert x.data_ptr() % 16
        assert torch.equal(ops.srht_apply(x, signs, rows, impl="cuda"),
                           ops.srht_apply(x, signs, rows, impl="ref"))


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim,n,k,batch", [(18, 32, 10, (40,)),
                                           (54, 64, 20, (300,)),
                                           (1023, 1024, 50, (9,)),
                                           (5000, 8192, 10, (700,)),
                                           (16383, 16384, 20, (3,)),
                                           (20000, 1 << 15, 64, (2,))])
def test_srht_kernels_take_signs_other_than_plus_minus_one(hopper, tdt, dim,
                                                           n, k, batch):
    g = torch.Generator(device=hopper).manual_seed(dim + 1)
    signs = torch.randn(n, generator=g, dtype=tdt, device=hopper)
    signs[:3] = torch.tensor([1.0, -1.0, -0.0], dtype=tdt)
    rows = torch.randperm(n, generator=g, device=hopper)[:k]
    x = torch.randn(batch + (dim,), generator=g, dtype=tdt, device=hopper)
    y = torch.randn(batch + (k,), generator=g, dtype=tdt, device=hopper)
    assert torch.equal(ops.srht_apply(x, signs, rows, impl="cuda"),
                       ops.srht_apply(x, signs, rows, impl="ref"))
    assert torch.equal(ops.srht_apply_t(y, signs, rows, dim, impl="cuda"),
                       ops.srht_apply_t(y, signs, rows, dim, impl="ref"))


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
    q = torch.randn(1, 16, 4, 64, device=hopper)
    kv = torch.randn(1, 16, 2, 64, device=hopper)
    ops.flash_attention(q, kv, kv)
    ops.flash_attention(q, kv, kv, impl="ref")
    qg = q.clone().requires_grad_(True)
    ops.flash_attention(qg, kv, kv).sum().backward()
    assert ops.launch_counts() == {"fwht": 1, "srht_apply": 2,
                                   "srht_apply_t": 1, "srht_apply_rows": 0,
                                   "topk_mask": 1,
                                   "qint8_roundtrip": 1,
                                   "flash_attention": 2,
                                   "flash_attention_sm90": 0,
                                   "flash_attention_tf32x3": 2,
                                   "flash_attention_bwd": 1,
                                   "flash_attention_bwd_tf32x3": 1,
                                   "flash_attention_bwd_tf32x3_delta": 1,
                                   "flash_attention_bwd_tf32x3_dkdv": 1,
                                   "flash_attention_bwd_tf32x3_dq": 1,
                                   "flash_attention_bwd_tf32x3_sum": 1,
                                   "flash_attention_bwd_sm90": 0,
                                   "flash_attention_bwd_sm90_delta": 0,
                                   "flash_attention_bwd_sm90_dkdv": 0,
                                   "flash_attention_bwd_sm90_dq": 0,
                                   "flash_attention_bwd_sm90_sum": 0}


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
# a crushed 10x10, one broadcast), ragged widths, the warp routes' limit
# (codec.WARP_MAX_P = 1024, 32 values a lane) and one past it on the
# block routes, and rows long enough to be streamed from device memory
# instead of cached in shared memory
CODEC_SHAPES = [(1000, 55), (1000, 10), (1000, 18), (1000, 100), (1, 18),
                (7, 1), (5, 33), (3, 1000), (6, 1024), (6, 1025),
                (2, 5000), (4, 1 << 20)]


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
@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", [18, 100, 1024, 1025, 5000])
def test_codec_kernels_follow_the_plain_version_on_nan_rows(hopper, tdt, p):
    """NaN orders above inf for top-k (ties by index), and a row's NaN
    makes its whole int8 round trip NaN, as in the plain versions."""
    x, u = _codec_inputs(hopper, tdt, 4, p, p)
    x[2, ::7] = float("nan")
    x[3, 1] = float("nan")
    x[3, 0] = float("inf")
    bits = torch.int64 if tdt == torch.float64 else torch.int32
    for kept in sorted({1, 2, max(1, p // 10), p}):  # NaN != NaN: compare bits
        assert torch.equal(ops.topk_mask(x, kept, impl="cuda").view(bits),
                           ops.topk_mask(x, kept, impl="ref").view(bits))
    torch.testing.assert_close(ops.qint8_roundtrip(x, u, impl="cuda"),
                               ops.qint8_roundtrip(x, u, impl="ref"),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_codec_ops_launch_through_the_extension_module(hopper, monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.kernels import codec as kcodec

    module = _build.module("codec")
    assert module.__name__ == "repro_codec"
    for op in ("topk_mask", "qint8_roundtrip"):
        for suffix in ("f32", "f64"):
            assert kcodec._entry(op, suffix).__self__ is module

    def no_ctypes(*args, **kwargs):
        raise AssertionError("a codec op loaded its library through ctypes")
    monkeypatch.setattr(_build, "library", no_ctypes)
    x = torch.randn(3, 18, dtype=torch.float64, device=hopper)
    ops.reset_launch_counts()
    got = ops.topk_mask(x, 4, impl="cuda")
    ops.qint8_roundtrip(x, torch.rand_like(x), impl="cuda")
    assert torch.equal(got, ops.topk_mask(x, 4, impl="ref"))
    counts = ops.launch_counts()
    assert (counts["topk_mask"], counts["qint8_roundtrip"]) == (1, 1)


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


# (tq, tk, H, Hkv, D, causal, window, q_offset, block_k): the prefill
# shapes (TinyLlama's GQA group 8, MHA, GQA 1), ragged lengths, tq != tk
# with q_offset, windows, non-causal, head dims to 256, and rows that see
# no key (their value depends on the contract's block_k)
FLASH_CASES = [
    (64, 64, 4, 4, 64, True, None, 0, 1024),
    (100, 100, 8, 1, 128, True, None, 0, 1024),
    (32, 96, 32, 4, 64, True, None, 64, 1024),
    (1, 128, 8, 1, 256, True, None, 127, 1024),
    (2048, 2048, 32, 4, 64, True, None, 0, 1024),
    (2048, 2048, 4, 1, 256, True, 512, 0, 1024),
    (100, 100, 4, 4, 64, True, 1, 0, 1024),
    (100, 100, 8, 1, 112, True, 7, 0, 64),
    (64, 48, 4, 4, 32, False, None, 0, 1024),
    (48, 200, 4, 2, 64, False, 16, 70, 32),
    (4, 8, 1, 1, 8, True, 2, 20, 4),
    (64, 200, 8, 2, 64, True, 16, 300, 64),
    (2048, 2048, 16, 2, 128, True, 512, 0, 1024),
    (2048, 2048, 8, 2, 256, True, 128, 0, 1024),
    # whisper's encoder: non-causal over 1500 frames, a ragged last tile
    (1500, 1500, 6, 6, 64, False, None, 0, 1024),
    # causal rows of up to 4096 and 8192 keys
    (4096, 4096, 4, 1, 64, True, None, 0, 1024),
    (8192, 8192, 4, 1, 64, True, None, 0, 1024),
    (8192, 8192, 4, 1, 128, True, None, 0, 1024),
    # gemma3-4b's heads: its local window of 1024, and at 8192 keys
    # windowed and causal
    (2048, 2048, 8, 4, 256, True, 1024, 0, 1024),
    (8192, 8192, 8, 4, 256, True, 1024, 0, 1024),
    (8192, 8192, 8, 4, 256, True, None, 0, 1024),
    # head dims that are not a multiple of 8 (the k-steps pad them with
    # zeros): float32 through cp.async (d % 4 == 0) or plain loads (13),
    # bf16 D 12 and 13 through the tf32x3 kernel's plain loads
    (100, 100, 4, 2, 12, True, None, 0, 1024),
    (130, 130, 4, 1, 200, True, 48, 0, 1024),
    (70, 90, 2, 1, 13, True, None, 20, 1024),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,h,hkv,d,causal,window,q_offset,block_k",
                         FLASH_CASES)
def test_flash_attention_kernel_matches_plain(hopper, tdt, tq, tk, h, hkv, d,
                                              causal, window, q_offset,
                                              block_k):
    g = torch.Generator(device=hopper).manual_seed(tq + tk + d)
    q = torch.randn(2, tq, h, d, generator=g, device=hopper).to(tdt)
    k = torch.randn(2, tk, hkv, d, generator=g, device=hopper).to(tdt)
    v = torch.randn(2, tk, hkv, d, generator=g, device=hopper).to(tdt)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              block_k=block_k)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, impl="cuda", **kw)
    route = "sm90" if tdt == torch.bfloat16 and d % 8 == 0 else "tf32x3"
    assert ops.launch_counts()[f"flash_attention_{route}"] == 1
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    torch.cuda.synchronize()
    assert got.dtype == tdt and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[tdt], err


@pytest.mark.gpu
def test_flash_attention_routes_count_their_launches(hopper):
    q = torch.randn(1, 16, 4, 64, device=hopper)
    kv = torch.randn(1, 16, 2, 64, device=hopper)
    for dtype, route, other in ((torch.bfloat16, "sm90", "tf32x3"),
                                (torch.float32, "tf32x3", "sm90")):
        ops.reset_launch_counts()
        ops.flash_attention(q.to(dtype), kv.to(dtype), kv.to(dtype))
        counts = ops.launch_counts()
        assert (counts["flash_attention"], counts[f"flash_attention_{route}"],
                counts[f"flash_attention_{other}"]) == (1, 1, 0)
    # a bf16 head dim TMA cannot stride (d % 8 != 0) takes the tf32x3 kernel
    q12 = torch.randn(1, 16, 4, 12, device=hopper).bfloat16()
    kv12 = torch.randn(1, 16, 2, 12, device=hopper).bfloat16()
    ops.reset_launch_counts()
    got = ops.flash_attention(q12, kv12, kv12, impl="cuda")
    assert ops.launch_counts()["flash_attention_tf32x3"] == 1
    want = ops.flash_attention(q12, kv12, kv12, impl="ref")
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.gpu
def test_flash_attention_rows_without_keys_follow_the_contract(hopper):
    # q_offset 20 with window 2 leaves every row of (tq 4, tk 8) without a
    # key: the contract returns sum(v) / (nk * block_k), mha returns 0
    q = torch.randn(1, 4, 2, 16, device=hopper)
    kv = torch.randn(1, 8, 1, 16, device=hopper)
    for block_k in (4, 3, 1024):
        got = ops.flash_attention(q, kv, kv, window=2, q_offset=20,
                                  block_k=block_k, impl="cuda")
        bk = min(block_k, 8)
        want = kv.sum(dim=1, keepdim=True) / (-(-8 // bk) * bk)
        assert torch.allclose(got, want.expand_as(got), atol=2e-6)
        # the same through the tensor-core kernel, within the bf16 limit
        qb, kvb = q.bfloat16(), kv.bfloat16()
        got = ops.flash_attention(qb, kvb, kvb, window=2, q_offset=20,
                                  block_k=block_k, impl="cuda")
        want = kvb.float().sum(dim=1, keepdim=True) / (-(-8 // bk) * bk)
        assert torch.allclose(got.float(), want.expand_as(got), atol=2e-2,
                              rtol=0)


@pytest.mark.gpu
def test_flash_attention_kernel_rejects_what_it_does_not_take(hopper):
    q = torch.randn(1, 8, 4, 64, device=hopper)
    kv = torch.randn(1, 8, 2, 64, device=hopper)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), kv.double(), kv.double(), impl="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            kv, kv, impl="cuda")
    with pytest.raises(ValueError, match="multiple of kv heads"):
        kv3 = torch.randn(1, 8, 3, 64, device=hopper)
        ops.flash_attention(q, kv3, kv3, impl="cuda")
    with pytest.raises(ValueError, match="head dim"):
        big = torch.randn(1, 8, 1, 320, device=hopper)
        ops.flash_attention(big, big, big, impl="cuda")
    with pytest.raises(ValueError, match="16-byte boundary"):
        flat = torch.zeros(1 + q.numel(), device=hopper).bfloat16()
        kvb = kv.bfloat16()
        ops.flash_attention(flat[1:].view(q.shape), kvb, kvb, impl="cuda")


# the flash-attention backward kernels (route sm90: bf16 with D % 8 == 0;
# tf32x3: the rest) against their plain version
# (ref.mha_blocked_grad): (T, H, Hkv, D, causal, window), self-attention
# only; tolerance on the largest |error| of each gradient over its largest
# |value|: bfloat16 2e-2 (the forward's P V in bfloat16, the sm90
# backward's P and dS in bfloat16, and the gradients' rounding), float32
# 1e-4 (the 3xTF32 forward's output and log-sum-exp)
FLASH_BWD_CASES = [(64, 4, 4, 64, True, None), (100, 8, 2, 64, True, None),
                   (100, 8, 1, 128, True, 7), (130, 4, 1, 256, True, 48),
                   (77, 4, 2, 32, False, None), (90, 2, 1, 12, True, None),
                   (50, 4, 2, 64, False, 16), (2048, 32, 4, 64, True, None),
                   (2048, 4, 1, 256, True, 512), (3, 2, 1, 8, True, None),
                   (200, 8, 4, 72, True, 100),
                   (2048, 16, 2, 128, True, None),
                   # whisper's encoder: non-causal over 1500 frames
                   (1500, 6, 6, 64, False, None),
                   # gemma3-4b's heads: its local window, and 8192 keys
                   (2048, 8, 4, 256, True, 1024),
                   (8192, 8, 4, 256, True, None)]
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,h,hkv,d,causal,window", FLASH_BWD_CASES)
def test_flash_attention_backward_matches_plain(hopper, tdt, t, h, hkv, d,
                                                causal, window):
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    g = torch.Generator(device=hopper).manual_seed(t + d)
    q, k, v = (torch.randn(2, t, n, d, generator=g, device=hopper).to(tdt)
               for n in (h, hkv, hkv))
    do = torch.randn(2, t, h, d, generator=g, device=hopper).to(tdt)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_attention(*leaves, causal=causal, window=window,
                              impl="cuda")
    got = torch.autograd.grad(out, leaves, do)
    # one call on the route of its dtype and head dim, and its kernels
    route = kflash.flash_bwd_route(tdt, d)
    other = "tf32x3" if route == "sm90" else "sm90"
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd"] == 1
    assert counts[f"flash_attention_bwd_{route}"] == 1
    assert counts[f"flash_attention_bwd_{other}"] == 0
    for kernel in kflash.BWD_KERNELS[route]:
        assert counts[f"flash_attention_bwd_{kernel}"] == 1
    for kernel in kflash.BWD_KERNELS[other]:
        assert counts[f"flash_attention_bwd_{kernel}"] == 0
    splits = (kflash.bwd_sm90_splits if route == "sm90"
              else kflash.bwd_tf32x3_splits)(2, t, h, hkv, d)
    assert counts[f"flash_attention_bwd_{route}_sum"] == int(splits > 1)
    assert counts[f"flash_attention_bwd_{other}_sum"] == 0
    want = ref.mha_blocked_grad(q, k, v, do, causal=causal, window=window)
    again = torch.autograd.grad(
        ops.flash_attention(*leaves, causal=causal, window=window,
                            impl="cuda"), leaves, do)
    torch.cuda.synchronize()
    for x, w, a in zip(got, want, again):
        assert x.dtype == tdt and x.shape == w.shape
        err = float((x.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err <= FLASH_BWD_TOL[tdt], err
        assert torch.equal(x, a)  # no atomics: a run repeats bit for bit


@pytest.mark.gpu
def test_flash_attention_backward_rejects_what_it_does_not_take(hopper):
    from repro_torch.kernels import flash_attention as kflash

    q = torch.randn(1, 8, 4, 64, device=hopper, requires_grad=True)
    kv = torch.randn(1, 8, 2, 64, device=hopper)
    with pytest.raises(ValueError, match="self-attention only"):
        ops.flash_attention(q, kv, kv, q_offset=3, impl="cuda")
    with pytest.raises(ValueError, match="self-attention only"):
        kv12 = torch.randn(1, 12, 2, 64, device=hopper)
        ops.flash_attention(q, kv12, kv12, impl="cuda")
    out, lse = kflash._forward(q.detach(), kv, kv, causal=True, window=None,
                               q_offset=0, block_k=1024, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        kflash.flash_attention_bwd_cuda(q.detach(), kv, kv, out, out,
                                        lse[:, :2])


@pytest.mark.gpu
def test_flash_attention_backward_raises_when_its_kernel_fails(hopper,
                                                               monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kflash

    real = _build.library

    class Failing:  # every backward entry point reports cudaErrorInvalidValue
        def __init__(self, lib):
            self.repro_error_string = lib.repro_error_string

        def __getattr__(self, name):
            return lambda *args: 1

    monkeypatch.setattr(_build, "library", lambda stem="srht": Failing(
        real(stem)) if stem.startswith("flash_attention_bwd") else real(stem))
    for dtype, d, route in ((torch.bfloat16, 64, "sm90"),
                            (torch.float32, 64, "tf32x3"),
                            (torch.bfloat16, 60, "tf32x3")):
        q, kv = (torch.randn(1, 64, n, d, device=hopper).to(dtype)
                 for n in (4, 2))
        out, lse = kflash._forward(q, kv, kv, causal=True, window=None,
                                   q_offset=0, block_k=1024, with_lse=True)
        ops.reset_launch_counts()
        with pytest.raises(RuntimeError,
                           match=f"flash_attention_bwd .{route}."):
            kflash.flash_attention_bwd_cuda(q, kv, kv, out, q, lse)
        assert not any(ops.launch_counts().values())  # nothing falls back


# the asynchronous driver and a population round on the card: FLeNS+
# under the edge codecs with EF, through the kernels and through their
# plain versions, traces equal and losses bit-equal
_EDGE_CODECS = {"h_sk": "sympack+qint8", "sg": "qint8",
                "grad": "topk0.1+qint8"}


def _run_both(run):
    """``run()`` through the kernels and through the plain versions, the
    kernel launches of the first counted."""
    ops.reset_launch_counts()
    kernels = run()
    counts = ops.launch_counts()
    with ops.use_impl("ref"):
        plain = run()
    return kernels, plain, counts


def _assert_same(kernels, plain):
    assert (kernels.loss == plain.loss).all()
    assert ([t.to_dict() for t in kernels.traces]
            == [t.to_dict() for t in plain.traces])


@pytest.mark.gpu
def test_async_commits_on_the_card_equal_the_plain_versions(hopper):
    import numpy as np

    from repro_torch.comm import ChannelModel, CommConfig
    from repro_torch.core import (
        logistic,
        make_optimizer,
        make_problem,
        newton_solve,
        run_rounds,
    )
    from repro_torch.data import make_classification

    X, y = make_classification(0, n=20000, dim=18, device=hopper)
    prob = make_problem(X, y, m=40, lam=1e-3, objective=logistic,
                        device=hopper)
    w0 = torch.zeros(18, dtype=torch.float64, device=hopper)
    w_star = newton_solve(prob, w0)
    rates = np.logspace(np.log10(3e4), np.log10(3e6), 40)
    cfg = CommConfig(channel=ChannelModel(
        uplink_bytes_per_s=rates, downlink_bytes_per_s=10 * rates,
        latency_s=0.05, straggler_prob=0.3), seed=1, async_mode=True,
        buffer_size=10, staleness="inverse", codecs=_EDGE_CODECS,
        error_feedback=True)
    kernels, plain, counts = _run_both(lambda: run_rounds(
        make_optimizer("flens_plus", k=10), prob, w0, w_star, rounds=6,
        comm=cfg))
    _assert_same(kernels, plain)
    assert np.nanmax(kernels.staleness) > 0
    assert counts["srht_apply"] > 4 * 6 and counts["topk_mask"] > 6


@pytest.mark.gpu
def test_population_round_on_the_card_equals_the_plain_versions(hopper):
    from repro_torch.comm import ChannelModel, CommConfig
    from repro_torch.core import (
        SyntheticPopulation,
        make_optimizer,
        newton_solve,
        run_rounds,
    )

    pop = SyntheticPopulation(m=5000, dim=16, seed=1, device=hopper)
    w0 = torch.zeros(16, dtype=torch.float64, device=hopper)
    w_star = newton_solve(pop.eval_problem(), w0)
    cfg = CommConfig(channel=ChannelModel(
        uplink_bytes_per_s="loguniform:3e4,3e6", dropout_prob=0.1),
        scheduler="uniform:0.02", seed=1, codecs=_EDGE_CODECS,
        error_feedback=True)
    kernels, plain, counts = _run_both(lambda: run_rounds(
        make_optimizer("flens_plus", k=8), pop, w0, w_star, rounds=3,
        comm=cfg))
    _assert_same(kernels, plain)
    assert counts["srht_apply"] == 4 * 3 and counts["qint8_roundtrip"] == 3 * 3
    # a shard is the same on the card as on the host, up to the float ops
    # of the draw (the counters are integers, equal on both)
    cpu = SyntheticPopulation(m=5000, dim=16, seed=1, device="cpu")
    a, b = pop.materialize([3, 4000]), cpu.materialize([3, 4000])
    assert torch.equal(a.mask.cpu(), b.mask)
    torch.testing.assert_close(a.X.cpu(), b.X, rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
def test_one_nccl_rank_distributed_flens_equals_the_simulator(hopper,
                                                              tmp_path):
    """A 1-rank NCCL DistributedFLeNS on the card: 3 rounds through the
    SRHT kernels (3 srht_apply + 2 srht_apply_t a round) within 1e-10
    (relative) of the simulator FLeNS(k, beta=0, restart=False) at m = 1
    on the same rows and operators."""
    from repro_torch.core import FederatedProblem, FLeNS, logistic
    from repro_torch.core.distributed import DistributedFLeNS, run_distributed
    from repro_torch.data import make_classification
    from repro_torch.keys import key_from_ints
    from repro_torch.launch.mesh import make_mesh, process_group

    n, dim, k, rounds = 4000, 64, 32, 3
    X, y = make_classification(0, n=n, dim=dim, device=hopper)
    w0 = torch.zeros(dim, dtype=torch.float64, device=hopper)
    torch.cuda.set_device(hopper)
    with process_group(0, 1, tmp_path / "store", backend="nccl",
                       timeout_s=60):
        flens = DistributedFLeNS(mesh=make_mesh((1,), ("data",), "cuda"),
                                 objective=logistic, dim=dim, k=k, lam=1e-3,
                                 client_axes=("data",))
        ops.reset_launch_counts()
        _, ws = run_distributed(flens, X, y, w0, rounds)
        counts = ops.launch_counts()
    assert counts["srht_apply"] == 3 * rounds
    assert counts["srht_apply_t"] == 2 * rounds
    problem = FederatedProblem(X=X[None], y=y[None],
                               mask=torch.ones_like(y)[None], lam=1e-3,
                               objective=logistic)
    opt = FLeNS(k=k, beta=0.0, restart=False)
    state = opt.init(problem, w0)
    for t in range(rounds):
        state = opt.round(problem, state, key_from_ints(t))
        err = float((ws[t + 1] - state["w"]).abs().max()
                    / state["w"].abs().max())
        assert err <= 1e-10, (t, err)


@pytest.mark.gpu
def test_one_nccl_rank_client_mesh_round_equals_the_no_mesh_round(hopper,
                                                                 tmp_path):
    """A population round split over a 1-rank NCCL client mesh on the
    card (the cohort's one block, the transport's gather through NCCL)
    equals the round without a mesh bit for bit, through the SRHT and
    codec kernels (4 srht_apply, 1 topk_mask, 3 qint8_roundtrip)."""
    from repro_torch.comm import ChannelModel, CommConfig
    from repro_torch.core import (
        SyntheticPopulation,
        make_optimizer,
        newton_solve,
        run_rounds,
    )
    from repro_torch.launch.mesh import make_mesh, process_group

    pop = SyntheticPopulation(m=2000, dim=16, seed=1, device=hopper)
    w0 = torch.zeros(16, dtype=torch.float64, device=hopper)
    w_star = newton_solve(pop.eval_problem(), w0)
    cfg = CommConfig(channel=ChannelModel(
        uplink_bytes_per_s="loguniform:3e4,3e6", dropout_prob=0.1),
        scheduler="uniform:0.05", seed=1, codecs=_EDGE_CODECS,
        error_feedback=True)

    def run(mesh):
        return run_rounds(make_optimizer("flens_plus", k=8), pop, w0, w_star,
                          rounds=1, comm=cfg, client_mesh=mesh)

    want = run(None)
    torch.cuda.set_device(hopper)
    with process_group(0, 1, tmp_path / "store", backend="nccl",
                       timeout_s=60):
        ops.reset_launch_counts()
        got = run(make_mesh((1,), ("data",), "cuda"))
        counts = ops.launch_counts()
    _assert_same(got, want)
    assert got.ef_residuals == want.ef_residuals
    assert counts["srht_apply"] == 4 and counts["srht_apply_t"] == 3
    assert counts["topk_mask"] == 1 and counts["qint8_roundtrip"] == 3


@pytest.mark.gpu
def test_one_nccl_rank_lm_over_a_mesh_equals_no_mesh(hopper, tmp_path):
    """TinyLlama-1.1B at 2 layers in bf16 served over a 1 x 1 NCCL mesh on
    the card (its serving shard, the decode state's shard, every
    collective an identity): a prefill of 2 x 256 tokens, 4 decode steps
    and every cache leaf bit-equal to the same run without a mesh, 2
    launches of the sm90 flash kernel a prefill."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.base import root_key
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.models.lm import LM
    from repro_torch.sharding import rules
    from repro_torch.sharding.ctx import use_mesh

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2,
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    model = LM(cfg)
    params = model.init(root_key(0, device=hopper))
    gen = torch.Generator(device=hopper).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 256), generator=gen,
                           device=hopper)
    steps = torch.randint(0, cfg.vocab, (4, 2, 1), generator=gen,
                          device=hopper)

    def run(p):
        with torch.no_grad():
            ops.reset_launch_counts()
            logits, state = model.prefill(p, {"inputs": tokens},
                                          cache_len=264)
            launches = ops.launch_counts()["flash_attention_sm90"]
            out = [logits]
            for step in steps:
                logits, state = model.decode_step(p, state, step)
                out.append(logits)
        return torch.stack(out), state, launches

    want, want_state, want_launches = run(params)
    torch.cuda.set_device(hopper)
    with process_group(0, 1, tmp_path / "store", backend="nccl",
                       timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        local = rules.serving_shard(mesh, params)
        with use_mesh(mesh):
            got, state, launches = run(local)
    assert launches == want_launches == 2
    assert torch.equal(got, want)
    for g, w in zip(state["groups"], want_state["groups"]):
        for leaf in w:
            assert torch.equal(g[leaf], w[leaf]), leaf


@pytest.mark.gpu
@pytest.mark.parametrize("tdt,route", [(torch.float32, "tf32x3"),
                                       (torch.bfloat16, "sm90")])
def test_one_nccl_rank_recurrent_lm_over_a_mesh_equals_no_mesh(
        hopper, tmp_path, tdt, route):
    """recurrentgemma-2b ``reduced(n_layers=4)`` (a griffin super-block
    and a rec layer) served over a 1 x 1 NCCL mesh on the card, in
    float32 and in bf16: a prefill of 2 x 48 tokens (past its window of
    32), 6 decode steps, every state leaf (RG-LRU states, conv states,
    the attention's cache) and the engine's streams bit-equal to the same
    runs without a mesh, one launch of the flash kernel on its route a
    prefill."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.base import root_key
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.models.lm import LM
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.sharding import rules
    from repro_torch.sharding.ctx import use_mesh

    cfg = dataclasses.replace(
        get_config("recurrentgemma-2b").reduced(n_layers=4), dtype=tdt,
        param_dtype=tdt)
    model = LM(cfg)
    params = model.init(root_key(0, device=hopper))
    gen = torch.Generator(device=hopper).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 48), generator=gen,
                           device=hopper)
    steps = torch.randint(0, cfg.vocab, (6, 2, 1), generator=gen,
                          device=hopper)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             device=hopper).tolist() for n in (5, 40, 17)]

    def run(p):
        with torch.no_grad():
            ops.reset_launch_counts()
            logits, state = model.prefill(p, {"inputs": tokens},
                                          cache_len=64)
            launches = ops.launch_counts()[f"flash_attention_{route}"]
            out = [logits]
            for step in steps:
                logits, state = model.decode_step(p, state, step)
                out.append(logits)
            engine = ServingEngine(model, p, max_batch=2, cache_len=64)
            reqs = [Request(uid=i, prompt=q, max_new_tokens=4)
                    for i, q in enumerate(prompts)]
            for r in reqs:
                engine.submit(r)
            engine.run()
        return (torch.stack(out), state, launches,
                [r.generated for r in reqs])

    want, want_state, want_launches, want_streams = run(params)
    torch.cuda.set_device(hopper)
    with process_group(0, 1, tmp_path / "store", backend="nccl",
                       timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        local = rules.serving_shard(mesh, params)
        with use_mesh(mesh):
            got, state, launches, streams = run(local)
    assert launches == want_launches == 1
    assert torch.equal(got, want)
    for g, w in zip(state["groups"], want_state["groups"]):
        assert set(g) == set(w)
        for leaf in w:
            assert torch.equal(g[leaf], w[leaf]), leaf
    assert streams == want_streams


@pytest.mark.gpu
@pytest.mark.parametrize("arch,overrides,launches", [
    ("gemma3-1b@rightsized", {"n_layers": 8, "window": 8}, 8),
    ("whisper-tiny", {}, 4)])
def test_one_nccl_rank_rings_and_cross_attention_over_a_mesh_equal_no_mesh(
        hopper, tmp_path, arch, overrides, launches):
    """gemma3-1b@rightsized ``reduced(n_layers=8, window=8)`` (two
    ``dense_sb`` super-blocks and a remainder of ring layers) and
    whisper-tiny ``reduced()`` (its encoder non-causal, the decoder's
    cross attention) in bf16 served over a 1 x 1 NCCL mesh on the card:
    a prefill of 2 x 12 tokens (1.5 windows: the rings wrap; whisper over
    32 frames a row), 6 decode steps, every state leaf (rings, caches,
    cross K and V) and gemma3's engine streams bit-equal to the same runs
    without a mesh, the sm90 flash kernel on every attention layer of a
    prefill (the encoder's too)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.base import root_key
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.models.lm import LM
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.sharding import rules
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(arch).reduced(**overrides),
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    model = LM(cfg)
    params = model.init(root_key(0, device=hopper))
    gen = torch.Generator(device=hopper).manual_seed(1)
    batch = {"inputs": torch.randint(0, cfg.vocab, (2, 12), generator=gen,
                                     device=hopper)}
    if cfg.family == "audio":
        batch["audio_frames"] = torch.randn(
            (2, cfg.audio_frames, cfg.d_model), generator=gen, device=hopper)
    steps = torch.randint(0, cfg.vocab, (6, 2, 1), generator=gen,
                          device=hopper)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             device=hopper).tolist() for n in (5, 17, 11)]

    def run(p):
        with torch.no_grad():
            ops.reset_launch_counts()
            logits, state = model.prefill(p, batch, cache_len=24)
            n = ops.launch_counts()["flash_attention_sm90"]
            out = [logits]
            for step in steps:
                logits, state = model.decode_step(p, state, step)
                out.append(logits)
            streams = None
            if cfg.family != "audio":  # the engine takes no memory
                engine = ServingEngine(model, p, max_batch=2, cache_len=24)
                reqs = [Request(uid=i, prompt=q, max_new_tokens=4)
                        for i, q in enumerate(prompts)]
                for r in reqs:
                    engine.submit(r)
                engine.run()
                streams = [r.generated for r in reqs]
        return torch.stack(out), state, n, streams

    want, want_state, want_launches, want_streams = run(params)
    torch.cuda.set_device(hopper)
    with process_group(0, 1, tmp_path / "store", backend="nccl",
                       timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        local = rules.serving_shard(mesh, params)
        with use_mesh(mesh):
            got, state, n, streams = run(local)
    assert n == want_launches == launches
    assert torch.equal(got, want)
    for g, w in zip(state["groups"], want_state["groups"]):
        got_leaves, want_leaves = leaves(g), leaves(w)
        assert len(got_leaves) == len(want_leaves)
        for a, b in zip(got_leaves, want_leaves):
            assert torch.equal(a, b)
    assert streams == want_streams


@pytest.mark.gpu
def test_one_nccl_rank_train_step_over_a_mesh_equals_no_mesh(hopper,
                                                              tmp_path):
    """TinyLlama-1.1B at 2 layers in bf16 with remat trained over a 1 x 1
    NCCL mesh on the card (its training shard under ``rules.param_spec``,
    every collective an identity both ways): ``loss_and_grads`` and one
    ``train_step`` of 2 x 256 tokens bit-equal to the same without a
    mesh (loss, CE, gnorm, every gradient, parameter and moment), 4
    forward and 2 backward launches of the sm90 kernels each."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.base import root_key
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.launch.train import loss_and_grads, train_step
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import rules
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2,
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, remat=True)
    model = LM(cfg)
    params = model.init(root_key(0, device=hopper))
    gen = torch.Generator(device=hopper).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 257), generator=gen,
                         device=hopper)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    def run(p):
        ops.reset_launch_counts()
        loss, met, grads = loss_and_grads(model, p, batch)
        counts = ops.launch_counts()
        p2, s2, loss2, ce2, gnorm = train_step(model, p, adamw_init(p),
                                               batch, 1e-3)
        return ([loss, met["ce"], met["aux"], loss2, ce2, gnorm,
                 *leaves(grads), *leaves(p2), *leaves(s2["m"]),
                 *leaves(s2["v"])],
                (counts["flash_attention_sm90"],
                 counts["flash_attention_bwd_sm90"]))

    want, want_launches = run(params)
    torch.cuda.set_device(hopper)
    with process_group(0, 1, tmp_path / "store", backend="nccl",
                       timeout_s=60):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        local = rules.training_shard(mesh, params)
        with use_mesh(mesh):
            got, launches = run(local)
    assert launches == want_launches == (4, 2)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
