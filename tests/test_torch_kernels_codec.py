"""repro_torch's codec kernels on the CPU: the plain versions against
repro's, and the dispatch of the two codec ops (the CUDA kernels are held
against the plain versions on the card by tests/test_torch_kernels_cuda.py).

The plain versions work per row of (rows, P), one payload per row, and
keep the op order of ``repro.kernels.ref`` in the input dtype, so they
are required to be bit-equal to it, row by row, in float64 and float32.
Against the Pallas bodies in interpret mode (float32 inside) top-k must
select the same entries and qint8 agree to rtol 1e-6, as
``tests/test_kernels_codecs.py`` holds the bodies to the reference.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import codec as kcodec
from repro_torch.kernels import ops, ref

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]
TIES = np.asarray([[1.0, -1.0, 0.5, 1.0], [0.5, -0.5, 0.5, 0.25]])


def _rows_ref(fn, *arrays):
    """The reference applied to each row (one payload a call, as the
    codecs vmap it)."""
    return np.stack([np.asarray(fn(*(jnp.asarray(a[i]) for a in arrays)))
                     for i in range(arrays[0].shape[0])])


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _payloads(rng, dt, rows, p):
    """Gaussian rows at mixed scales, small-integer rows (ties), an
    all-zero row and a row with signed zeros."""
    x = rng.standard_normal((rows, p)) * 10.0 ** rng.uniform(-3, 3, (rows, 1))
    x[0] = rng.integers(-3, 4, p)
    x[1] = 0.0
    x[2, ::2] = -0.0
    return x.astype(dt)


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("p", [1, 10, 18, 55, 100, 257])
def test_topk_ref_bit_equal_to_jax(dt, tdt, p):
    x = _payloads(np.random.default_rng(p), dt, 6, p)
    for kept in sorted({1, max(1, p // 10), max(1, p // 2), p}):
        want = _rows_ref(lambda r: jref.topk_mask(r, kept), x)
        got = ref.topk_mask(torch.from_numpy(x), kept)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        assert (np.count_nonzero(got.numpy(), axis=1) <= kept).all()


@pytest.mark.parametrize("dt,tdt", DTYPES)
def test_topk_ties_go_to_the_lowest_index(dt, tdt):
    x = TIES.astype(dt)
    for kept in range(1, 5):
        want = _rows_ref(lambda r: jref.topk_mask(r, kept), x)
        np.testing.assert_array_equal(
            ref.topk_mask(torch.from_numpy(x), kept).numpy(), want)
    got = ref.topk_mask(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, [[1.0, -1.0, 0, 0], [0.5, -0.5, 0, 0]])


def test_topk_float64_keeps_magnitudes_float32_would_tie():
    """Distinct float64 magnitudes that one float32 value covers: the
    plain version keeps the larger, as the reference does in float64."""
    x = np.asarray([[1.0, 1.0 + 1e-12, 1.0 + 2e-12, 0.5]])
    got = ref.topk_mask(torch.from_numpy(x), 1).numpy()
    np.testing.assert_array_equal(got, [[0, 0, 1.0 + 2e-12, 0]])
    np.testing.assert_array_equal(
        got, _rows_ref(lambda r: jref.topk_mask(r, 1), x))


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("p", [1, 10, 18, 55, 100, 257])
def test_qint8_ref_bit_equal_to_jax(dt, tdt, p):
    rng = np.random.default_rng(100 + p)
    x = _payloads(rng, dt, 6, p)
    u = rng.random((6, p)).astype(dt)
    want = _rows_ref(jref.qint8_roundtrip, x, u)
    got = ref.qint8_roundtrip(torch.from_numpy(x), torch.from_numpy(u))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(got.numpy()[1], np.zeros(p))  # no 0/0


def test_qint8_ref_uses_the_dtypes_tiny():
    """A row of tiny float64 values quantizes against float64's tiny (the
    reference's); float32's tiny would swamp the scale and zero it."""
    x = np.full((1, 4), 1e-300)
    u = np.full((1, 4), 0.5)
    got = ref.qint8_roundtrip(torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(),
                                  _rows_ref(jref.qint8_roundtrip, x, u))
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-15)


@pytest.mark.parametrize("p", [7, 64, 221])
def test_ref_matches_the_pallas_bodies_in_interpret_mode(p):
    rng = np.random.default_rng(p)
    x = (rng.standard_normal((3, p)) * 3).astype(np.float32)
    u = rng.random((3, p)).astype(np.float32)
    for kept in (1, max(1, p // 4), p):
        want = _rows_ref(
            lambda r: jops.topk_mask(r, kept, impl="interpret"), x)
        np.testing.assert_array_equal(
            ref.topk_mask(torch.from_numpy(x), kept).numpy(), want)
    want = _rows_ref(
        lambda r, v: jops.qint8_roundtrip(r, v, impl="interpret"), x, u)
    np.testing.assert_allclose(
        ref.qint8_roundtrip(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
        want, rtol=1e-6, atol=1e-7)
    ties = TIES.astype(np.float32)
    for kept in range(1, 5):
        np.testing.assert_array_equal(
            ref.topk_mask(torch.from_numpy(ties), kept).numpy(),
            _rows_ref(lambda r: jops.topk_mask(r, kept, impl="interpret"),
                      ties))


def test_codec_ops_dispatch_to_the_plain_version_on_the_cpu(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 18)))
    u = torch.from_numpy(rng.random((4, 18)))
    before = ops.launch_counts()
    assert set(before) == {"fwht", "srht_apply", "srht_apply_t",
                           "srht_apply_rows", "topk_mask",
                           "qint8_roundtrip", "flash_attention",
                           "flash_attention_sm90", "flash_attention_tf32x3",
                           "flash_attention_bwd",
                           "flash_attention_bwd_tf32x3",
                           "flash_attention_bwd_tf32x3_delta",
                           "flash_attention_bwd_tf32x3_dkdv",
                           "flash_attention_bwd_tf32x3_dq",
                           "flash_attention_bwd_tf32x3_sum",
                           "flash_attention_bwd_sm90",
                           "flash_attention_bwd_sm90_delta",
                           "flash_attention_bwd_sm90_dkdv",
                           "flash_attention_bwd_sm90_dq",
                           "flash_attention_bwd_sm90_sum"}
    assert torch.equal(ops.topk_mask(x, 3), ref.topk_mask(x, 3))
    assert torch.equal(ops.qint8_roundtrip(x, u), ref.qint8_roundtrip(x, u))
    assert torch.equal(ops.topk_mask(x, 3, impl="reference"),
                       ref.topk_mask(x, 3))
    assert ops.launch_counts() == before  # the plain path launches nothing
    assert ops.get_impl("topk_mask", "ref", x) is ref.topk_mask


def test_codec_kernels_refuse_cpu_tensors_before_any_build(monkeypatch):
    x = torch.zeros(2, 8, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.topk_mask(x, 2, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.qint8_roundtrip(x, x, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        kcodec.topk_mask_cuda(x, 2)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        kcodec.qint8_roundtrip_cuda(x, x)
    monkeypatch.setenv(ops.ENV_VAR, "cuda")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.topk_mask(x, 2)  # the env default forces the kernel: no fallback
    assert ops.launch_counts()["topk_mask"] == 0
