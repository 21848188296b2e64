"""repro_torch kernels: plain versions against repro.kernels.ref, and
the dispatch registry (the CUDA kernels themselves are tested on the
card by tests/test_torch_kernels_cuda.py).

The plain versions keep the reference's op order, so they are required
to be bit-equal to it in float64 and float32.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fwht as kfwht
from repro_torch.kernels import ops, ref

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]
# (dim, n, k, batch): power-of-two and padded dims, batched leading axes
CASES = [(64, 64, 32, (3,)), (18, 32, 10, (2, 5)), (100, 128, 7, (4,)),
         (1, 1, 1, (2,)), (300, 512, 100, (2, 3)),
         # past the kernels' single-pass length: the two-pass path's n
         (20000, 1 << 15, 64, (2,))]


def _operator(rng, n, k, dt):
    signs = rng.choice([-1.0, 1.0], n).astype(dt)
    rows = rng.permutation(n)[:k].astype(np.int64)
    return signs, rows


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("dim,n,k,batch", CASES)
def test_srht_ref_bit_equal_to_jax(dt, tdt, dim, n, k, batch):
    rng = np.random.default_rng(dim * 7 + k)
    signs, rows = _operator(rng, n, k, dt)
    x = rng.standard_normal(batch + (dim,)).astype(dt)
    y = rng.standard_normal(batch + (k,)).astype(dt)
    # the reference's own ref path (jitted, as its optimizers call it)
    want = np.asarray(jops.srht_apply(jnp.asarray(x), jnp.asarray(signs),
                                      jnp.asarray(rows), impl="ref"))
    got = ref.srht_apply(torch.from_numpy(x), torch.from_numpy(signs),
                         torch.from_numpy(rows))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), want)
    want_t = np.asarray(jops.srht_apply_t(jnp.asarray(y), jnp.asarray(signs),
                                          jnp.asarray(rows), dim, impl="ref"))
    got_t = ref.srht_apply_t(torch.from_numpy(y), torch.from_numpy(signs),
                             torch.from_numpy(rows), dim)
    np.testing.assert_array_equal(got_t.numpy(), want_t)


@pytest.mark.parametrize("dt,tdt", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 32, 256, 1 << 15])
@pytest.mark.parametrize("normalize", [False, True])
def test_fwht_ref_bit_equal_to_jax(dt, tdt, n, normalize):
    x = np.random.default_rng(n).standard_normal((3, 2, n)).astype(dt)
    want = np.asarray(jops.fwht(jnp.asarray(x), normalize=normalize,
                                impl="ref"))
    got = ref.fwht(torch.from_numpy(x), normalize=normalize)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 4, 64])
def test_hadamard_matrix_matches_jax(n):
    want = np.asarray(jref.hadamard_matrix(n, jnp.float64))
    np.testing.assert_array_equal(
        ref.hadamard_matrix(n, torch.float64).numpy(), want)
    # H H^T = n I, and the FWHT is multiplication by H
    h = ref.hadamard_matrix(n, torch.float64)
    np.testing.assert_array_equal((h @ h.T).numpy(), n * np.eye(n))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, n)))
    np.testing.assert_allclose(ref.fwht(x).numpy(), (x @ h).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_scale_factors_match_jax_rounding():
    for n in (3, 32, 100, 1000, 16384):
        for tdt, jdt in ((torch.float64, jnp.float64),
                         (torch.float32, jnp.float32)):
            assert float(ref.norm_factor(n, tdt)) == float(
                1.0 / jnp.sqrt(jnp.asarray(n, jdt)))
            assert float(ref.subsample_scale(n, 7, tdt)) == float(
                jnp.sqrt(jnp.asarray(n / 7, jdt)))


def test_ref_rejects_non_pow2():
    with pytest.raises(ValueError, match="power of two"):
        ref.fwht(torch.zeros(3, 12))
    with pytest.raises(ValueError, match="power of two"):
        ref.hadamard_matrix(6)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_auto_resolves_by_device(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    x = torch.zeros(4)
    assert ops.resolve_impl(None, x) == "ref"
    assert ops.resolve_impl("auto", x) == "ref"
    assert ops.resolve_impl("reference", x) == "ref"


def test_registry_precedence(monkeypatch):
    x = torch.zeros(4)
    monkeypatch.setenv(ops.ENV_VAR, "cuda")
    assert ops.resolve_impl(None, x) == "cuda"  # env over auto
    with ops.use_impl("ref"):
        assert ops.resolve_impl(None, x) == "ref"  # config over env
        assert ops.resolve_impl("cuda", x) == "cuda"  # per call over config
    assert ops.resolve_impl(None, x) == "cuda"  # scope restored
    ops.set_default_impl("ref")
    try:
        assert ops.resolve_impl(None, x) == "ref"
    finally:
        ops.set_default_impl(None)
    assert ops.resolve_impl(None, x) == "cuda"


def test_registry_error_paths(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    x = torch.zeros(2, 8, dtype=torch.float64)
    signs = torch.ones(8, dtype=torch.float64)
    rows = torch.arange(4)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.fwht(x, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.srht_apply(x, signs, rows, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.srht_apply_t(x[:, :4], signs, rows, 8, impl="cuda")
    monkeypatch.setenv(ops.ENV_VAR, "cuda")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.fwht(x)  # the env default forces the kernel: no fallback
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.fwht(x, impl="pallas")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.set_default_impl("triton")
    with pytest.raises(KeyError, match="unknown kernel op"):
        ops.get_impl("not_an_op", "ref", x)


def test_ops_ref_path_is_the_plain_version(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    rng = np.random.default_rng(1)
    signs, rows = _operator(rng, 32, 10, np.float64)
    x = torch.from_numpy(rng.standard_normal((5, 18)))
    s, r = torch.from_numpy(signs), torch.from_numpy(rows)
    before = ops.launch_counts()
    assert torch.equal(ops.srht_apply(x, s, r), ref.srht_apply(x, s, r))
    y = torch.from_numpy(rng.standard_normal((5, 10)))
    assert torch.equal(ops.srht_apply_t(y, s, r, 18),
                       ref.srht_apply_t(y, s, r, 18))
    assert ops.launch_counts() == before  # the plain path launches nothing


def test_kernel_wrapper_checks_run_before_any_build():
    x = torch.zeros(2, 8, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        kfwht.fwht_cuda(x)
    with pytest.raises(ValueError, match="power of two"):
        kfwht.check_length(24)
    # no length limit past one block's shared memory: longer rows take
    # the two-pass path
    kfwht.check_length(kfwht.SINGLE_PASS_N)
    kfwht.check_length(1 << 15)
    kfwht.check_length(1 << 20)
