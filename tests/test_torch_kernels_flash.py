"""The port's plain attention (``repro_torch.kernels.ref.mha_blocked``,
the contract of the ``flash_attention`` op, and the naive ``mha``)
against ``repro.kernels.ref`` on the same numpy inputs.

The sums run in another order than XLA's, so float32 is held to
atol = rtol = 2e-5 and bfloat16 (inputs rounded identically, outputs
rounded from float32 in each package) to 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# one XLA compile per case instead of op-by-op dispatch of the scan
_STATIC = ("causal", "window", "q_offset")
_JREF = {"mha": jax.jit(jref.mha, static_argnames=_STATIC),
         "mha_blocked": jax.jit(jref.mha_blocked, static_argnames=_STATIC
                                + ("block_q", "block_k"))}


def _qkv(seed, b, tq, tk, h, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d)))


def _both(fn_name, arrays, dtype="float32", **kw):
    """(reference, port) outputs of ``fn_name`` as float32 numpy."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    want = _JREF[fn_name](*jx, **kw)
    got = getattr(tref, fn_name)(*tx, **kw)
    assert str(got.dtype).endswith(dtype)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


def _close(want, got, dtype="float32"):
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("tq,tk", [(64, 64), (100, 100), (32, 96), (1, 128)])
def test_mha_blocked_matches_reference(tq, tk, h, hkv, dtype):
    arrays = _qkv(tq + h, 2, tq, tk, h, hkv, 32)
    qoff = tk - tq  # decode-style offset keeps causal well-defined
    _close(*_both("mha_blocked", arrays, dtype, q_offset=qoff, block_q=32,
                  block_k=32), dtype)


@pytest.mark.parametrize("window", [None, 0, -3, 1, 7, 32, 1000])
def test_mha_blocked_windows(window):
    """``None`` and windows <= 0 mean no window, as in the reference."""
    arrays = _qkv(11, 2, 96, 96, 4, 2, 16)
    want, got = _both("mha_blocked", arrays, window=window, block_q=32,
                      block_k=32)
    _close(want, got)
    if window is None or window <= 0:
        _close(_both("mha_blocked", arrays, block_q=32, block_k=32)[0], got)


@pytest.mark.parametrize("block_q,block_k", [(32, 32), (64, 64), (512, 1024),
                                             (32, 64)])
def test_mha_blocked_block_sizes(block_q, block_k):
    arrays = _qkv(5, 1, 128, 160, 4, 2, 32)
    _close(*_both("mha_blocked", arrays, q_offset=32, block_q=block_q,
                  block_k=block_k))


def test_mha_blocked_noncausal_with_window_and_offset():
    arrays = _qkv(3, 2, 48, 80, 4, 4, 32)
    _close(*_both("mha_blocked", arrays, causal=False, window=24,
                  q_offset=40, block_q=16, block_k=32))


@pytest.mark.parametrize("tk,block_k", [(8, 4), (10, 4), (8, 1024), (10, 3)])
def test_rows_without_keys_follow_the_blocked_contract(tk, block_k):
    """q_offset 20 with window 2 leaves every query without a key: the
    blocked contract returns sum(v) / (nk * block_k), the naive oracle 0."""
    arrays = _qkv(7, 1, 4, tk, 2, 1, 8)
    kw = dict(window=2, q_offset=20)
    want, got = _both("mha_blocked", arrays, block_q=4, block_k=block_k, **kw)
    _close(want, got)
    bk = min(block_k, tk)
    closed = arrays[2].sum(axis=1, keepdims=True) / (-(-tk // bk) * bk)
    np.testing.assert_allclose(got, np.broadcast_to(closed, got.shape),
                               rtol=2e-5, atol=2e-6)
    naive_ref, naive = _both("mha", arrays, **kw)
    np.testing.assert_array_equal(naive, 0.0)
    np.testing.assert_array_equal(naive_ref, 0.0)
    assert np.abs(got - naive).max() > 0.1


@pytest.mark.parametrize("kw", [dict(), dict(causal=False), dict(window=5),
                                dict(q_offset=16, window=9),
                                dict(causal=False, window=0)])
def test_mha_matches_reference(kw):
    arrays = _qkv(2, 2, 24, 40, 6, 2, 16)
    _close(*_both("mha", arrays, **kw))


def test_ops_flash_attention_on_the_host_is_the_plain_version(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 20, 20, 4, 2, 16))
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, window=5, block_k=8)
    assert torch.equal(got, tref.mha_blocked(q, k, v, window=5, block_k=8))
    assert ops.launch_counts() == before
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.flash_attention(q, k, v, impl="cuda")
