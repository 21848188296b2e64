"""The flash-attention backward on the CPU: its plain version
(``repro_torch.kernels.ref.mha_blocked_grad``) against JAX's derivative
of ``repro.kernels.ref.mha_blocked`` on the same numpy inputs, and the
argument checks of the differentiable op. The kernels' arithmetic is
rehearsed by ``tests/test_torch_kernels_flash_bwd_tf32.py`` (route
tf32x3) and ``tests/test_torch_kernels_flash_bwd_sm90.py`` (route sm90).

Tolerances, on the largest |error| of each gradient over its largest
|value|: float32 2e-5 (the packages sum in different orders); bfloat16
1e-2 (both compute in float32 and round each gradient to bfloat16, where
a different last float32 bit can move a value by one bfloat16 ulp,
2^-8 of its size).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

TOL = {"float32": 2e-5, "bfloat16": 1e-2}


@functools.cache
def _jax_grad(causal, window, q_offset, block_q, block_k):
    def vjp(q, k, v, do):
        _, pull = jax.vjp(lambda q, k, v: jref.mha_blocked(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            block_q=block_q, block_k=block_k), q, k, v)
        return pull(do)
    return jax.jit(vjp)


def _arrays(seed, b, tq, tk, h, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d),
                           (b, tq, h, d)))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (b, tq, tk, H, Hkv, D, causal, window, q_offset, block_q, block_k):
# GQA groups 1, 2 and 4; causal, windows and none; ragged tails of both
# blockings (tq, tk not multiples of block_q, block_k); q_offset with
# tq < tk, as a decode chunk would have (the plain version takes any)
GRAD_CASES = [
    (2, 16, 16, 4, 4, 8, True, None, 0, 512, 1024),
    (1, 37, 37, 8, 2, 16, True, None, 0, 16, 8),
    (2, 33, 33, 4, 1, 32, True, 5, 0, 8, 16),
    (1, 40, 40, 4, 2, 8, False, None, 0, 16, 16),
    (1, 29, 29, 2, 2, 12, False, 6, 0, 7, 9),
    (1, 12, 30, 4, 2, 16, True, None, 18, 5, 7),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,tq,tk,h,hkv,d,causal,window,q_offset,block_q,"
                         "block_k", GRAD_CASES)
def test_plain_backward_matches_reference(dtype, b, tq, tk, h, hkv, d, causal,
                                          window, q_offset, block_q, block_k):
    arrays = _arrays(tq + tk + d, b, tq, tk, h, hkv, d)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    want = _jax_grad(causal, window, q_offset, block_q, block_k)(*jx)
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    got = tref.mha_blocked_grad(*tx, causal=causal, window=window,
                                q_offset=q_offset, block_q=block_q,
                                block_k=block_k)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert str(g.dtype).endswith(dtype) and g.shape == w.shape, name
        err = _rel_err(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert err <= TOL[dtype], (name, err)


def test_cpu_gradient_goes_through_the_plain_version():
    g = torch.Generator().manual_seed(3)
    q, do = (torch.randn(1, 20, 4, 16, generator=g) for _ in range(2))
    k, v = (torch.randn(1, 20, 2, 16, generator=g) for _ in range(2))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_attention(*leaves, window=5)
    got = torch.autograd.grad(out, leaves, do)
    want = tref.mha_blocked_grad(q, k, v, do, window=5)
    for x, w in zip(got, want):
        assert torch.equal(x, w)
    assert ops.launch_counts()["flash_attention_bwd"] == 0


def test_differentiable_op_refuses_what_the_backward_cannot_take():
    q = torch.randn(1, 8, 4, 64, requires_grad=True)
    kv = torch.randn(1, 8, 2, 64)
    with pytest.raises(ValueError, match="self-attention only"):
        kflash.check_bwd_args(q, kv, kv, q_offset=2)
    with pytest.raises(ValueError, match="self-attention only"):
        kv5 = torch.randn(1, 5, 2, 64)
        kflash.check_bwd_args(q, kv5, kv5)
    assert kflash.check_bwd_args(q.bfloat16(), kv.bfloat16(),
                                 kv.bfloat16()) == "sm90"
    # forcing the kernel without a card raises; nothing falls back
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        ops.flash_attention(q, kv, kv, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        kflash.flash_attention_grad_cuda(q, kv, kv)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        kflash.flash_attention_bwd_cuda(q.detach(), kv, kv, q.detach(),
                                        q.detach(), lse)
    assert ops.get_impl("flash_attention", "ref", q, grad=True) is \
        tref.mha_blocked
