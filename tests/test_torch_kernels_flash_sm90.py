"""The tensor-core flash-attention kernel's rules and arithmetic, on the
host (the kernel itself runs only on a Hopper card:
tests/test_torch_kernels_cuda.py).

* which kernel a call takes (``flash_route``), for every configuration's
  head dim;
* the wrapper's argument checks, which run before any build;
* a rehearsal of the kernel's numerics: a plain emulation of what
  ``csrc/flash_attention_sm90.cu`` computes (bfloat16 operands, float32
  products and sums, the scale applied after Q K^T, the kernel's 64-row q
  tile and key tile, skipped tiles, the softmax in log2 units, P rounded
  to bfloat16 before P V, the closed form for rows that see no key)
  against ``repro.kernels.ref.mha_blocked`` in bfloat16, within the op's
  bfloat16 tolerance of 2e-2.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as kflash

from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

BF16_TOL = 2e-2
_LOG2E = 1.4426950408889634
_JREF = jax.jit(jref.mha_blocked, static_argnames=(
    "causal", "window", "q_offset", "block_q", "block_k"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_configured_head_dim_routes_to_sm90_in_bf16(arch):
    d = get_config(arch).head_dim
    assert kflash.flash_route(torch.bfloat16, d) == "sm90"
    assert kflash.flash_route(torch.float32, d) == "tf32x3"


@pytest.mark.parametrize("d", [1, 4, 12, 36, 100, 130, 255])
def test_head_dims_tma_cannot_stride_take_the_simt_kernel(d):
    # TMA's global strides are multiples of 16 bytes: d % 8 == 0 in bf16
    assert kflash.flash_route(torch.bfloat16, d) == "tf32x3"
    assert kflash.flash_route(torch.bfloat16, d + (-d) % 8) == "sm90"


def test_sm90_argument_checks_run_before_any_build(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a wrapper check built a kernel")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        kflash.flash_attention_cuda(q, kv, kv)
    assert kflash.check_args(q, kv, kv) == "sm90"
    assert kflash.check_args(q.float(), kv.float(), kv.float()) == "tf32x3"
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kflash.check_args(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError, match="share dtype"):
        kflash.check_args(q, kv.float(), kv)
    with pytest.raises(ValueError, match="contiguous"):
        kflash.check_args(q.transpose(1, 2).contiguous().transpose(1, 2),
                          kv, kv)
    kv3 = torch.zeros(1, 8, 3, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        kflash.check_args(q, kv3, kv3)
    big = torch.zeros(1, 8, 1, 320, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        kflash.check_args(big, big, big)
    with pytest.raises(ValueError, match="q_offset"):
        kflash.check_args(q, kv, kv, q_offset=-1)
    # TMA reads from 16-byte boundaries: a view 2 bytes in is refused
    flat = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        kflash.check_args(shifted, kv, kv)
    # the sm90 grid has one row of blocks per 64 q rows, at most 65535
    long_q = torch.zeros(1, 65535 * 64 + 1, 1, 8, dtype=torch.bfloat16)
    one = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sm90 kernel's grid"):
        kflash.check_args(long_q, one, one)


def _emulate_sm90(q, k, v, *, causal, window, q_offset, block_k):
    """What the sm90 kernel computes, in plain PyTorch on the host: q, k,
    v bfloat16 (B, T, H, D); returns bfloat16 (B, Tq, H, D)."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    bm, bn = kflash.SM90_BLOCK_Q, kflash.SM90_BLOCK_K
    w = window if window is not None and window > 0 else 0
    scale_log2 = torch.tensor(1.0 / d**0.5 * _LOG2E, dtype=torch.float32)
    mask = torch.tensor(-2.0**30, dtype=torch.float32) * torch.tensor(
        _LOG2E, dtype=torch.float32)
    bk = min(block_k, tk)
    empty_denom = float(math.ceil(tk / bk) * bk)
    out = torch.zeros(b, tq, h, d, dtype=torch.float32)
    for bb in range(b):
        for head in range(h):
            kvh = head // (h // hkv)
            kf = torch.zeros(tk + 2 * bn, d)
            vf = torch.zeros(tk + 2 * bn, d)
            kf[:tk] = k[bb, :, kvh].float()
            vf[:tk] = v[bb, :, kvh].float()
            for i0 in range(0, tq, bm):
                qt = torch.zeros(bm, d)
                n_rows = min(bm, tq - i0)
                qt[:n_rows] = q[bb, i0:i0 + n_rows, head].float()
                qpos = q_offset + i0 + torch.arange(bm)
                q_lo, q_hi = q_offset + i0, q_offset + i0 + n_rows - 1
                b_lo = max(0, q_lo - w + 1) if w else 0
                b_hi = min(tk - 1, q_hi) if causal else tk - 1
                m = torch.full((bm,), -math.inf)
                l = torch.zeros(bm)
                acc = torch.zeros(bm, d)
                tiles = range(b_lo // bn, b_hi // bn + 1) if b_hi >= b_lo else ()
                for t in tiles:
                    k0 = t * bn
                    x = (qt @ kf[k0:k0 + bn].T) * scale_log2
                    full = (k0 + bn <= tk and (not causal or k0 + bn - 1 <= q_lo)
                            and (not w or k0 > q_hi - w))
                    if not full:
                        key = k0 + torch.arange(bn)
                        ok = (key < tk)[None, :].expand(bm, bn)
                        if causal:
                            ok = ok & (key[None, :] <= qpos[:, None])
                        if w:
                            ok = ok & (key[None, :] > qpos[:, None] - w)
                        x = torch.where(ok, x, mask)
                    m_new = torch.maximum(m, x.amax(dim=1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(x - m_new[:, None])
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + (
                        p.bfloat16().float() @ vf[k0:k0 + bn])
                    m = m_new
                lo = (qpos - w + 1).clamp(min=0) if w else torch.zeros_like(qpos)
                hi = qpos.clamp(max=tk - 1) if causal else torch.full_like(qpos, tk - 1)
                empty = lo > hi
                acc[empty] = vf[:tk].sum(dim=0)
                l[empty] = empty_denom
                o = acc / l.clamp(min=1e-30)[:, None]
                out[bb, i0:i0 + n_rows, head] = o[:n_rows]
    return out.bfloat16()


# (tq, tk, H, Hkv, D, causal, window, q_offset, block_k): GQA groups 8
# and 1, several q and key tiles with ragged ends, D 8/64/112/128/256,
# windows, q_offset, non-causal, and rows that see no key
REHEARSAL_CASES = [
    (300, 300, 8, 1, 64, True, None, 0, 1024),
    (130, 130, 2, 2, 128, True, None, 0, 1024),
    (200, 200, 4, 1, 256, True, 48, 0, 1024),
    (192, 320, 4, 1, 256, True, 128, 128, 1024),
    (100, 100, 8, 1, 112, True, 7, 0, 64),
    (32, 96, 8, 1, 112, True, None, 64, 1024),
    (48, 200, 4, 2, 64, False, 16, 70, 32),
    (70, 150, 2, 1, 128, False, None, 0, 1024),
    (4, 8, 1, 1, 8, True, 2, 20, 4),
    (64, 200, 8, 2, 64, True, 16, 300, 64),
    (100, 100, 4, 4, 8, True, 1, 0, 1024),
]


@pytest.mark.parametrize("tq,tk,h,hkv,d,causal,window,q_offset,block_k",
                         REHEARSAL_CASES)
def test_sm90_arithmetic_matches_the_reference_in_bf16(tq, tk, h, hkv, d,
                                                       causal, window,
                                                       q_offset, block_k):
    rng = np.random.default_rng(tq * 7 + tk + d)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, tq, h, d), (1, tk, hkv, d), (1, tk, hkv, d))]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = np.asarray(_JREF(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                            block_k=block_k, **kw).astype(jnp.float32))
    got = _emulate_sm90(*(torch.from_numpy(a).bfloat16() for a in arrays),
                        block_k=block_k, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (1, tq, h, d)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL, err
