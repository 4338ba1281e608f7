"""The port's plain attention kernels against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas kernels run in interpret mode, as the JAX package's own tests run
them.  f32 throughout, atol 1e-5 (the JAX package's kernel tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pl_decode
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd

ATOL = 1e-5


def _qkv(b, sq, sk, h, kv, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, h, dh)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, sk, kv, dh)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, sk, kv, dh)) * 0.5).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _bf16(*arrs):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


# the cases of tests/test_kernels.py (ref vs sdpa, pallas vs ref), plus q_offset
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,bq,bk,q_offset", [
    (2, 64, 64, 4, 4, 16, True, None, 16, 16, 0),
    (2, 64, 64, 8, 2, 16, True, None, 16, 32, 0),
    (2, 96, 96, 4, 2, 16, True, 24, 32, 16, 0),
    (1, 60, 60, 4, 1, 8, True, None, 16, 16, 0),     # ragged => padding path
    (2, 64, 64, 4, 4, 16, False, None, 16, 16, 0),
    (2, 128, 128, 4, 1, 32, True, 48, 32, 32, 0),
    (1, 32, 96, 4, 2, 16, True, 40, 16, 32, 64),     # chunked prefill: q_offset
])
def test_plain_mha_matches_jax(b, sq, sk, h, kv, dh, causal, window, bq, bk, q_offset):
    q, k, v = _qkv(b, sq, sk, h, kv, dh)
    got = tref.mha(*_t(q, k, v), causal=causal, window=window, block_q=bq,
                   block_k=bk, q_offset=q_offset).numpy()
    want = jref.mha(*_j(q, k, v), causal=causal, window=window, block_q=bq,
                    block_k=bk, q_offset=q_offset)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    pallas = pl_flash(*_j(q, k, v), causal=causal, window=window, block_q=bq,
                      block_k=bk, q_offset=q_offset, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)


@pytest.mark.parametrize("valid_len", [37, 100, 256])
def test_plain_decode_matches_jax(valid_len):
    b, c, h, kv, dh = 2, 256, 8, 2, 64
    rng = np.random.default_rng(1)
    q = (rng.standard_normal((b, 1, h, dh)) * 0.5).astype(np.float32)
    kc = (rng.standard_normal((b, c, kv, dh)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((b, c, kv, dh)) * 0.5).astype(np.float32)
    valid = np.repeat((np.arange(c) < valid_len)[None, :], b, 0)
    tq, tk, tv, tm = _t(q, kc, vc, valid)
    got = tref.decode_attention(tq, tk, tv, tm, block_k=64).numpy()
    want = jref.decode_attention(*_j(q, kc, vc, valid), block_k=64)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    pallas = pl_decode(*_j(q, kc, vc, valid), block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)
    stats = tref.decode_attention(tq, tk, tv, tm, block_k=64, return_stats=True)
    jstats = jref.decode_attention(*_j(q, kc, vc, valid), block_k=64, return_stats=True)
    for g, w in zip(stats, jstats):  # unnormalised: l and acc reach ~1e2, f32 ulp ~1e-5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=ATOL)


def test_plain_decode_ragged_cache_matches_jax():
    """A cache length that is not a multiple of the block (the padding path)."""
    b, c, h, kv, dh = 2, 100, 4, 2, 16
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    kc = rng.standard_normal((b, c, kv, dh)).astype(np.float32)
    vc = rng.standard_normal((b, c, kv, dh)).astype(np.float32)
    valid = rng.random((b, c)) < 0.7
    got = tref.decode_attention(*_t(q, kc, vc, valid), block_k=64).numpy()
    want = jref.decode_attention(*_j(q, kc, vc, valid), block_k=64)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kind", ["flash", "decode"])
def test_bf16_tolerance_admits_reordering_and_rejects_planted_faults(kind):
    """The tolerance the CUDA kernels are held to (``ref.tolerance_ratio``):
    the plain version with the kernels' block sizes, its f32 sums in another
    order, passes; a dropped KV tile or cache split fails."""
    if kind == "flash":
        q, k, v = _bf16(*_qkv(1, 512, 512, 8, 2, 128, seed=4))
        want = tref.mha(q, k, v)
        reordered = tref.mha(q, k, v, block_q=64, block_k=32)
        fault = tref.mha(q, k, v, kv_valid_len=512 - 32)
    else:
        q, k, v = _bf16(*_qkv(4, 1, 1024, 8, 2, 128, seed=4))
        valid = torch.ones((4, 1024), dtype=torch.bool)
        want = tref.decode_attention(q, k, v, valid)
        reordered = tref.decode_attention(q, k, v, valid, block_k=256)
        dropped = valid.clone()
        dropped[:, 512:768] = False
        fault = tref.decode_attention(q, k, v, dropped)
    assert want.dtype == torch.bfloat16
    assert tref.tolerance_ratio(reordered, want) <= 1
    assert tref.tolerance_ratio(fault, want) > 1


def test_ops_on_cpu_tensors_launch_nothing():
    ops.reset_launch_counts()
    q, k, v = _t(*_qkv(1, 64, 64, 4, 2, 16))
    out = ops.mha(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), tref.mha(q, k, v).numpy(), atol=0)
    valid = torch.ones((1, 64), dtype=torch.bool)
    dq = q[:, :1]
    out = ops.decode_attention(dq, k, v, valid)
    np.testing.assert_allclose(out.numpy(),
                               tref.decode_attention(dq, k, v, valid).numpy(), atol=0)
    x, dt = torch.randn(1, 16, 2, 4), torch.rand(1, 16, 2)
    a, bm = -torch.arange(1.0, 3.0), torch.randn(1, 16, 1, 8)
    y, st = ops.ssd(x, dt, a, bm, bm, 8)
    y_w, st_w = tref.ssd_chunked(x, dt, a, bm, bm, 8)
    assert torch.equal(y, y_w) and torch.equal(st, st_w)
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain version: a CPU tensor raises."""
    q, k, v = _t(*_qkv(1, 64, 64, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="no kernel"):
        ops.mha(q.to("meta"), k.to("meta"), v.to("meta"))
    assert ops.launch_counts()["flash_attention"] == 0
    x, dt = torch.randn(1, 16, 2, 4), torch.rand(1, 16, 2)
    a, bm = -torch.arange(1.0, 3.0), torch.randn(1, 16, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tssd.ssd_scan(x, dt, a, bm, bm, 8)
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd(*(t.to("meta") for t in (x, dt, a, bm, bm)), 8)
    assert ops.launch_counts()["ssd_scan"] == 0
