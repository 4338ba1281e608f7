"""The port's plain attention kernels against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas kernels run in interpret mode, as the JAX package's own tests run
them.  f32 throughout, atol 1e-5 (the JAX package's kernel tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pl_decode
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_bwd as tfab
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import ssd_scan_bwd as tssdb

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
    (1, 64, 64, 2, 2, 256, True, None, 16, 32, 0),   # gemma-7b's head dim
    (1, 96, 96, 4, 2, 256, True, 40, 32, 16, 0),     # dh 256, GQA and a window
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


@pytest.mark.parametrize("valid_len,dh", [
    pytest.param(37, 64, id="37"), pytest.param(100, 64, id="100"),
    pytest.param(256, 64, id="256"), pytest.param(100, 256, id="100-dh256")])
def test_plain_decode_matches_jax(valid_len, dh):
    b, c, h, kv = 2, 256, 8, 2
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


def _mha_rounding_p(q, k, v, p_rounding, *, window=None, block_k=64):
    """Causal attention computed as the bf16 CUDA flash kernel computes it:
    KV tiles of ``block_k`` keys, scores, softmax statistics and sums in f32,
    and P rounded by ``p_rounding`` before P.V.  Products of two bf16 values
    are exact in f32, so the tensor cores' products are the f32 ones here.
    At dh 256 the kernel gives each half of the output columns to its own
    warp, both computing the same S: every element's sums are the ones here."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    q5 = q.reshape(b, s, kvh, h // kvh, dh).float()
    kf, vf = k.float(), v.float()
    m = torch.full((b, kvh, h // kvh, s), tref.NEG_INF)
    l = torch.zeros((b, kvh, h // kvh, s))
    acc = torch.zeros((b, kvh, h // kvh, s, dh))
    qi = torch.arange(s)
    for k0 in range(0, s, block_k):
        sc = torch.einsum("bqgrd,bkgd->bgrqk", q5, kf[:, k0:k0 + block_k]) * dh ** -0.5
        ki = k0 + torch.arange(sc.shape[-1])
        sc = torch.where(tref._block_mask(qi, ki, causal=True, window=window), sc, tref.NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        vb = vf[:, k0:k0 + block_k]
        pv = sum(torch.einsum("bgrqk,bkgd->bgrqd", part, vb) for part in p_rounding(p))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def _p_hi_lo(p):
    """The kernel's scheme: P = P_hi + P_lo, both bf16, two products."""
    hi = p.bfloat16().float()
    return hi, (p - hi).bfloat16().float()


def _p_bf16_once(p):
    """FlashAttention-2's and SDPA's scheme: P rounded once to bf16."""
    return (p.bfloat16().float(),)


@pytest.mark.parametrize("dh,window", [(128, None), (120, None), (128, 100), (256, None),
                                       (256, 100)])
def test_flash_kernel_p_split_holds_the_bf16_tolerance(dh, window):
    """The bf16 flash kernel splits P into a bf16 high and low part before
    P.V; that keeps its output within one bf16 ulp of ``ref.mha``
    (``tolerance_ratio`` <= 1), where P rounded once to bf16 does not."""
    q, k, v = _bf16(*_qkv(1, 512, 512, 8, 2, dh, seed=4))
    want = tref.mha(q, k, v, causal=True, window=window)
    split = tref.tolerance_ratio(_mha_rounding_p(q, k, v, _p_hi_lo, window=window), want)
    once = tref.tolerance_ratio(_mha_rounding_p(q, k, v, _p_bf16_once, window=window), want)
    assert split <= 1, split
    assert once > 1, once


def _mha_bwd_rounding(q, k, v, o, lse, do, roundings, *, window=None):
    """The backward computed as the bf16 CUDA kernels compute it: P in f32
    from the forward's lse, dP and delta exact in f32, and P (in dv = P^T do)
    or dS (in dk = dS^T q and dq = dS k) rounded by ``roundings["dv"]``,
    ``["dk"]`` and ``["dq"]`` before its product; the dk/dv kernel forms dS
    from P as the dv product takes it (hi + lo).  Products of two bf16 values
    are exact in f32, so the tensor cores' products are the f32 ones here,
    up to the order of summation.  At dh 256 each half of the output columns
    has its own block, both computing the same S and dP over all 256: every
    element's sums are the ones here."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    scale = dh ** -0.5
    q5, do5, o5 = (t.reshape(b, s, kvh, rep, dh).float() for t in (q, do, o))
    kf, vf = k.float(), v.float()
    qi = torch.arange(s)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", q5, kf) * scale
    sc = torch.where(tref._block_mask(qi, qi, causal=True, window=window), sc, tref.NEG_INF)
    p = torch.exp(sc - lse.reshape(b, kvh, rep, s)[..., None])
    dp = torch.einsum("bqgrd,bkgd->bgrqk", do5, vf)
    delta = torch.einsum("bqgrd,bqgrd->bgrq", do5, o5)
    p_dv = roundings["dv"](p)
    ds = sum(p_dv) * (dp - delta[..., None])
    dv = sum(torch.einsum("bgrqk,bqgrd->bkgd", part, do5) for part in p_dv)
    dk = sum(torch.einsum("bgrqk,bqgrd->bkgd", part, q5) for part in roundings["dk"](ds)) * scale
    dq = sum(torch.einsum("bgrqk,bkgd->bqgrd", part, kf) for part in roundings["dq"](ds)) * scale
    return (dq.reshape(b, s, h, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


@pytest.mark.parametrize("dh,window", [(128, None), (120, None), (128, 100), (120, 100),
                                       (256, None), (256, 100)])
def test_flash_bwd_kernel_p_and_ds_split_holds_the_bf16_tolerance(dh, window):
    """The bf16 backward kernels split P (in dv) and dS (in dk and dq) into a
    bf16 high and low part before each product; that keeps dq, dk and dv
    within one bf16 ulp of ``ref.mha_bwd`` (``grad_tolerance_ratio`` <= 1).
    Rounding P or dS once to bf16 in any one of the three products (the
    others split) does not: each split is needed."""
    q, k, v = _bf16(*_qkv(1, 512, 512, 8, 2, dh, seed=4))
    do = _bf16(_qkv(1, 512, 512, 8, 2, dh, seed=14)[0])[0]
    o, lse = tref.mha_fwd_lse(q, k, v, causal=True, window=window)
    want = tref.mha_bwd(q, k, v, o, lse, do, causal=True, window=window)
    split = {name: _p_hi_lo for name in ("dq", "dk", "dv")}
    got = _mha_bwd_rounding(q, k, v, o, lse, do, split, window=window)
    ratios = [tref.grad_tolerance_ratio(g, w) for g, w in zip(got, want)]
    assert max(ratios) <= 1, ratios
    for i, name in enumerate(("dq", "dk", "dv")):
        once = _mha_bwd_rounding(q, k, v, o, lse, do, {**split, name: _p_bf16_once},
                                 window=window)
        assert tref.grad_tolerance_ratio(once[i], want[i]) > 1, name


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
    xg = x.clone().requires_grad_()
    y, st = ops.ssd(xg, dt, a, bm, bm, 8)
    (y.sum() + st.sum()).backward()
    dx_w = tref.ssd_chunked_bwd(x, dt, a, bm, bm, 8, torch.ones_like(y), torch.ones_like(st))[0]
    assert torch.equal(xg.grad, dx_w)
    stats = ops.decode_attention(dq, k, v, valid, return_stats=True)
    for got, want in zip(stats, tref.decode_attention(dq, k, v, valid, return_stats=True)):
        assert torch.equal(got, want)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                   "decode_attention": 0, "decode_attention_bwd": 0,
                                   "decode_attention_stats": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}


def test_ops_decode_attention_on_cpu_keeps_its_gradient():
    """On CPU tensors ``ops.decode_attention`` with a gradient is its
    autograd function over the plain forward and ``ref.decode_attention_bwd``,
    and gives the gradient of the JAX package's ``decode_attention`` (its
    custom VJP); on the card the backward is the decode backward kernel
    (tests/test_torch_kernels_cuda.py)."""
    b, c, h, kv, dh = 2, 128, 8, 2, 16
    rng = np.random.default_rng(3)
    q = (rng.standard_normal((b, 1, h, dh)) * 0.5).astype(np.float32)
    kc = (rng.standard_normal((b, c, kv, dh)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((b, c, kv, dh)) * 0.5).astype(np.float32)
    valid = rng.random((b, c)) < 0.7
    dout = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, kc, vc))
    ops.reset_launch_counts()
    ops.decode_attention(tq, tk, tv, torch.from_numpy(valid)).backward(torch.from_numpy(dout))
    assert ops.launch_counts()["decode_attention"] == ops.launch_counts()[
        "decode_attention_bwd"] == 0
    _, vjp = jax.vjp(lambda a, k_, v_: pl_decode(a, k_, v_, jnp.asarray(valid), block_k=64,
                                                  interpret=True), *_j(q, kc, vc))
    for got, want in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_decode_grads_match_the_jax_custom_vjp():
    """Twin of tests/test_kernels.py::test_pallas_decode_grads_match_ref: the
    gradients of sum(sin(decode(q, k, v))) through ``ops.decode_attention``
    (the autograd function, plain versions on the CPU) against the JAX
    package's Pallas kernel (interpret mode, its custom VJP) and its oracle,
    the cache valid up to slot 100 of 128; the bool mask gets no gradient."""
    b, c, h, kv, dh = 1, 128, 4, 2, 32
    rng = np.random.default_rng(7)
    q = (rng.standard_normal((b, 1, h, dh)) * 0.5).astype(np.float32)
    kc, vc = ((rng.standard_normal((b, c, kv, dh)) * 0.5).astype(np.float32)
              for _ in range(2))
    valid = np.repeat((np.arange(c) < 100)[None, :], b, 0)

    def loss(fn):
        return lambda q_, k_, v_: jnp.sum(jnp.sin(fn(q_, k_, v_)))

    jv = jnp.asarray(valid)
    g_pallas = jax.grad(loss(lambda q_, k_, v_: pl_decode(q_, k_, v_, jv, block_k=64,
                                                          interpret=True)),
                        argnums=(0, 1, 2))(*_j(q, kc, vc))
    g_oracle = jax.grad(loss(lambda q_, k_, v_: jref.decode_attention(q_, k_, v_, jv)),
                        argnums=(0, 1, 2))(*_j(q, kc, vc))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, kc, vc))
    tvalid = torch.from_numpy(valid).requires_grad_(False)
    ops.decode_attention(tq, tk, tv, tvalid).sin().sum().backward()
    assert tvalid.grad is None
    for got, want_p, want_o in zip((tq.grad, tk.grad, tv.grad), g_pallas, g_oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_p), atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_o), atol=1e-5)
    assert not tk.grad[:, 100:].any() and not tv.grad[:, 100:].any()  # masked: exact zeros


def _chip_smoke():
    """``chip_smoke.py`` at the root of the repository, whose planted faults
    of the decode backward the kernel's checks on the card must see."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the decode backward kernel's cache split (csrc/decode_attention_bwd.cu, SPLIT)
_DECODE_SPLIT = 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,kv,dh,kind", [
    (2, 1000, 8, 2, 64, "prefix"), (1, 600, 8, 1, 256, "all"), (2, 513, 4, 4, 128, "holes"),
    (1, 300, 24, 2, 64, "holes")])  # 12 heads a group, as mistral-large-123b's 96 on 8
def test_decode_bwd_tolerance_rejects_planted_faults(dtype, b, c, h, kv, dh, kind):
    """The written-out backward that chip_smoke.py plants its faults in is the
    plain autograd's (P, dS; dq = scale dS k, dk = scale dS q summed over a
    group's heads, dv = P do summed); the tolerance the decode backward
    kernel is held to admits it and rejects each fault: the first split's dq
    partial dropped, and dk from each group's first query head only."""
    cs = _chip_smoke()
    rng = np.random.default_rng(11)
    q, do = ((rng.standard_normal((b, 1, h, dh)) * 0.5).astype(np.float32) for _ in range(2))
    kc, vc = ((rng.standard_normal((b, c, kv, dh)) * 0.5).astype(np.float32) for _ in range(2))
    if kind == "prefix":
        valid = np.arange(c)[None, :] < rng.integers(1, c + 1, (b, 1))
    elif kind == "holes":
        valid = rng.random((b, c)) < 0.6
        valid[:, 0] = True
    else:
        valid = np.ones((b, c), bool)
    q, do, kc, vc = (torch.from_numpy(x).to(dtype) for x in (q, do, kc, vc))
    valid = torch.from_numpy(valid)
    want = tref.decode_attention_bwd(q, kc, vc, valid, do)
    qr, dor, p, ds, scale = cs.decode_bwd_parts(q, kc, vc, valid, do)
    rep = h // kv
    written = (torch.einsum("bgrc,bcgd->bgrd", ds, kc.float()).reshape(b, 1, h, dh) * scale,
               torch.einsum("bgrc,bgrd->bcgd", ds, qr) * scale,
               torch.einsum("bgrc,bgrd->bcgd", p, dor))
    for g, w in zip(written, want):
        assert tref.grad_tolerance_ratio(g.to(dtype), w) <= 1
    faults = cs.decode_bwd_faults(q, kc, vc, valid, do, want, _DECODE_SPLIT)
    assert len(faults) == (2 if rep > 1 else 1)
    for label, fault, w in faults:
        assert tref.grad_tolerance_ratio(fault, w) > 1, label


def test_decode_bwd_wrapper_refuses_cpu_tensors():
    """The decode backward's CUDA wrapper never runs the plain version, and
    ``ops.decode_attention_bwd`` refuses a device with no route."""
    from repro_torch.kernels import decode_attention_bwd as tdab
    q, k, v = _t(*_qkv(1, 1, 64, 4, 2, 16))
    valid = torch.ones((1, 64), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdab.decode_attention_bwd(q, k, v, valid, q)
    other = _Elsewhere()
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_attention_bwd(other, other, other, valid, other)
    assert ops.launch_counts()["decode_attention_bwd"] == 0


class _Elsewhere:
    """A tensor's stand-in on a device that has neither a kernel nor a plain
    route (a CPU-only build of torch makes no tensor on such a device)."""

    device = torch.device("xpu")
    requires_grad = False


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain version: a CPU tensor raises.
    ``ops`` routes CPU and meta tensors to the plain versions, CUDA tensors
    to the kernels, and refuses any other device."""
    q, k, v = _t(*_qkv(1, 64, 64, 4, 2, 16))
    other = _Elsewhere()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="no kernel"):
        ops.mha(other, other, other)
    assert ops.launch_counts()["flash_attention"] == 0
    x, dt = torch.randn(1, 16, 2, 4), torch.rand(1, 16, 2)
    a, bm = -torch.arange(1.0, 3.0), torch.randn(1, 16, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tssd.ssd_scan(x, dt, a, bm, bm, 8)
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd(other, other, other, other, other, 8)
    assert ops.launch_counts()["ssd_scan"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        tssdb.ssd_scan_bwd(x, dt, a, bm, bm, 8, x, torch.zeros(1, 2, 4, 8))
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_bwd(other, other, other, other, other, 8, other, other)
    assert ops.launch_counts()["ssd_scan_bwd"] == 0


# causal, a binding window, GQA (rep 4 and 1), q_offset, ragged S and Sq != Sk
_BWD_CASES = [
    (2, 64, 64, 8, 2, 16, True, None, 16, 16, 0),
    (1, 96, 96, 4, 1, 16, True, 24, 32, 16, 0),
    (1, 60, 60, 4, 4, 8, True, None, 16, 16, 0),      # ragged: padded q rows and keys
    (2, 50, 50, 8, 2, 16, True, 17, 16, 32, 0),       # ragged and a window
    (1, 32, 96, 4, 2, 16, True, 40, 16, 32, 64),      # q_offset
    (2, 40, 72, 4, 2, 8, False, None, 16, 16, 0),     # not causal, Sq != Sk
    (1, 64, 64, 4, 2, 256, True, None, 16, 32, 0),    # gemma-7b's head dim
    (1, 32, 96, 2, 2, 256, True, 40, 16, 32, 64),     # dh 256, q_offset and a window
]


def _jax_blocked(q, k, v, do, *, causal, window, bq, bk, q_offset):
    """The JAX package's blocked forward and backward on the same inputs,
    in the port's public layout: (o, lse [B,H,Sq], dq, dk, dv)."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kw = dict(causal=causal, window=window, scale=dh ** -0.5, q_offset=q_offset,
              block_q=bq, block_k=bk)
    q5, k_, v_ = jnp.asarray(q.reshape(b, sq, kvh, h // kvh, dh)), jnp.asarray(k), jnp.asarray(v)
    q5, _ = jref._pad_to(q5, bq, 1)
    k_, _ = jref._pad_to(k_, bk, 1)
    v_, _ = jref._pad_to(v_, bk, 1)
    valid = sk if k_.shape[1] != sk else None
    out, lse = jref._mha_fwd_blocks(q5, k_, v_, kv_valid_len=valid, **kw)
    do5, _ = jref._pad_to(jnp.asarray(do.reshape(b, sq, kvh, h // kvh, dh)), bq, 1)
    dq, dk, dv = jref._mha_bwd_blocks(q5, k_, v_, out, lse, do5, kv_valid_len=valid, **kw)
    return (np.asarray(out)[:, :sq].reshape(b, sq, h, dh),
            np.asarray(lse).reshape(b, h, -1)[:, :, :sq],
            np.asarray(dq)[:, :sq].reshape(b, sq, h, dh), np.asarray(dk)[:, :sk],
            np.asarray(dv)[:, :sk])


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,bq,bk,q_offset", _BWD_CASES)
def test_plain_mha_fwd_lse_and_bwd_match_jax(b, sq, sk, h, kv, dh, causal, window, bq, bk,
                                             q_offset):
    """``ref.mha_fwd_lse`` and ``ref.mha_bwd`` against the JAX package's
    ``_mha_fwd_blocks`` and ``_mha_bwd_blocks`` with the same blocks."""
    q, k, v = _qkv(b, sq, sk, h, kv, dh)
    do = (np.random.default_rng(9).standard_normal((b, sq, h, dh)) * 0.5).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=bq, block_k=bk)
    o, lse = tref.mha_fwd_lse(*_t(q, k, v), **kw)
    grads = tref.mha_bwd(*_t(q, k, v), o, lse, torch.from_numpy(do), **kw)
    want = _jax_blocked(q, k, v, do, causal=causal, window=window, bq=bq, bk=bk,
                        q_offset=q_offset)
    for got, w in zip((o, lse) + grads, want):
        np.testing.assert_allclose(got.numpy(), w, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,bq,bk,q_offset", _BWD_CASES)
def test_plain_mha_bwd_matches_jax_vjp(b, sq, sk, h, kv, dh, causal, window, bq, bk, q_offset):
    """``ref.mha_bwd`` with the port's default blocks against ``jax.vjp`` of
    ``repro.kernels.ref.mha``, and ``ops.mha``'s gradient on CPU tensors
    against both."""
    q, k, v = _qkv(b, sq, sk, h, kv, dh)
    do = (np.random.default_rng(9).standard_normal((b, sq, h, dh)) * 0.5).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _, vjp = jax.vjp(lambda a, b_, c: jref.mha(a, b_, c, block_q=bq, block_k=bk, **kw),
                     *_j(q, k, v))
    want = vjp(jnp.asarray(do))
    o, lse = tref.mha_fwd_lse(*_t(q, k, v), **kw)
    got = tref.mha_bwd(*_t(q, k, v), o, lse, torch.from_numpy(do), **kw)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    ops.reset_launch_counts()
    ops.mha(tq, tk, tv, **kw).backward(torch.from_numpy(do))
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    for g, a, w in zip(got, (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=1e-5)
        np.testing.assert_allclose(a.numpy(), g.numpy(), atol=0)


@pytest.mark.parametrize("cast", [_bf16, _t])
def test_bwd_tolerance_admits_reordering_and_rejects_planted_faults(cast):
    """What the backward kernel is held to (``ref.grad_tolerance_ratio`` on
    dq, dk and dv): the plain backward with the kernel's tile sizes passes;
    one key tile's dk/dv dropped, one q tile's dq dropped, or one q tile's
    share of every dk/dv dropped (its rows of do zeroed) fails."""
    q, k, v = cast(*_qkv(1, 256, 256, 8, 2, 64, seed=5))
    do = cast(_qkv(1, 256, 256, 8, 2, 64, seed=6)[0])[0]
    o, lse = tref.mha_fwd_lse(q, k, v)
    want = tref.mha_bwd(q, k, v, o, lse, do)
    reordered = tref.mha_bwd(q, k, v, o, lse, do, block_q=32, block_k=64)
    assert all(tref.grad_tolerance_ratio(g, w) <= 1 for g, w in zip(reordered, want))
    dq, dk, dv = (t.clone() for t in want)
    dk[:, 64:128] = 0
    dv[:, 64:128] = 0
    dq[:, 128:192] = 0
    assert tref.grad_tolerance_ratio(dk, want[1]) > 1
    assert tref.grad_tolerance_ratio(dv, want[2]) > 1
    assert tref.grad_tolerance_ratio(dq, want[0]) > 1
    do_f = do.clone()
    do_f[:, 160:192] = 0
    _, dk_q, dv_q = tref.mha_bwd(q, k, v, o, lse, do_f)
    assert tref.grad_tolerance_ratio(dk_q, want[1]) > 1
    assert tref.grad_tolerance_ratio(dv_q, want[2]) > 1


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = _t(*_qkv(1, 64, 64, 4, 2, 16))
    o, lse = tref.mha_fwd_lse(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfab.flash_attention_bwd(q, k, v, o, lse, o)
    assert ops.launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_head_dim_limit_of_the_wrappers(dtype):
    """Every wrapper takes head dims up to its kernel's widest tile, 256, in
    whole 16-byte chunks of a row, and refuses the next chunk."""
    per16 = 16 // dtype.itemsize
    for mod in (tfa, tfab, tda):
        assert mod.MAX_HEAD_DIM == 256
        for dh in (per16, 64, 120, 128, 128 + per16, 192, 256):
            tfa.check_head_dim(dh, dtype, mod.MAX_HEAD_DIM)
        for dh in (0, 256 + per16, 512, 36 if dtype == torch.bfloat16 else 130):
            with pytest.raises(ValueError, match="head dim"):
                tfa.check_head_dim(dh, dtype, mod.MAX_HEAD_DIM)
    with pytest.raises(ValueError, match="at most 128"):
        tfa.check_head_dim(256, dtype, 128)


def _upper_half_zeroed(t):
    t = t.clone()
    t[..., 128:] = 0
    return t


@pytest.mark.parametrize("kind", ["flash", "decode", "bwd"])
def test_bf16_tolerance_rejects_the_faults_of_a_column_split(kind):
    """What the 256-wide kernels' column split could get wrong, at gemma-7b's
    dh 256 and rep 1: the output's columns 128-255 never written (zero), or S
    computed from the first 128 dims only.  Both fail the tolerance the
    kernels are held to (``tolerance_ratio``, ``grad_tolerance_ratio``)."""
    q, k, v = _bf16(*_qkv(1, 256, 256, 4, 4, 256, seed=7))
    half = _upper_half_zeroed
    if kind == "flash":
        want = tref.mha(q, k, v)
        faults = [half(want), tref.mha(half(q), k, v, scale=256 ** -0.5)]
        ratio = tref.tolerance_ratio
    elif kind == "decode":
        q1, valid = q[:, -1:], torch.ones((1, 256), dtype=torch.bool)
        want = tref.decode_attention(q1, k, v, valid)
        faults = [half(want), tref.decode_attention(half(q1), k, v, valid, scale=256 ** -0.5)]
        ratio = tref.tolerance_ratio
    else:
        do = _bf16(_qkv(1, 256, 256, 4, 4, 256, seed=8)[0])[0]
        o, lse = tref.mha_fwd_lse(q, k, v)
        want = tref.mha_bwd(q, k, v, o, lse, do)
        # dq, dk and dv with their upper columns dropped, and the gradients of
        # attention whose S sees only the first 128 dims
        s_half = tref.mha_bwd(half(q), k, v, *tref.mha_fwd_lse(half(q), k, v,
                                                                scale=256 ** -0.5),
                              do, scale=256 ** -0.5)
        for i in range(3):
            assert tref.grad_tolerance_ratio(half(want[i]), want[i]) > 1, i
        assert max(tref.grad_tolerance_ratio(g, w) for g, w in zip(s_half, want)) > 1
        return
    for fault in faults:
        assert ratio(fault, want) > 1
