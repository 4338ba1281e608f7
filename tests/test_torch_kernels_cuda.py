"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode) and skip
elsewhere.  They import neither JAX nor the JAX package; on a machine without
JAX run them without the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -o "markers=cuda: needs an NVIDIA GPU" \
        -q tests/test_torch_kernels_cuda.py

Tolerance: ``ref.tolerance_ratio`` <= 1, i.e. f32 1e-5 (the JAX package's
kernel tolerance); bf16 1e-5 + 2^-7 |plain|, one bf16 ulp of each element
(the kernel and the plain version both accumulate in f32 and round once to
bf16).  tests/test_torch_kernels.py shows that this bf16 tolerance rejects a
dropped KV tile or cache split.  The SSD scan (f32) is held to
``ref.ssd_tolerance_ratio`` <= 1: 1e-5 + 1e-4 of each (batch, head)'s
largest |value|, which tests/test_torch_ssm.py shows rejects a dropped
state or intra-chunk term.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as tssd

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, gen, scale=0.5):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,dtype,causal,window,q_offset", [
    (1, 256, 256, 8, 2, 128, torch.bfloat16, True, None, 0),
    (2, 1000, 1000, 8, 2, 128, torch.bfloat16, True, None, 0),   # ragged S
    (1, 512, 512, 8, 2, 128, torch.bfloat16, True, 100, 0),      # window
    (1, 300, 300, 4, 4, 64, torch.float32, True, None, 0),
    (1, 256, 256, 8, 2, 120, torch.bfloat16, True, None, 0),     # dh 120
    (1, 96, 96, 8, 8, 120, torch.float32, True, 40, 0),
    (2, 200, 200, 4, 2, 64, torch.float32, False, None, 0),      # not causal
    (1, 64, 320, 4, 1, 128, torch.float32, True, None, 256),     # q_offset
    # bf16 tensor-core kernel (64-row q tiles, 64-key KV tiles) at its tile edges
    (1, 1, 1, 8, 2, 128, torch.bfloat16, True, None, 0),
    (1, 63, 63, 8, 2, 128, torch.bfloat16, True, None, 0),
    (1, 65, 65, 8, 2, 64, torch.bfloat16, True, None, 0),
    (1, 127, 127, 8, 2, 120, torch.bfloat16, True, None, 0),
    (1, 129, 129, 8, 2, 128, torch.bfloat16, True, None, 0),
    (1, 4097, 4097, 8, 2, 128, torch.bfloat16, True, None, 0),
    (1, 300, 300, 8, 2, 128, torch.bfloat16, True, 77, 0),       # window, not a tile multiple
    (1, 100, 333, 8, 2, 128, torch.bfloat16, True, None, 233),   # q_offset, not a multiple
    (1, 100, 333, 8, 2, 120, torch.bfloat16, True, 90, 233),     # both
    (2, 512, 512, 32, 8, 128, torch.bfloat16, True, None, 0),    # llama3-8b heads
    (2, 200, 200, 8, 2, 64, torch.bfloat16, False, None, 0),     # not causal
    (1, 130, 257, 8, 2, 120, torch.bfloat16, False, None, 0),    # not causal, Sq != Sk
])
def test_flash_kernel_matches_plain(dev, b, sq, sk, h, kv, dh, dtype, causal, window,
                                    q_offset):
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn((b, sq, h, dh), dtype, dev, gen)
    k = _randn((b, sk, kv, dh), dtype, dev, gen)
    v = _randn((b, sk, kv, dh), dtype, dev, gen)
    before = tfa.KERNEL.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert tfa.KERNEL.launches == before + 1
    want = ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert got.dtype == dtype and got.shape == q.shape
    assert ref.tolerance_ratio(got, want) <= 1


@pytest.mark.parametrize("dtype,s,dh", [(torch.float32, 128, 64), (torch.bfloat16, 300, 128),
                                         (torch.bfloat16, 200, 120)])
def test_flash_kernel_reads_strided_views(dev, dtype, s, dh):
    """q/k/v sliced out of a fused [B,S,H+2KV,dh] tensor: no copy needed."""
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = _randn((1, s, 12, dh), dtype, dev, gen)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert not q.is_contiguous()
    got = tfa.flash_attention(q, k, v)
    want = ref.mha(q, k, v)
    assert ref.tolerance_ratio(got, want) <= 1


def _mask(kind, b, c, dev, gen):
    if kind == "prefix":  # each sequence valid up to its own length
        lens = torch.randint(1, c + 1, (b,), generator=gen, device=dev)
        return torch.arange(c, device=dev)[None, :] < lens[:, None]
    if kind == "holes":
        return torch.rand((b, c), generator=gen, device=dev) < 0.6
    if kind == "tail":  # every chunk but the last is empty: skipped tiles
        return (torch.arange(c, device=dev) >= c - 10)[None, :].expand(b, c)
    return torch.ones((b, c), dtype=torch.bool, device=dev)


@pytest.mark.parametrize("b,c,h,kv,dh,dtype,kind", [
    (2, 4096, 32, 8, 128, torch.bfloat16, "prefix"),
    (2, 4100, 32, 8, 128, torch.bfloat16, "holes"),   # ragged C
    (3, 300, 8, 2, 64, torch.float32, "holes"),
    (1, 513, 8, 8, 120, torch.float32, "all"),
    (2, 4096, 32, 4, 128, torch.float32, "tail"),
    # C not a multiple of the split, rep = 1, 2, 3, 8 and 16, dh 64 and 120 in bf16
    (2, 1000, 8, 8, 128, torch.bfloat16, "holes"),
    (2, 777, 16, 8, 128, torch.bfloat16, "prefix"),
    (1, 700, 24, 8, 120, torch.bfloat16, "holes"),
    (2, 4096, 64, 8, 128, torch.bfloat16, "all"),
    (1, 1500, 32, 2, 128, torch.bfloat16, "holes"),
    (2, 333, 8, 2, 64, torch.bfloat16, "prefix"),
    (2, 4096, 32, 8, 128, torch.bfloat16, "tail"),
    (1, 600, 16, 1, 128, torch.float32, "holes"),
])
def test_decode_kernel_matches_plain(dev, b, c, h, kv, dh, dtype, kind):
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _randn((b, 1, h, dh), dtype, dev, gen)
    kc = _randn((b, c, kv, dh), dtype, dev, gen)
    vc = _randn((b, c, kv, dh), dtype, dev, gen)
    valid = _mask(kind, b, c, dev, gen)
    before = tda.KERNEL.launches
    got = tda.decode_attention(q, kc, vc, valid)
    torch.cuda.synchronize()
    assert tda.KERNEL.launches == before + 1
    want = ref.decode_attention(q, kc, vc, valid)
    assert got.dtype == dtype and got.shape == q.shape
    assert ref.tolerance_ratio(got, want) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_reads_strided_caches(dev, dtype):
    """k and v caches sliced out of one [B,C,2KV,dh] tensor, a broadcast mask."""
    gen = torch.Generator(device=dev).manual_seed(7)
    b, c, h, kv, dh = 2, 1100, 32, 8, 128
    q = _randn((b, 1, h, dh), dtype, dev, gen)
    kvc = _randn((b, c, 2 * kv, dh), dtype, dev, gen)
    kc, vc = kvc[:, :, :kv], kvc[:, :, kv:]
    assert not kc.is_contiguous()
    valid = (torch.arange(c, device=dev) < 1050)[None, :].expand(b, c)
    got = tda.decode_attention(q, kc, vc, valid)
    want = ref.decode_attention(q, kc, vc, valid)
    assert ref.tolerance_ratio(got, want) <= 1


def test_kernels_refuse_unsupported_inputs(dev):
    q = torch.zeros((1, 64, 4, 256), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        tfa.flash_attention(q.half(), q.half(), q.half())
    q1 = torch.zeros((1, 1, 4, 64), device=dev)
    kc = torch.zeros((1, 16, 4, 64), device=dev)
    with pytest.raises(ValueError, match="valid_mask"):
        tda.decode_attention(q1, kc, kc, torch.ones((1, 15), dtype=torch.bool, device=dev))
    # bf16 rows are copied in 16-byte chunks: dh = 36 (72-byte rows) is refused
    qb = torch.zeros((1, 64, 4, 36), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte|head dim"):
        tfa.flash_attention(qb, qb, qb)
    with pytest.raises(ValueError, match="16-byte"):
        wide = torch.zeros((1, 64, 4, 72), device=dev, dtype=torch.bfloat16)
        tfa.flash_attention(wide[..., 4:68], wide[..., 4:68], wide[..., 4:68])


def _ssd_case(b, s, h, p, g, n, dev, gen, h_init=False):
    """Inputs at the model's scale: dt = softplus(z - 3), a = -(1..H)."""
    x = torch.randn((b, s, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev) - 3)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    bm = torch.randn((b, s, g, n), generator=gen, device=dev)
    cm = torch.randn((b, s, g, n), generator=gen, device=dev)
    h0 = torch.randn((b, h, p, n), generator=gen, device=dev) if h_init else None
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,h_init", [
    (2, 64, 4, 16, 2, 8, 8, False),        # tests/test_kernels.py's shapes
    (2, 64, 4, 16, 2, 8, 32, True),        # h_init
    (1, 512, 8, 64, 1, 128, 64, False),    # mamba2-370m's head and state
    (1, 300, 8, 64, 1, 128, 64, True),     # ragged S
    (2, 100, 6, 40, 3, 24, 16, False),     # P and N not multiples of 16, G=3
])
def test_ssd_kernel_matches_plain(dev, b, s, h, p, g, n, chunk, h_init):
    gen = torch.Generator(device=dev).manual_seed(3)
    x, dt, a, bm, cm, h0 = _ssd_case(b, s, h, p, g, n, dev, gen, h_init)
    before = tssd.KERNEL.launches
    y, st = tssd.ssd_scan(x, dt, a, bm, cm, chunk, h_init=h0)
    torch.cuda.synchronize()
    assert tssd.KERNEL.launches == before + 1
    y_w, st_w = ref.ssd_chunked(x, dt, a, bm, cm, chunk, h_init=h0)  # zero-pads a ragged S
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    assert ref.ssd_tolerance_ratio(y, y_w) <= 1
    assert ref.ssd_tolerance_ratio(st, st_w, head_dim=1) <= 1


def test_ssd_kernel_reads_strided_views(dev):
    """x, B and C sliced out of one conv output [B,S,channels], as ssm_apply does."""
    gen = torch.Generator(device=dev).manual_seed(4)
    b, s, h, p, g, n = 1, 256, 4, 32, 1, 64
    xbc = torch.randn((b, s, h * p + 2 * g * n), generator=gen, device=dev)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    assert not x.is_contiguous()
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev) - 3)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    y, st = tssd.ssd_scan(x, dt, a, bm, cm, 32)
    y_w, st_w = ref.ssd_chunked(x.contiguous(), dt, a, bm.contiguous(), cm.contiguous(), 32)
    assert ref.ssd_tolerance_ratio(y, y_w) <= 1
    assert ref.ssd_tolerance_ratio(st, st_w, head_dim=1) <= 1


def test_ssd_kernel_refuses_unsupported_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    x, dt, a, bm, cm, _ = _ssd_case(1, 64, 4, 16, 1, 8, dev, gen)
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_scan(x, dt, a, bm, cm, 128)
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_scan(x, dt, a, bm, cm, 10)
    with pytest.raises(ValueError):
        tssd.ssd_scan(x.bfloat16(), dt, a, bm, cm, 16)
    with pytest.raises(ValueError, match="shapes"):
        tssd.ssd_scan(x, dt, a[:3], bm, cm, 16)


def test_ops_ssd_on_the_card_never_runs_the_plain_version(dev, monkeypatch):
    gen = torch.Generator(device=dev).manual_seed(6)
    x, dt, a, bm, cm, _ = _ssd_case(1, 64, 4, 16, 1, 8, dev, gen)

    def plain(*a, **kw):
        raise AssertionError("ops.ssd ran the plain version on a CUDA tensor")
    monkeypatch.setattr(ref, "ssd_chunked", plain)
    before = tssd.KERNEL.launches
    ops.ssd(x, dt, a, bm, cm, 16)
    assert tssd.KERNEL.launches == before + 1

    def broken():
        raise RuntimeError("build failed")
    monkeypatch.setattr(tssd.KERNEL, "lib", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        ops.ssd(x, dt, a, bm, cm, 16)
