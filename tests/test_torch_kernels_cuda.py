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
dropped KV tile or cache split.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref

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


def test_flash_kernel_reads_strided_views(dev):
    """q/k/v sliced out of a fused [B,S,H+2KV,dh] tensor: no copy needed."""
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = _randn((1, 128, 12, 64), torch.float32, dev, gen)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
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
