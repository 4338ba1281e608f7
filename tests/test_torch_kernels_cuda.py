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
state or intra-chunk term; its backward to ``ref.ssd_grad_tolerance_ratio``
<= 1 on each gradient (the same form, the maxima per (batch, head), per
(batch, group) or per head).
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_bwd as tfab
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import ssd_scan_bwd as tssdb

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
    # bf16 wgmma kernel (128-row blocks of two 64-row warpgroups, 128-key KV
    # tiles up to dh 128, 64 at 256) at its tile edges
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
    # Sq and q_offset not multiples of 128 (nor of 64)
    (1, 200, 450, 8, 2, 128, torch.bfloat16, True, None, 250),
    (2, 333, 333, 4, 2, 64, torch.bfloat16, True, 129, 0),
    (1, 190, 317, 8, 2, 256, torch.bfloat16, True, None, 127),
    # the 256-wide tiles (gemma-7b: 16 heads on 16 kv heads, dh 256): S formed
    # once over all 256 columns, 64-key KV tiles
    (1, 256, 256, 16, 16, 256, torch.bfloat16, True, None, 0),
    (2, 1000, 1000, 8, 2, 256, torch.bfloat16, True, None, 0),   # ragged S, GQA
    (1, 512, 512, 8, 2, 256, torch.bfloat16, True, 100, 0),      # window
    (1, 100, 333, 8, 2, 256, torch.bfloat16, True, 90, 233),     # q_offset and window
    (1, 4097, 4097, 4, 4, 256, torch.bfloat16, True, None, 0),
    (1, 130, 257, 8, 2, 192, torch.bfloat16, False, None, 0),    # dh 192 zero-padded
    (1, 65, 65, 8, 2, 136, torch.bfloat16, True, None, 0),       # just past 128
    (1, 300, 300, 4, 4, 256, torch.float32, True, None, 0),
    (1, 200, 200, 8, 2, 256, torch.float32, True, 40, 0),
    (1, 64, 320, 4, 1, 256, torch.float32, True, None, 256),     # q_offset, rep 4
    # paligemma-3b: 8 heads on ONE kv head at dh 256 (rep 8); seamless-m4t-medium's
    # decoder: 16 heads on 16 at dh 64; both at their prefill's S=4096
    (1, 4096, 4096, 8, 1, 256, torch.bfloat16, True, None, 0),
    (1, 1000, 1000, 8, 1, 256, torch.bfloat16, True, None, 0),   # ragged S, rep 8
    (1, 100, 333, 8, 1, 256, torch.bfloat16, True, 90, 233),     # window and q_offset, rep 8
    (1, 4096, 4096, 16, 16, 64, torch.bfloat16, True, None, 0),
    # small grids (under one wave of 128-row blocks): 64-row blocks of one
    # consumer warpgroup; paligemma-3b's model-axis share (one head on one
    # kv head at dh 256), ragged, windowed, offset
    (1, 4096, 4096, 1, 1, 256, torch.bfloat16, True, None, 0),
    (1, 1000, 1000, 1, 1, 128, torch.bfloat16, True, None, 0),
    (1, 190, 317, 2, 1, 256, torch.bfloat16, True, 64, 127),
    (2, 4096, 4096, 2, 1, 64, torch.bfloat16, True, None, 0),
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
                                         (torch.bfloat16, 200, 120), (torch.bfloat16, 300, 256)])
def test_flash_kernel_reads_strided_views(dev, dtype, s, dh):
    """q/k/v sliced out of a fused [B,S,H+2KV,dh] tensor: no copy needed."""
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = _randn((1, s, 12, dh), dtype, dev, gen)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert not q.is_contiguous()
    got = tfa.flash_attention(q, k, v)
    want = ref.mha(q, k, v)
    assert ref.tolerance_ratio(got, want) <= 1


@pytest.mark.parametrize("dh", [64, 120, 256])
def test_flash_kernel_rejects_planted_faults(dev, dh):
    """The tolerance sees the faults of the bf16 forward's design: rows 64-127
    of every 128-row q tile zeroed (a consumer warpgroup dropped), the last
    64-column panel zeroed, and the last KV tile dropped (tiles from the
    library)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (_randn((1, 1024, n, dh), torch.bfloat16, dev, gen) for n in (8, 2, 2))
    got = tfa.flash_attention(q, k, v)
    want = ref.mha(q, k, v)
    assert ref.tolerance_ratio(got, want) <= 1
    rows, panel = got.clone(), got.clone()
    rows[:, torch.arange(1024, device=dev) % 128 >= 64] = 0
    panel[..., (dh - 1) // 64 * 64:] = 0
    tile = tfa.KERNEL.lib().repro_flash_attention_kv_tile(1, dh)
    assert tile == (64 if dh > 128 else 128)
    for fault in (rows, panel, ref.mha(q, k, v, kv_valid_len=1024 - tile)):
        assert ref.tolerance_ratio(fault, want) > 1


def test_flash_kernel_tiles_follow_the_shape(dev):
    """The library's tiles at the main paths' shapes: 128-row blocks and
    128-key tiles (64 at dh 256) at the prefills, 64-row blocks where a grid
    of 128-row blocks would not fill one wave (the model-axis shares), as
    tests/test_torch_kernels.py mirrors them."""
    lib = tfa.KERNEL.lib()
    for (b, s, h, dh), rows in (((1, 4096, 32, 128), 128), ((1, 4096, 16, 256), 128),
                                ((1, 4096, 8, 256), 128), ((1, 4096, 16, 64), 128),
                                ((1, 4096, 4, 120), 64), ((2, 4096, 2, 64), 64),
                                ((1, 4096, 1, 256), 64), ((1, 8448, 2, 128), 128),
                                ((1, 8320, 2, 128), 64)):
        assert lib.repro_flash_attention_q_tile(1, dh, b, s, h) == rows, (b, s, h, dh)
        assert lib.repro_flash_attention_kv_tile(1, dh) == (64 if dh > 128 else 128)
    assert lib.repro_flash_attention_q_tile(0, 128, 1, 4096, 32) == 64  # f32


# the backward kernels: bf16 64-key blocks walking 64-row q tiles of a part of
# a group's query heads (dk/dv) and 64-row blocks walking 64-key tiles (dq),
# both on wgmma, fed by TMA; f32 64-key blocks of 32-row steps and 64-row
# blocks of 32-key steps; edges of both, windows, q_offset, GQA and rep = 1
_BWD_CASES = [
    (1, 256, 256, 8, 2, 128, torch.bfloat16, True, None, 0),
    (1, 1, 1, 8, 2, 64, torch.bfloat16, True, None, 0),
    (1, 31, 31, 4, 2, 120, torch.bfloat16, True, None, 0),
    (1, 33, 33, 4, 1, 128, torch.float32, True, None, 0),
    (2, 63, 63, 8, 2, 120, torch.bfloat16, True, None, 0),
    (1, 65, 65, 8, 8, 64, torch.float32, True, None, 0),
    (1, 129, 129, 8, 2, 128, torch.bfloat16, True, 40, 0),
    (1, 1000, 1000, 32, 8, 120, torch.bfloat16, True, None, 0),   # h2o-danube heads, ragged
    (1, 700, 700, 8, 2, 120, torch.bfloat16, True, 100, 0),       # window binds
    (1, 300, 300, 4, 4, 64, torch.float32, True, 77, 0),
    (1, 100, 333, 8, 2, 128, torch.bfloat16, True, None, 233),    # q_offset
    (1, 100, 333, 8, 2, 120, torch.float32, True, 90, 233),       # both
    (2, 200, 200, 4, 2, 64, torch.float32, False, None, 0),       # not causal
    (1, 130, 257, 8, 2, 120, torch.bfloat16, False, None, 0),     # not causal, Sq != Sk
    # the bf16 tensor-core kernels at the edges of their 64-wide tiles
    (1, 127, 127, 8, 2, 128, torch.bfloat16, True, None, 0),      # S = 64k - 1
    (1, 129, 129, 8, 2, 64, torch.bfloat16, True, None, 0),       # S = 64k + 1
    (1, 4097, 4097, 8, 2, 120, torch.bfloat16, True, None, 0),
    (1, 1000, 1000, 8, 2, 128, torch.bfloat16, True, 200, 0),     # window across tiles
    (1, 300, 300, 8, 2, 120, torch.bfloat16, True, 33, 0),        # window within a tile
    (1, 64, 320, 8, 2, 64, torch.bfloat16, True, None, 256),      # q_offset, Sq < Sk
    (2, 130, 400, 8, 2, 120, torch.bfloat16, True, 150, 270),     # both, B = 2
    (1, 200, 200, 8, 8, 128, torch.bfloat16, True, None, 0),      # rep 1
    (1, 300, 300, 32, 8, 120, torch.bfloat16, True, None, 0),     # rep 4
    (1, 257, 257, 16, 2, 64, torch.bfloat16, True, None, 0),      # rep 8
    (2, 300, 300, 8, 2, 128, torch.bfloat16, True, None, 0),      # B = 2
    (1, 200, 200, 4, 2, 64, torch.bfloat16, False, 50, 0),        # window, not causal
    # 256 wide: one warpgroup each for dk and dv, two for dq (128 columns each)
    (1, 256, 256, 16, 16, 256, torch.bfloat16, True, None, 0),    # gemma-7b heads
    (1, 1000, 1000, 8, 2, 256, torch.bfloat16, True, None, 0),    # ragged, GQA
    (1, 700, 700, 8, 2, 256, torch.bfloat16, True, 100, 0),       # window binds
    (2, 130, 400, 8, 2, 256, torch.bfloat16, True, 150, 270),     # q_offset and window
    (1, 4097, 4097, 4, 4, 256, torch.bfloat16, True, None, 0),
    (1, 130, 257, 8, 2, 192, torch.bfloat16, False, None, 0),     # dh 192, not causal
    (1, 129, 129, 4, 1, 136, torch.bfloat16, True, None, 0),      # just past 128, rep 4
    (1, 300, 300, 4, 4, 256, torch.float32, True, 77, 0),
    (1, 100, 333, 8, 2, 256, torch.float32, True, None, 233),     # q_offset, GQA
    (2, 200, 200, 4, 2, 256, torch.float32, False, None, 0),      # not causal
    # paligemma-3b (8 heads on one kv head, dh 256) and seamless-m4t-medium's
    # decoder (16 on 16, dh 64) at their training shape, S=4096
    (1, 4096, 4096, 8, 1, 256, torch.bfloat16, True, None, 0),
    (1, 1000, 1000, 8, 1, 256, torch.bfloat16, True, None, 0),    # ragged S, rep 8
    (1, 100, 333, 8, 1, 256, torch.bfloat16, True, 90, 233),      # window and q_offset, rep 8
    (1, 4096, 4096, 16, 16, 64, torch.bfloat16, True, None, 0),
]


def _bwd_inputs(b, sq, sk, h, kv, dh, dtype, dev, seed, **kw):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = _randn((b, sq, h, dh), dtype, dev, gen)
    k = _randn((b, sk, kv, dh), dtype, dev, gen)
    v = _randn((b, sk, kv, dh), dtype, dev, gen)
    do = _randn((b, sq, h, dh), dtype, dev, gen)
    o, lse = ref.mha_fwd_lse(q, k, v, **kw)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,dtype,causal,window,q_offset", _BWD_CASES)
def test_flash_bwd_kernel_matches_plain(dev, b, sq, sk, h, kv, dh, dtype, causal, window,
                                        q_offset):
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, o, lse, do = _bwd_inputs(b, sq, sk, h, kv, dh, dtype, dev, 3, **kw)
    before = tfab.KERNEL.launches
    got = tfab.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert tfab.KERNEL.launches == before + 1
    want = ref.mha_bwd(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert ref.grad_tolerance_ratio(g, w) <= 1, name


@pytest.mark.parametrize("dtype,s,dh", [(torch.float32, 128, 64), (torch.bfloat16, 300, 128),
                                         (torch.bfloat16, 200, 120), (torch.bfloat16, 300, 256)])
def test_flash_bwd_kernel_reads_strided_views(dev, dtype, s, dh):
    """q/k/v sliced out of a fused [B,S,H+2KV,dh] tensor and do out of a wider
    one: no copy needed."""
    gen = torch.Generator(device=dev).manual_seed(8)
    qkv = _randn((1, s, 12, dh), dtype, dev, gen)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    do = _randn((1, s, 16, dh), dtype, dev, gen)[:, :, 4:12]
    assert not (q.is_contiguous() or k.is_contiguous() or do.is_contiguous())
    o, lse = ref.mha_fwd_lse(q, k, v)
    got = tfab.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.mha_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o, lse, do.contiguous())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert ref.grad_tolerance_ratio(g, w) <= 1, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_rejects_planted_faults(dev, dtype):
    """The tolerance sees one key tile's dk/dv or one q tile's dq dropped, and
    one q tile's contribution to every dk/dv dropped."""
    kw = dict(causal=True, window=None, q_offset=0)
    q, k, v, o, lse, do = _bwd_inputs(1, 512, 512, 8, 2, 120, dtype, dev, 4, **kw)
    dq, dk, dv = tfab.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.mha_bwd(q, k, v, o, lse, do, **kw)
    lib = tfab.KERNEL.lib()
    bk, bq = lib.repro_flash_attention_bwd_tile(0), lib.repro_flash_attention_bwd_tile(2)
    dk_f, dv_f, dq_f = dk.clone(), dv.clone(), dq.clone()
    dk_f[:, 128:128 + bk] = 0
    dv_f[:, 128:128 + bk] = 0
    dq_f[:, 256:256 + lib.repro_flash_attention_bwd_tile(1)] = 0
    assert ref.grad_tolerance_ratio(dk_f, want[1]) > 1
    assert ref.grad_tolerance_ratio(dv_f, want[2]) > 1
    assert ref.grad_tolerance_ratio(dq_f, want[0]) > 1
    do_f = do.clone()
    do_f[:, 320:320 + bq] = 0  # one q tile's rows contribute nothing to dk and dv
    _, dk_q, dv_q = ref.mha_bwd(q, k, v, o, lse, do_f, **kw)
    assert ref.grad_tolerance_ratio(dk_q, want[1]) > 1
    assert ref.grad_tolerance_ratio(dv_q, want[2]) > 1


@pytest.mark.parametrize("b,s,h,kv,dh", [(1, 1000, 8, 1, 256), (1, 1000, 32, 8, 120)])
def test_flash_bwd_kernel_gives_the_same_gradients_every_call(dev, b, s, h, kv, dh):
    """No atomics: the head parts' partials are summed in a fixed order, so
    two calls give the same dq, dk and dv bit for bit (rep 8 at dh 256, split
    in parts; danube's grouping at dh 120)."""
    q, k, v, o, lse, do = _bwd_inputs(b, s, s, h, kv, dh, torch.bfloat16, dev, 9)
    first = tfab.flash_attention_bwd(q, k, v, o, lse, do)
    again = tfab.flash_attention_bwd(q, k, v, o, lse, do)
    for name, x, y in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(x, y), name


def test_flash_bwd_kernel_rejects_a_dropped_head_part(dev):
    """At paligemma-3b's training shape (8 query heads on one kv head, dh
    256) the dk/dv pass splits the group's heads in parts, one block each;
    the tolerance sees one part's share of dk and dv left out (its heads'
    rows of do zeroed in the plain version), with the parts read from the
    library."""
    q, k, v, o, lse, do = _bwd_inputs(1, 4096, 4096, 8, 1, 256, torch.bfloat16, dev, 10)
    got = tfab.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.mha_bwd(q, k, v, o, lse, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert ref.grad_tolerance_ratio(g, w) <= 1, name
    parts = tfab.KERNEL.lib().repro_flash_attention_bwd_head_parts(1, 4096, 1, 8)
    assert 1 < parts <= 8 and 8 % parts == 0
    per = 8 // parts
    do_f = do.clone()
    do_f[:, :, per:2 * per] = 0  # the second part's heads contribute nothing
    _, dk_f, dv_f = ref.mha_bwd(q, k, v, o, lse, do_f)
    assert ref.grad_tolerance_ratio(dk_f, want[1]) > 1
    assert ref.grad_tolerance_ratio(dv_f, want[2]) > 1


@pytest.mark.parametrize("b,s,h,kv,dh,dtype,window", [
    (1, 1000, 32, 8, 120, torch.bfloat16, None), (1, 300, 8, 2, 128, torch.bfloat16, 77),
    (2, 129, 4, 4, 64, torch.float32, None), (1, 200, 8, 2, 120, torch.float32, 40),
    (1, 300, 16, 16, 256, torch.bfloat16, None), (1, 200, 8, 2, 256, torch.float32, 40),
    (1, 1000, 8, 1, 256, torch.bfloat16, None), (1, 300, 8, 1, 256, torch.bfloat16, 77),
    (1, 4096, 1, 1, 256, torch.bfloat16, None)])
def test_flash_kernel_lse_matches_plain(dev, b, s, h, kv, dh, dtype, window):
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (_randn((b, s, n, dh), dtype, dev, gen) for n in (h, kv, kv))
    o, lse = tfa.flash_attention(q, k, v, window=window, return_lse=True)
    o_w, lse_w = ref.mha_fwd_lse(q, k, v, window=window)
    assert ref.tolerance_ratio(o, o_w) <= 1
    assert ref.lse_tolerance_ratio(lse, lse_w) <= 1


def test_ops_mha_trains_through_the_kernels(dev):
    """With a gradient, ops.mha launches the forward and the backward kernel."""
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (_randn((1, 300, n, 120), torch.bfloat16, dev, gen).requires_grad_()
               for n in (8, 2, 2))
    ops.reset_launch_counts()
    o = ops.mha(q, k, v, causal=True)
    o.float().square().sum().backward()
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    o_w, lse_w = ref.mha_fwd_lse(q.detach(), k.detach(), v.detach())
    want = ref.mha_bwd(q.detach(), k.detach(), v.detach(), o.detach(), lse_w,
                       2 * o.detach().float().to(torch.bfloat16))
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert ref.grad_tolerance_ratio(g, w) <= 1


def test_ops_ssd_on_the_card_launches_both_kernels_and_matches_plain(dev):
    """Gradients through ``ops.ssd`` on the card launch the forward and the
    backward kernel once each, and match the plain backward (h_init too)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x, dt, a, bm, cm, h0 = _ssd_case(1, 200, 4, 16, 2, 8, dev, gen, h_init=True)
    ins = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm, h0)]
    ops.reset_launch_counts()
    y, st = ops.ssd(*ins[:5], 16, h_init=ins[5])
    (y.sin().sum() + st.cos().sum()).backward()
    assert ops.launch_counts()["ssd_scan"] == 1 and ops.launch_counts()["ssd_scan_bwd"] == 1
    want = ref.ssd_chunked_bwd(x, dt, a, bm, cm, 16, y.detach().cos(), -st.detach().sin(),
                               h_init=h0)
    ratios = ref.ssd_grad_ratios([t.grad for t in ins], want)
    assert len(ratios) == 6 and max(ratios.values()) <= 1, ratios


def test_ops_decode_attention_trains_through_the_kernels(dev):
    """With a gradient, ``ops.decode_attention`` launches the forward and the
    decode backward kernel once each, and its gradients are the plain
    version's autograd."""
    gen = torch.Generator(device=dev).manual_seed(6)
    q = _randn((2, 1, 8, 64), torch.bfloat16, dev, gen)
    kc, vc = (_randn((2, 700, 2, 64), torch.bfloat16, dev, gen) for _ in range(2))
    valid = _mask("prefix", 2, 700, dev, gen)
    do = _randn((2, 1, 8, 64), torch.bfloat16, dev, gen)
    ins = [t.clone().requires_grad_() for t in (q, kc, vc)]
    ops.reset_launch_counts()
    out = ops.decode_attention(*ins, valid)
    out.backward(do)
    counts = ops.launch_counts()
    assert counts["decode_attention"] == 1 and counts["decode_attention_bwd"] == 1
    assert ref.tolerance_ratio(out.detach(), ref.decode_attention(q, kc, vc, valid)) <= 1
    want = ref.decode_attention_bwd(q, kc, vc, valid, do)
    for name, g, w in zip(("dq", "dk", "dv"), (t.grad for t in ins), want):
        assert ref.grad_tolerance_ratio(g, w) <= 1, name


def test_ops_decode_stats_on_the_card_has_no_gradient(dev):
    """The stats variant has no backward: a CUDA input that needs a gradient
    is refused, not given none; without one the kernel runs."""
    gen = torch.Generator(device=dev).manual_seed(6)
    q = _randn((1, 1, 8, 64), torch.bfloat16, dev, gen)
    kc, vc = (_randn((1, 256, 2, 64), torch.bfloat16, dev, gen) for _ in range(2))
    valid = torch.ones((1, 256), dtype=torch.bool, device=dev)
    for grad_of in range(3):
        args = [q, kc, vc]
        args[grad_of] = args[grad_of].clone().requires_grad_()
        with pytest.raises(NotImplementedError, match="stats variant has no backward"):
            ops.decode_attention(*args, valid, return_stats=True)
    with torch.no_grad():
        before = tda.STATS.launches
        ops.decode_attention(q.requires_grad_(), kc, vc, valid, return_stats=True)
        assert tda.STATS.launches == before + 1


def _mask(kind, b, c, dev, gen):
    if kind == "prefix":  # each sequence valid up to its own length
        lens = torch.randint(1, c + 1, (b,), generator=gen, device=dev)
        return torch.arange(c, device=dev)[None, :] < lens[:, None]
    if kind == "holes":
        return torch.rand((b, c), generator=gen, device=dev) < 0.6
    if kind == "tail":  # every chunk but the last is empty: skipped tiles
        return (torch.arange(c, device=dev) >= c - 10)[None, :].expand(b, c)
    if kind == "holes_run":  # holes, and slots 1088-1151 masked: whole tiles inside a split
        m = torch.rand((b, c), generator=gen, device=dev) < 0.6
        m[:, 1088:1152] = False
        return m
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
    # 256 wide: a warp load covers one bf16 row; in f32 a lane loads two pieces of it
    (8, 4096, 16, 16, 256, torch.bfloat16, "prefix"),   # gemma-7b, rep 1
    (2, 4100, 16, 16, 256, torch.bfloat16, "holes"),
    (2, 1000, 32, 8, 256, torch.bfloat16, "holes"),     # rep 4
    (1, 700, 16, 1, 256, torch.bfloat16, "tail"),       # rep 16
    (2, 513, 8, 8, 192, torch.bfloat16, "all"),         # dh 192 zero-padded
    (3, 300, 8, 2, 256, torch.float32, "holes"),
    (2, 777, 64, 8, 256, torch.float32, "prefix"),      # rep 8
    (1, 600, 16, 1, 256, torch.float32, "tail"),        # rep 16
    # paligemma-3b (rep 8 in bf16 at dh 256) and seamless-m4t-medium's decoder
    # (rep 1 at dh 64) at B=8 and a full 4096-slot cache
    (8, 4096, 8, 1, 256, torch.bfloat16, "all"),
    (2, 4100, 8, 1, 256, torch.bfloat16, "holes"),      # ragged C, rep 8
    (8, 4096, 8, 1, 256, torch.bfloat16, "prefix"),
    (8, 4096, 16, 16, 64, torch.bfloat16, "all"),
    # the TMA kernel's plan: rep 12 in two head groups (mistral-large-123b's
    # 96 heads on 8), a grid of one kv head, whole masked tiles inside a split
    (8, 4096, 96, 8, 128, torch.bfloat16, "all"),
    (1, 4096, 8, 1, 256, torch.bfloat16, "all"),
    (2, 4096, 32, 8, 128, torch.bfloat16, "holes_run"),
    (8, 4096, 8, 1, 256, torch.bfloat16, "holes_run"),
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


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 128), (torch.bfloat16, 128),
                                      (torch.bfloat16, 120), (torch.bfloat16, 256)],
                         ids=["dtype0", "dtype1", "bf16-dh120", "bf16-dh256"])
def test_decode_kernel_reads_strided_caches(dev, dtype, dh):
    """k and v caches sliced out of one [B,C,2KV,dh] tensor, a broadcast mask;
    in bf16 the TMA maps take the caller's strides at every head-dim tile
    (120 zero-padded to 128)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    b, c, h, kv = 2, 1100, 32, 8
    q = _randn((b, 1, h, dh), dtype, dev, gen)
    kvc = _randn((b, c, 2 * kv, dh), dtype, dev, gen)
    kc, vc = kvc[:, :, :kv], kvc[:, :, kv:]
    assert not kc.is_contiguous()
    valid = (torch.arange(c, device=dev) < 1050)[None, :].expand(b, c)
    got = tda.decode_attention(q, kc, vc, valid)
    want = ref.decode_attention(q, kc, vc, valid)
    assert ref.tolerance_ratio(got, want) <= 1


def test_decode_plan_follows_the_shape(dev):
    """The bf16 kernel's plan from its library: (slots a split, splits) at
    the decode shapes, as tests/test_torch_kernels.py's ``_decode_fwd_plan``
    mirrors it (one block for each of 132 SMs; a tile of 32 KB of K and V);
    the f32 kernel's 256-slot splits."""
    lib = tda.KERNEL.lib()
    for (b, c, h, kv, dh), want in (((8, 4096, 8, 1, 256), (256, 16, 32)),
                                    ((8, 4096, 32, 8, 128), (2048, 2, 64)),
                                    ((1, 4096, 32, 8, 128), (256, 16, 64)),
                                    ((8, 4096, 16, 16, 64), (4096, 1, 128)),
                                    ((8, 4096, 16, 16, 256), (4096, 1, 32)),
                                    ((2, 777, 16, 8, 120), (128, 7, 64))):
        got = (lib.repro_decode_split(1, b, c, h, kv, dh),
               lib.repro_decode_num_splits(1, b, c, h, kv, dh), lib.repro_decode_plan(1, h // kv,
                                                                                     dh, 0))
        assert got == want, (b, c, h, kv, dh, got)
    assert (lib.repro_decode_split(0, 8, 4096, 32, 8, 128),
            lib.repro_decode_num_splits(0, 8, 4096, 32, 8, 128)) == (256, 16)


@pytest.mark.parametrize("b,c,h,kv,dh", [(8, 4096, 8, 1, 256), (8, 4096, 16, 16, 256),
                                         (2, 4100, 96, 8, 128), (3, 777, 24, 8, 64)])
def test_decode_kernel_residual_output_is_the_plain_calls(dev, b, c, h, kv, dh):
    """With residuals the bf16 kernel's rounded output is the plain call's
    bit for bit, where the combine pass writes it (16 splits, 7) and where
    pass 1 does (one split: gemma-7b's B*KV = 128)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    q = _randn((b, 1, h, dh), torch.bfloat16, dev, gen)
    kc, vc = (_randn((b, c, kv, dh), torch.bfloat16, dev, gen) for _ in range(2))
    valid = _mask("holes", b, c, dev, gen)
    out, lse, o32 = tda.decode_attention(q, kc, vc, valid, residuals=True)
    assert torch.equal(out, tda.decode_attention(q, kc, vc, valid))
    assert torch.equal(out, o32.to(torch.bfloat16))
    assert ref.tolerance_ratio(out, ref.decode_attention(q, kc, vc, valid)) <= 1


def _stats_mask(kind, b, c, dev, gen, split=256):
    """_mask's kinds, and a shard with no valid slot ("empty") or whose
    first ``split``-slot split has none ("split0")."""
    if kind == "empty":
        return torch.zeros((b, c), dtype=torch.bool, device=dev)
    if kind == "split0":
        return (torch.arange(c, device=dev) >= split)[None, :].expand(b, c)
    return _mask(kind, b, c, dev, gen)


@pytest.mark.parametrize("b,c,h,kv,dh,dtype,kind", [
    (1, 4096, 32, 8, 128, torch.bfloat16, "all"),      # llama3-8b's shard of 8 rails
    (2, 4100, 32, 8, 128, torch.bfloat16, "holes"),    # ragged C
    (1, 4096, 4, 1, 128, torch.bfloat16, "prefix"),    # a model rank's share
    (1, 4096, 32, 8, 128, torch.bfloat16, "split0"),
    (1, 4096, 32, 8, 128, torch.bfloat16, "empty"),
    (3, 300, 8, 2, 64, torch.float32, "holes"),
    (1, 700, 16, 1, 256, torch.bfloat16, "tail"),
    (2, 1000, 8, 8, 256, torch.float32, "prefix"),
    # B*KV = 128: one split, the stats written by pass 1 itself
    (8, 1000, 64, 16, 128, torch.bfloat16, "holes"),
    (8, 700, 16, 16, 64, torch.bfloat16, "empty"),
])
def test_decode_stats_kernel_matches_plain(dev, b, c, h, kv, dh, dtype, kind):
    """The stats variant against ``ref.decode_attention(return_stats=True)``
    by ``ref.stats_tolerance_ratio`` (m, l, and acc / l as the output); it
    counts its own launches, through ``ops`` too."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _randn((b, 1, h, dh), dtype, dev, gen)
    kc = _randn((b, c, kv, dh), dtype, dev, gen)
    vc = _randn((b, c, kv, dh), dtype, dev, gen)
    split = tda.KERNEL.lib().repro_decode_split(tda.DTYPES[dtype], b, c, h, kv, dh)
    valid = _stats_mask(kind, b, c, dev, gen, split)
    before, fwd = tda.STATS.launches, tda.KERNEL.launches
    got = ops.decode_attention(q, kc, vc, valid, return_stats=True)
    torch.cuda.synchronize()
    assert (tda.STATS.launches, tda.KERNEL.launches) == (before + 1, fwd)
    assert [t.shape for t in got] == [(b, kv, h // kv, dh), (b, kv, h // kv), (b, kv, h // kv)]
    want = ref.decode_attention(q, kc, vc, valid, return_stats=True)
    assert ref.stats_tolerance_ratio(got, want, dtype) <= 1
    if kind == "empty":
        assert bool((got[1] <= ref.NEG_INF / 2).all()) and bool((got[2] == 0).all())


def test_decode_stats_kernel_rejects_a_dropped_split(dev):
    """Planted faults, emulated in the plain version: one split of 4096 (the
    plan's, 256 slots) dropped, or one tile inside a split, reads > 1."""
    gen = torch.Generator(device=dev).manual_seed(4)
    q = _randn((1, 1, 32, 128), torch.bfloat16, dev, gen)
    kc = _randn((1, 4096, 8, 128), torch.bfloat16, dev, gen)
    vc = _randn((1, 4096, 8, 128), torch.bfloat16, dev, gen)
    valid = torch.ones((1, 4096), dtype=torch.bool, device=dev)
    got = tda.decode_attention_stats(q, kc, vc, valid)
    lib = tda.KERNEL.lib()
    split = lib.repro_decode_split(1, 1, 4096, 32, 8, 128)
    tile = lib.repro_decode_plan(1, 4, 128, 0)
    assert ref.stats_tolerance_ratio(got, ref.decode_attention(q, kc, vc, valid,
                                                               return_stats=True),
                                     torch.bfloat16) <= 1
    for lo, hi in ((4 * split, 5 * split), (4 * split + tile, 4 * split + 2 * tile)):
        dropped = valid.clone()
        dropped[:, lo:hi] = False
        assert ref.stats_tolerance_ratio(got, ref.decode_attention(q, kc, vc, dropped,
                                                                   return_stats=True),
                                         torch.bfloat16) > 1


# bf16 and f32; dh 64, 128 (and 120 zero-padded) and 256; rep 1, 4, 8 and 16; a
# ragged mask, a row with few valid slots, caches that are no multiple of the split
_DECODE_BWD_CASES = [
    (b, c, kv * rep, kv, dh, dtype, kind)
    for dtype in (torch.bfloat16, torch.float32)
    for dh, kv in ((64, 4), (128, 2), (256, 1))
    for rep, c, kind in ((1, 1000, "prefix"), (4, 4096, "few"), (8, 777, "holes"))
    for b in (2,)
] + [
    (8, 4096, 32, 8, 128, torch.bfloat16, "all"),     # llama3-8b's decode
    (8, 4096, 8, 1, 256, torch.bfloat16, "all"),      # paligemma-3b's
    (2, 4100, 32, 8, 120, torch.bfloat16, "holes"),   # dh 120, ragged C
    (1, 300, 16, 1, 128, torch.bfloat16, "prefix"),   # rep 16
    (1, 513, 32, 2, 256, torch.float32, "few"),       # rep 16, f32 at 256
    (3, 255, 8, 2, 64, torch.float32, "tail"),        # one split, empty tiles
    # rep not a power of two: the block's padding heads must give P = 0
    (2, 4096, 96, 8, 128, torch.bfloat16, "holes"),   # rep 12, mistral-large's 96 on 8
    (1, 513, 12, 1, 256, torch.bfloat16, "holes"),    # rep 12 at 256: a sweep of padding
    (1, 1000, 12, 2, 256, torch.float32, "prefix"),   # rep 6, f32 at 256
    (2, 777, 24, 8, 64, torch.bfloat16, "few"),       # rep 3
]


def _decode_bwd_mask(kind, b, c, dev, gen):
    if kind == "few":  # each row sees a handful of slots, first among them
        m = torch.rand((b, c), generator=gen, device=dev) < 4 / c
        m[:, 0] = True
        return m
    return _mask(kind, b, c, dev, gen)


def _decode_bwd_route(route, q, kc, vc, valid, do):
    """The decode backward kernel's gradients by one route: "autograd"
    (``ops.decode_attention``: the forward kernel keeps its residuals, the
    backward takes them) or "wrapper" (the backward's wrapper alone, which
    launches the forward kernel for them).  Each launches the forward and
    the backward kernel once."""
    from repro_torch.kernels import decode_attention_bwd as tdab
    before = (tda.KERNEL.launches, tdab.KERNEL.launches)
    if route == "autograd":
        ins = [t.clone().requires_grad_() for t in (q, kc, vc)]
        ops.decode_attention(*ins, valid).backward(do)
        got = tuple(t.grad for t in ins)
    else:
        got = tdab.decode_attention_bwd(q, kc, vc, valid, do)
    torch.cuda.synchronize()
    assert (tda.KERNEL.launches, tdab.KERNEL.launches) == (before[0] + 1, before[1] + 1)
    return got


@pytest.mark.parametrize("route", ["autograd", "wrapper"])
@pytest.mark.parametrize("b,c,h,kv,dh,dtype,kind", _DECODE_BWD_CASES)
def test_decode_bwd_kernel_matches_plain(dev, b, c, h, kv, dh, dtype, kind, route):
    """dq, dk and dv of the decode backward kernel, by both routes to the
    forward's residuals, against the plain version's autograd within
    ``ref.grad_tolerance_ratio``; masked slots get exact zeros."""
    gen = torch.Generator(device=dev).manual_seed(9)
    q, do = (_randn((b, 1, h, dh), dtype, dev, gen) for _ in range(2))
    kc, vc = (_randn((b, c, kv, dh), dtype, dev, gen) for _ in range(2))
    valid = _decode_bwd_mask(kind, b, c, dev, gen)
    got = _decode_bwd_route(route, q, kc, vc, valid, do)
    want = ref.decode_attention_bwd(q, kc, vc, valid, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert ref.grad_tolerance_ratio(g, w) <= 1, name
    masked = ~valid
    assert not got[1][masked].any() and not got[2][masked].any()


@pytest.mark.parametrize("route", ["autograd", "wrapper"])
@pytest.mark.parametrize("dtype,h,kv,dh", [(torch.bfloat16, 32, 8, 128),
                                           (torch.float32, 8, 1, 256)])
def test_decode_bwd_kernel_gives_a_masked_row_zeros(dev, dtype, h, kv, dh, route):
    """A batch row with no valid slot gets dq = dk = dv = 0 (no NaN); the
    other rows match the plain version's autograd."""
    gen = torch.Generator(device=dev).manual_seed(13)
    q, do = (_randn((3, 1, h, dh), dtype, dev, gen) for _ in range(2))
    kc, vc = (_randn((3, 1000, kv, dh), dtype, dev, gen) for _ in range(2))
    valid = _mask("holes", 3, 1000, dev, gen)
    valid[1] = False
    got = _decode_bwd_route(route, q, kc, vc, valid, do)
    want = ref.decode_attention_bwd(q, kc, vc, valid, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert not g[1].any() and not g.isnan().any(), name
        keep = torch.tensor([0, 2], device=dev)
        assert ref.grad_tolerance_ratio(g[keep], w[keep]) <= 1, name


@pytest.mark.parametrize("dtype,h,kv,dh", [(torch.bfloat16, 32, 8, 128),
                                           (torch.bfloat16, 8, 1, 256),
                                           (torch.float32, 24, 2, 64)])
def test_decode_bwd_kernel_gives_the_same_gradients_every_call(dev, dtype, h, kv, dh):
    """Two calls on the same inputs and residuals are bit-identical: the
    splits' dq partials are summed in split order, with no atomics."""
    from repro_torch.kernels import decode_attention_bwd as tdab
    gen = torch.Generator(device=dev).manual_seed(14)
    q, do = (_randn((8, 1, h, dh), dtype, dev, gen) for _ in range(2))
    kc, vc = (_randn((8, 4096, kv, dh), dtype, dev, gen) for _ in range(2))
    valid = _mask("prefix", 8, 4096, dev, gen)
    _, lse, o32 = tda.decode_attention(q, kc, vc, valid, residuals=True)
    first = tdab.decode_attention_bwd(q, kc, vc, valid, do, lse=lse, o=o32)
    again = tdab.decode_attention_bwd(q, kc, vc, valid, do, lse=lse, o=o32)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("b,c,h,kv,dh,dtype,kind", [
    (8, 4096, 32, 8, 128, torch.bfloat16, "all"), (8, 4096, 8, 1, 256, torch.bfloat16, "all"),
    (2, 4100, 24, 8, 120, torch.bfloat16, "holes"), (3, 300, 8, 2, 64, torch.float32, "holes"),
    (2, 777, 32, 2, 256, torch.float32, "few")])
def test_decode_kernel_residuals_match_plain(dev, b, c, h, kv, dh, dtype, kind):
    """The forward kernel's residual mode: its rounded output is the plain
    mode's bit for bit; lse to ``ref.lse_tolerance_ratio`` and the f32 output
    to ``ref.tolerance_ratio`` of ``ref.decode_attention_fwd_lse``'s."""
    gen = torch.Generator(device=dev).manual_seed(15)
    q = _randn((b, 1, h, dh), dtype, dev, gen)
    kc, vc = (_randn((b, c, kv, dh), dtype, dev, gen) for _ in range(2))
    valid = _decode_bwd_mask(kind, b, c, dev, gen)
    out, lse, o32 = tda.decode_attention(q, kc, vc, valid, residuals=True)
    assert torch.equal(out, tda.decode_attention(q, kc, vc, valid))
    _, want_lse, want_o32 = ref.decode_attention_fwd_lse(q, kc, vc, valid)
    assert ref.lse_tolerance_ratio(lse, want_lse) <= 1
    assert ref.tolerance_ratio(o32, want_o32) <= 1


@pytest.mark.parametrize("dtype,h,kv,dh", [(torch.bfloat16, 32, 8, 128),
                                           (torch.float32, 32, 8, 128),
                                           (torch.bfloat16, 8, 1, 256),
                                           (torch.bfloat16, 96, 8, 128)])
def test_decode_bwd_kernel_rejects_planted_faults(dev, dtype, h, kv, dh):
    """The tolerance sees one split's dq partial dropped and dk without the
    sum over a group's query heads (chip_smoke.py's planted faults)."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import decode_attention_bwd as tdab
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    gen = torch.Generator(device=dev).manual_seed(10)
    q, do = (_randn((4, 1, h, dh), dtype, dev, gen) for _ in range(2))
    kc, vc = (_randn((4, 2048, kv, dh), dtype, dev, gen) for _ in range(2))
    valid = _mask("prefix", 4, 2048, dev, gen)
    got = tdab.decode_attention_bwd(q, kc, vc, valid, do)
    want = ref.decode_attention_bwd(q, kc, vc, valid, do)
    for g, w in zip(got, want):
        assert ref.grad_tolerance_ratio(g, w) <= 1
    faults = cs.decode_bwd_faults(q, kc, vc, valid, do, want,
                                  tdab.KERNEL.lib().repro_decode_bwd_split(4, 2048, kv, dh))
    assert len(faults) == 2
    for label, fault, w in faults:
        assert ref.grad_tolerance_ratio(fault, w) > 1, label


def test_decode_bwd_kernel_refuses_unsupported_inputs(dev):
    from repro_torch.kernels import decode_attention_bwd as tdab
    gen = torch.Generator(device=dev).manual_seed(12)
    q = _randn((1, 1, 8, 64), torch.bfloat16, dev, gen)
    kc, vc = (_randn((1, 256, 2, 64), torch.bfloat16, dev, gen) for _ in range(2))
    valid = torch.ones((1, 256), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="q's shape"):
        tdab.decode_attention_bwd(q, kc, vc, valid, q[:, :, :4])
    with pytest.raises(ValueError, match="must be"):
        tdab.decode_attention_bwd(q, kc, vc, valid, q.float())
    with pytest.raises(ValueError, match="query heads per kv head"):
        q32 = _randn((1, 1, 64, 64), torch.bfloat16, dev, gen)
        tdab.decode_attention_bwd(q32, kc, vc, valid, q32)
    _, lse, o32 = tda.decode_attention(q, kc, vc, valid, residuals=True)
    with pytest.raises(ValueError, match="give both or neither"):
        tdab.decode_attention_bwd(q, kc, vc, valid, q, lse=lse)
    with pytest.raises(ValueError, match="contiguous f32"):
        tdab.decode_attention_bwd(q, kc, vc, valid, q, lse=lse[:, :4], o=o32)


def test_kernels_refuse_unsupported_inputs(dev):
    # one 16-byte chunk past the widest tile (256): refused by every wrapper
    q = torch.zeros((1, 64, 4, 264), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)
    lse = torch.zeros((1, 4, 64), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tfab.flash_attention_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="head dim"):
        tda.decode_attention(q[:, :1], q, q, torch.ones((1, 64), dtype=torch.bool, device=dev))
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


# the forward's and the backward's cases
_SSD_CASES = [
    (2, 64, 4, 16, 2, 8, 8, False),        # tests/test_kernels.py's shapes
    (2, 64, 4, 16, 2, 8, 32, True),        # h_init
    (1, 512, 8, 64, 1, 128, 64, False),    # mamba2-370m's head and state
    (1, 300, 8, 64, 1, 128, 64, True),     # ragged S
    (2, 100, 6, 40, 3, 24, 16, False),     # P and N not multiples of 16, G=3
    # several segments of chunks (passes B-D), mamba2-370m's head and state
    (1, 4096, 8, 64, 1, 128, 64, False),
    (1, 4000, 8, 64, 1, 128, 64, False),   # ragged last chunk inside the last segment
    (2, 4096, 4, 64, 1, 128, 64, True),    # h_init carried across segments
    (1, 4096, 8, 64, 2, 128, 64, True),    # G=2: one C B^T per group shared by 4 heads
    (1, 2050, 4, 40, 2, 24, 32, True),     # P, N not multiples of 16, a 2-position chunk
    (1, 999, 3, 6, 1, 10, 12, True),       # rows not 16-byte aligned: 4-byte copies
    (1, 4096, 128, 64, 1, 16, 64, False),  # jamba-v0.1-52b's mixer: H=128, N=16
]


# and the forward's own, at the shapes its heads-a-block plan has to serve
_SSD_FWD_CASES = _SSD_CASES + [
    (1, 4096, 4, 64, 1, 128, 64, False),    # mamba2-370m's share on a model axis of 8
    (1, 4096, 32, 64, 1, 128, 64, False),   # mamba2-370m's training forward
    (1, 2048, 24, 64, 2, 128, 64, False),   # rep 12: H=24 on G=2
    (1, 2048, 6, 64, 2, 128, 64, False),    # 3 heads a group: 2 a block do not divide it
    (1, 6000, 4, 64, 1, 128, 64, True),     # h_init at P=64 N=128 over several segments
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,h_init", _SSD_FWD_CASES)
def test_ssd_kernel_matches_plain(dev, b, s, h, p, g, n, chunk, h_init):
    gen = torch.Generator(device=dev).manual_seed(3)
    x, dt, a, bm, cm, h0 = _ssd_case(b, s, h, p, g, n, dev, gen, h_init)
    if s >= 2048:  # these cases are there for the segment passes
        assert tssd.plan(b, s, h, p, g, n, chunk).segments > 1
    before = tssd.KERNEL.launches
    y, st = tssd.ssd_scan(x, dt, a, bm, cm, chunk, h_init=h0)
    torch.cuda.synchronize()
    assert tssd.KERNEL.launches == before + 1
    y_w, st_w = ref.ssd_chunked(x, dt, a, bm, cm, chunk, h_init=h0)  # zero-pads a ragged S
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    assert ref.ssd_tolerance_ratio(y, y_w) <= 1
    assert ref.ssd_tolerance_ratio(st, st_w, head_dim=1) <= 1


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 4096, 32, 64, 1, 128, 64),     # several segments, TMA loads
    (1, 999, 3, 6, 1, 10, 12),         # rows not 16-byte aligned: cp.async loads
    (1, 4096, 128, 64, 1, 16, 64),     # jamba's mixer
])
def test_ssd_kernel_gives_the_same_bits_every_call(dev, b, s, h, p, g, n, chunk):
    """No atomics: two calls on the same inputs give identical y and state."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x, dt, a, bm, cm, h0 = _ssd_case(b, s, h, p, g, n, dev, gen, h_init=True)
    first = tssd.ssd_scan(x, dt, a, bm, cm, chunk, h_init=h0)
    second = tssd.ssd_scan(x, dt, a, bm, cm, chunk, h_init=h0)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


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


# and the backward's own: jamba's mixer with h_init, a = -(1..128), where da
# was the hardest gradient to hold (dh_init held there too); then the shapes
# of its `wgmma` passes: mamba2-370m's model-axis share and training layer,
# rep 12, and a chunk of 32 (a half-height tile) at full width on G=2
_SSD_BWD_CASES = _SSD_CASES + [
    (1, 4096, 128, 64, 1, 16, 64, True),
    (1, 4096, 4, 64, 1, 128, 64, False),    # mamba2-370m's share on a model axis of 8
    (1, 4096, 32, 64, 1, 128, 64, True),    # mamba2-370m's training layer, h_init
    (1, 2048, 24, 64, 2, 128, 64, False),   # rep 12: H=24 on G=2
    (1, 2048, 6, 64, 2, 128, 32, False),    # a chunk of 32 at P=64 N=128, G=2
    # the walks' segments on an H100 (132 SMs): 10 of 5 chunks, the last of
    # 2 with a ragged last chunk, G=2; then 9 of 4, the last of 3, with
    # h_init at N=64 (one 64-row tile of N)
    (1, 3000, 6, 64, 2, 128, 64, False),
    (1, 2200, 6, 64, 1, 64, 64, True),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,h_init", _SSD_BWD_CASES)
def test_ssd_bwd_kernel_matches_plain(dev, b, s, h, p, g, n, chunk, h_init):
    gen = torch.Generator(device=dev).manual_seed(7)
    x, dt, a, bm, cm, h0 = _ssd_case(b, s, h, p, g, n, dev, gen, h_init)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev)
    dst = torch.randn((b, h, p, n), generator=gen, device=dev)
    before = tssdb.KERNEL.launches
    got = tssdb.ssd_scan_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h0)
    torch.cuda.synchronize()
    assert tssdb.KERNEL.launches == before + 1
    want = ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h0)
    for gt, wt in zip(got, want):
        assert (gt is None) == (wt is None)
        if gt is not None:
            assert gt.shape == wt.shape
    ratios = ref.ssd_grad_ratios(got, want)
    assert max(ratios.values()) <= 1, ratios


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(1, 4096, 32, 64, 1, 128, 64),
                                                 (1, 4096, 128, 64, 1, 16, 64),
                                                 (1, 999, 3, 6, 1, 10, 12)])
def test_ssd_bwd_kernel_gives_the_same_gradients_every_call(dev, b, s, h, p, g, n, chunk):
    """Two calls on the same inputs give bit-identical gradients: every sum
    across blocks is taken in a fixed order, with no atomics (mamba2-370m's
    training shape and jamba's mixer with h_init, both with TMA loads, and
    rows not 16-byte aligned, with 4-byte cp.async loads)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    x, dt, a, bm, cm, h0 = _ssd_case(b, s, h, p, g, n, dev, gen, h_init=h == 128)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev)
    dst = torch.randn((b, h, p, n), generator=gen, device=dev)
    first = tssdb.ssd_scan_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h0)
    second = tssdb.ssd_scan_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h0)
    for name, u, v in zip(ref.SSD_GRAD_NAMES, first, second):
        assert (u is None and v is None) or torch.equal(u, v), name


def test_ssd_bwd_kernel_reads_strided_views(dev):
    """x, B and C sliced out of one conv output [B,S,channels], as ssm_apply
    does, and a dy that is a slice too."""
    gen = torch.Generator(device=dev).manual_seed(8)
    b, s, h, p, g, n = 1, 256, 4, 32, 1, 64
    xbc = torch.randn((b, s, h * p + 2 * g * n), generator=gen, device=dev)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev) - 3)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    dy = torch.randn((b, s, h, 2 * p), generator=gen, device=dev)[..., :p]
    dst = torch.randn((b, h, p, n), generator=gen, device=dev)
    assert not x.is_contiguous() and not dy.is_contiguous()
    got = tssdb.ssd_scan_bwd(x, dt, a, bm, cm, 32, dy, dst)
    want = ref.ssd_chunked_bwd(*(t.contiguous() for t in (x, dt, a, bm, cm)), 32,
                               dy.contiguous(), dst)
    assert max(ref.ssd_grad_ratios(got, want).values()) <= 1


def test_ssd_bwd_kernel_refuses_unsupported_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(9)
    x, dt, a, bm, cm, _ = _ssd_case(1, 64, 4, 16, 1, 8, dev, gen)
    dy, dst = torch.zeros_like(x), torch.zeros((1, 4, 16, 8), device=dev)
    with pytest.raises(ValueError, match="chunk"):
        tssdb.ssd_scan_bwd(x, dt, a, bm, cm, 128, dy, dst)
    with pytest.raises(ValueError, match="chunk"):
        tssdb.ssd_scan_bwd(x, dt, a, bm, cm, 10, dy, dst)
    with pytest.raises(ValueError):
        tssdb.ssd_scan_bwd(x, dt, a, bm, cm, 16, dy.bfloat16(), dst)
    with pytest.raises(ValueError, match="shapes"):
        tssdb.ssd_scan_bwd(x, dt, a, bm, cm, 16, dy, dst[:, :3])
    with pytest.raises(ValueError, match="CUDA tensor"):
        tssdb.ssd_scan_bwd(x, dt, a, bm, cm, 16, dy.cpu(), dst)
    with pytest.raises(ValueError, match="contiguous"):
        tssdb.ssd_scan_bwd(x, dt, a, bm, cm, 16, dy.transpose(2, 3), dst)


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


def test_moe_apply_on_the_card_matches_the_cpu(dev):
    """The MoE FFN has no kernel of its own (the JAX package leaves it to
    XLA), but its ``topk``, stable ``argsort``, ``searchsorted`` and
    ``index_add`` run on the card: at capacity factor 0.5, so that choices
    drop, and B=3 groups, the routing, the bf16 buffers (one row a live
    slot: exact, though the card adds with atomics) and the f32 output
    (within 1e-5: products summed in another order) equal the CPU's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek_moe_16b", smoke=True).replace(dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    gen = torch.Generator().manual_seed(7)
    p = {k: v[0] if torch.is_tensor(v) else {kk: vv[0] for kk, vv in v.items()}
         for k, v in moe.moe_init(cfg, 1, torch.float32, gen, "cpu").items()}
    p_dev = {k: v.to(dev) if torch.is_tensor(v) else {kk: vv.to(dev) for kk, vv in v.items()}
             for k, v in p.items()}
    x = torch.randn((3, 40, cfg.d_model), generator=gen)
    logits = torch.einsum("gtd,de->gte", x, p["router"])
    gates, idx, _ = moe.router_topk(logits, cfg.moe)
    gates_d, idx_d, _ = moe.router_topk(logits.to(dev), cfg.moe)
    assert torch.equal(idx_d.cpu(), idx)
    pos = moe.choice_positions(idx, cfg.moe.n_experts)
    assert torch.equal(moe.choice_positions(idx_d, cfg.moe.n_experts).cpu(), pos)
    cap = moe.moe_capacity(cfg.moe, x.shape[1])
    fits = pos < cap
    assert not fits.all()
    xb = x.to(torch.bfloat16)
    buf = moe.scatter_dispatch(xb, idx, pos, fits, cfg.moe.n_experts, cap)
    buf_d = moe.scatter_dispatch(xb.to(dev), idx.to(dev), pos.to(dev), fits.to(dev),
                                 cfg.moe.n_experts, cap)
    assert torch.equal(buf_d.cpu(), buf)
    y, aux = moe.moe_apply(p, x, cfg)
    y_d, aux_d = moe.moe_apply(p_dev, x.to(dev), cfg)
    assert torch.allclose(y_d.cpu(), y, atol=1e-5, rtol=0)
    assert abs(aux_d.item() - aux.item()) < 1e-6
