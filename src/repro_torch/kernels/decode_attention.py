"""Flash-decode on Hopper: wrapper of ``csrc/decode_attention.cu``.

Counterpart of ``repro.kernels.decode_attention`` (the Pallas TPU kernel
``_decode_kernel``).  The kernel splits the cache over thread blocks
(split-K), as many splits as the shape needs to fill the card
(``repro_decode_num_splits``), and merges the partials in a second pass;
the wrapper allocates the output and the f32 partials.  It takes a ragged
cache length itself, so there is no fallback.  ``ops.decode_attention`` sends CPU tensors to
``ref.decode_attention``.

With ``residuals=True`` (the autograd forward, ``ops``) the same launch
also returns each head's log-sum-exp and its output in f32 before the
rounding, which the decode backward kernel takes; the rounded output is
the same.

``decode_attention_stats`` is the variant that context-parallel decode
runs on each shard of a cache: the same first pass, then a second that
writes the merged unnormalised ``(acc, m, l)`` in f32 (the plain version's
``return_stats=True``).  It is an entry point of the same library with a
launch count of its own (``STATS``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel, KernelEntry, check_cuda_tensor
from repro_torch.kernels.flash_attention import DTYPES, check_head_dim, check_rows

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
KERNEL = CudaKernel("decode_attention", {
    "repro_decode_attention_fwd": [_P] * 10 + [_I] * 6 + [_L] * 12 + [_F, _I, _P],
    "repro_decode_attention_stats": [_P] * 10 + [_I] * 6 + [_L] * 10 + [_F, _I, _P],
    "repro_decode_num_splits": [_I] * 6,
    "repro_decode_split": [_I] * 6,
    "repro_decode_max_rep": [],
    "repro_decode_plan": [_I] * 4,
})
STATS = KernelEntry("decode_attention_stats", KERNEL)
# the widest head dim this kernel is instantiated for (tiles 64, 128, 256 wide)
MAX_HEAD_DIM = 256


def _checked(q, k_cache, v_cache, valid_mask):
    """The checks of both entry points: (uint8 mask, rep, splits)."""
    if q.dtype not in DTYPES:
        raise ValueError(f"decode_attention takes {list(DTYPES)}, got {q.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        check_cuda_tensor(name, t, q.dtype)
        check_rows(name, t)
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    b, one, h, dh = q.shape
    _, c, kvh, _ = k_cache.shape
    if (one != 1 or k_cache.shape != v_cache.shape or k_cache.shape[0] != b
            or k_cache.shape[3] != dh or h % kvh):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)}")
    check_head_dim(dh, q.dtype, MAX_HEAD_DIM)
    if valid_mask.dtype not in (torch.bool, torch.uint8) or valid_mask.shape != (b, c):
        raise ValueError(f"valid_mask must be bool/uint8 [{b},{c}], got "
                         f"{valid_mask.dtype} {tuple(valid_mask.shape)}")
    if valid_mask.device != q.device or k_cache.device != q.device \
            or v_cache.device != q.device:
        raise ValueError("all inputs must be on one device")
    lib = KERNEL.lib()
    rep = h // kvh
    if rep > lib.repro_decode_max_rep():
        raise ValueError(f"{rep} query heads per kv head; the kernel takes at most "
                         f"{lib.repro_decode_max_rep()}")
    nsplit = lib.repro_decode_num_splits(DTYPES[q.dtype], b, c, h, kvh, dh)
    return valid_mask.view(torch.uint8), rep, nsplit


def _partials(q, kvh, nsplit, rep):
    """f32 scratch of pass 1: acc_p [B,KV,nsplit,rep,dh], m_p and l_p."""
    b, dh, f32 = q.shape[0], q.shape[3], torch.float32
    return (torch.empty((b, kvh, nsplit, rep, dh), dtype=f32, device=q.device),
            torch.empty((b, kvh, nsplit, rep), dtype=f32, device=q.device),
            torch.empty((b, kvh, nsplit, rep), dtype=f32, device=q.device))


def decode_attention(q, k_cache, v_cache, valid_mask, *, scale: Optional[float] = None,
                     residuals: bool = False):
    """CUDA kernel.  q [B,1,H,dh]; caches [B,C,KV,dh]; valid [B,C] bool -> [B,1,H,dh];
    with ``residuals`` (out, lse [B,H], o_f32 [B,1,H,dh]), the last two f32."""
    mask, rep, nsplit = _checked(q, k_cache, v_cache, valid_mask)
    b, _, h, dh = q.shape
    c, kvh = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    acc_p, m_p, l_p = _partials(q, kvh, nsplit, rep)
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=q.device)
    lse = o32 = None
    if residuals:
        lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
        o32 = torch.empty((b, 1, h, dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = KERNEL.lib().repro_decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr() if residuals else None,
        o32.data_ptr() if residuals else None, acc_p.data_ptr(), m_p.data_ptr(),
        l_p.data_ptr(),
        DTYPES[q.dtype], b, c, h, kvh, dh,
        q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        *mask.stride(), out.stride(0), out.stride(2),
        scale, q.device.index or 0, stream)
    KERNEL.check(err)
    KERNEL.launches += 1
    return (out, lse, o32) if residuals else out


def decode_attention_stats(q, k_cache, v_cache, valid_mask, *,
                           scale: Optional[float] = None):
    """CUDA kernel, stats variant.  The inputs of ``decode_attention`` ->
    (acc [B,KV,R,dh], m [B,KV,R], l [B,KV,R]) f32, unnormalised, R = H / KV."""
    mask, rep, nsplit = _checked(q, k_cache, v_cache, valid_mask)
    b, _, h, dh = q.shape
    c, kvh = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    acc_p, m_p, l_p = _partials(q, kvh, nsplit, rep)
    f32 = torch.float32
    acc = torch.empty((b, kvh, rep, dh), dtype=f32, device=q.device)
    m = torch.empty((b, kvh, rep), dtype=f32, device=q.device)
    l = torch.empty((b, kvh, rep), dtype=f32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = KERNEL.lib().repro_decode_attention_stats(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), acc_p.data_ptr(), m_p.data_ptr(),
        l_p.data_ptr(), DTYPES[q.dtype], b, c, h, kvh, dh,
        q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        *mask.stride(), scale, q.device.index or 0, stream)
    KERNEL.check(err)
    STATS.launches += 1
    return acc, m, l
