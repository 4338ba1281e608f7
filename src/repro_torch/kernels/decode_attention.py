"""Flash-decode on Hopper: wrapper of ``csrc/decode_attention.cu``.

Counterpart of ``repro.kernels.decode_attention`` (the Pallas TPU kernel
``_decode_kernel``).  The kernel splits the cache over thread blocks
(split-K) and merges the partials in a second pass; the wrapper allocates
the output and the f32 partials.  It takes a ragged cache length itself,
so there is no fallback.  ``ops.decode_attention`` sends CPU tensors to
``ref.decode_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_tensor
from repro_torch.kernels.flash_attention import DTYPES, check_head_dim, check_rows

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
KERNEL = CudaKernel("decode_attention", {
    "repro_decode_attention_fwd": [_P] * 8 + [_I] * 6 + [_L] * 12 + [_F, _I, _P],
    "repro_decode_num_splits": [_I],
    "repro_decode_split": [],
    "repro_decode_max_rep": [],
    "repro_decode_attention_smem_bytes": [_I, _I],
})


def decode_attention(q, k_cache, v_cache, valid_mask, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """CUDA kernel.  q [B,1,H,dh]; caches [B,C,KV,dh]; valid [B,C] bool -> [B,1,H,dh]."""
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
    check_head_dim(dh, q.dtype)
    if valid_mask.dtype not in (torch.bool, torch.uint8) or valid_mask.shape != (b, c):
        raise ValueError(f"valid_mask must be bool/uint8 [{b},{c}], got "
                         f"{valid_mask.dtype} {tuple(valid_mask.shape)}")
    if valid_mask.device != q.device or k_cache.device != q.device \
            or v_cache.device != q.device:
        raise ValueError("all inputs must be on one device")
    mask = valid_mask.view(torch.uint8)
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    lib = KERNEL.lib()
    rep = h // kvh
    if rep > lib.repro_decode_max_rep():
        raise ValueError(f"{rep} query heads per kv head; the kernel takes at most "
                         f"{lib.repro_decode_max_rep()}")
    nsplit = lib.repro_decode_num_splits(c)
    f32 = torch.float32
    acc_p = torch.empty((b, kvh, nsplit, rep, dh), dtype=f32, device=q.device)
    m_p = torch.empty((b, kvh, nsplit, rep), dtype=f32, device=q.device)
    l_p = torch.empty((b, kvh, nsplit, rep), dtype=f32, device=q.device)
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(),
        out.data_ptr(), acc_p.data_ptr(), m_p.data_ptr(), l_p.data_ptr(),
        DTYPES[q.dtype], b, c, h, kvh, dh,
        q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        *mask.stride(), out.stride(0), out.stride(2),
        scale, q.device.index or 0, stream)
    KERNEL.check(err)
    KERNEL.launches += 1
    return out
