"""Flash-decode's gradient on Hopper: wrapper of ``csrc/decode_attention_bwd.cu``.

Counterpart of ``_decode_vjp_bwd`` in ``repro.kernels.decode_attention``,
which on the TPU recomputes the gradient in XLA through
``ref.decode_attention``'s VJP: it is not a Pallas kernel, but the port's
plain version may not run on the card's main path, so it is a CUDA kernel
here.  The wrapper checks its inputs as the forward's does, allocates the
gradients and the f32 scratch (each split's (m, l, t) and dq partial) and
launches the three passes on the current stream, counted as one launch;
it never runs the plain version (``ops`` sends CPU tensors to
``ref.decode_attention_bwd``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_tensor
from repro_torch.kernels.decode_attention import _checked
from repro_torch.kernels.flash_attention import DTYPES, check_rows

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("decode_attention_bwd", {
    "repro_decode_attention_bwd": [_P] * 12 + [_I] * 6 + [_P, _F, _I, _P],
    "repro_decode_bwd_num_splits": [_I],
    "repro_decode_bwd_split": [],
    "repro_decode_bwd_max_rep": [],
})


def decode_attention_bwd(q, k_cache, v_cache, valid_mask, do, *,
                         scale: Optional[float] = None):
    """CUDA kernels.  q, do [B,1,H,dh]; caches [B,C,KV,dh]; valid [B,C] bool
    -> (dq [B,1,H,dh], dk_cache, dv_cache [B,C,KV,dh]) in q's dtype."""
    mask, rep, _ = _checked(q, k_cache, v_cache, valid_mask)
    check_cuda_tensor("do", do, q.dtype)
    check_rows("do", do)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    lib = KERNEL.lib()
    if rep > lib.repro_decode_bwd_max_rep():
        raise ValueError(f"{rep} query heads per kv head; the kernel takes at most "
                         f"{lib.repro_decode_bwd_max_rep()}")
    b, _, h, dh = q.shape
    c, kvh = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    nsplit = lib.repro_decode_bwd_num_splits(c)
    f32, dev = torch.float32, q.device
    m_p, l_p, t_p = (torch.empty((b, kvh, nsplit, rep), dtype=f32, device=dev)
                     for _ in range(3))
    dq_p = torch.empty((b, kvh, nsplit, rep, dh), dtype=f32, device=dev)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty(k_cache.shape, dtype=q.dtype, device=dev)
    dv = torch.empty(v_cache.shape, dtype=q.dtype, device=dev)
    strides = (q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
               *mask.stride(), do.stride(0), do.stride(2), dq.stride(0), dq.stride(2),
               *dk.stride()[:3], *dv.stride()[:3])
    st = (ctypes.c_int64 * len(strides))(*strides)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_decode_attention_bwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), m_p.data_ptr(), l_p.data_ptr(),
        t_p.data_ptr(), dq_p.data_ptr(), DTYPES[q.dtype], b, c, h, kvh, dh,
        ctypes.cast(st, ctypes.c_void_p), scale, dev.index or 0, stream)
    KERNEL.check(err)
    KERNEL.launches += 1
    return dq, dk, dv
