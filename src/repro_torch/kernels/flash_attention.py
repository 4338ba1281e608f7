"""Flash-attention forward on Hopper: wrapper of ``csrc/flash_attention.cu``.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_fa_kernel``).  The wrapper checks its inputs, allocates the output and
launches the kernel on the current stream; it never runs the plain version
(``ops.mha`` sends CPU tensors to ``ref.mha``).  Unlike the TPU kernel it
takes a ragged sequence length itself, so there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_tensor

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
KERNEL = CudaKernel("flash_attention", {
    "repro_flash_attention_fwd": [_P] * 4 + [_I] * 7 + [_L] * 12 + [_F, _I, _I, _I, _I, _P],
    "repro_flash_attention_smem_bytes": [_I, _I],
    "repro_flash_attention_kv_tile": [_I],
    "repro_flash_attention_q_tile": [_I],
})
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_head_dim(dh: int, dtype: torch.dtype) -> None:
    """Head dims the kernels take: up to 128, whole 16-byte chunks of a row
    (multiples of 8 in bf16, of 4 in f32: 64, 120, 128, ...)."""
    per16 = 16 // dtype.itemsize
    if dh <= 0 or dh > 128 or dh % per16:
        raise ValueError(f"head dim {dh} is not supported by the CUDA kernels in {dtype} "
                         f"(a multiple of {per16}, at most 128)")


def check_rows(name: str, t: torch.Tensor) -> None:
    """The kernels copy rows in 16-byte chunks: every row must start on a
    16-byte boundary."""
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:-1] if s):
        raise ValueError(f"{name}: rows must start on 16-byte boundaries "
                         f"(strides {t.stride()}, pointer {t.data_ptr():#x})")


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """CUDA kernel.  q [B,Sq,H,dh], k/v [B,Sk,KV,dh] -> [B,Sq,H,dh] in q's dtype."""
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes {list(DTYPES)}, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(name, t, q.dtype)
        check_rows(name, t)
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B,S,heads,dh], got {tuple(t.shape)}")
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    check_head_dim(dh, q.dtype)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = KERNEL.lib().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), DTYPES[q.dtype],
        b, sq, sk, h, kvh, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        scale, int(causal), int(window or 0), int(q_offset), q.device.index or 0, stream)
    KERNEL.check(err)
    KERNEL.launches += 1
    return o
