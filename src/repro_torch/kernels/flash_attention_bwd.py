"""Flash-attention backward on Hopper: wrapper of ``csrc/flash_attention_bwd.cu``.

Counterpart of ``_flash_vjp_bwd`` in ``repro.kernels.flash_attention``,
which on the TPU recomputes the gradient in XLA (``ref._mha_bwd_blocks``):
it is not a Pallas kernel, but the port's plain version may not run on the
card's main path, so it is a CUDA kernel here.  The wrapper checks its
inputs, allocates the gradients, the ``delta`` scratch and, where the bf16
dk/dv pass splits each group's query heads across blocks, their f32
partials of dk and dv, and launches the kernels on the current stream; it
never runs the plain version (``ops.mha_bwd`` sends CPU tensors to
``ref.mha_bwd``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_tensor
from repro_torch.kernels.flash_attention import DTYPES, check_head_dim, check_rows

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("flash_attention_bwd", {
    "repro_flash_attention_bwd": [_P] * 11 + [_I] * 8 + [_P, _F, _I, _I, _I, _I, _P],
    "repro_flash_attention_bwd_smem_bytes": [_I, _I],
    "repro_flash_attention_bwd_tile": [_I],
    "repro_flash_attention_bwd_col_parts": [_I],
    "repro_flash_attention_bwd_head_parts": [_I, _I, _I, _I],
    "repro_flash_attention_bwd_regs": [_I, _I, _I],
    "repro_flash_attention_bwd_dq_tile": [_I, _I],
})
# the widest head dim these kernels are instantiated for (tiles 64, 128, 256 wide)
MAX_HEAD_DIM = 256


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None, scale: Optional[float] = None,
                        q_offset: int = 0):
    """CUDA kernels.  q, o, do [B,Sq,H,dh], k/v [B,Sk,KV,dh], lse [B,H,Sq] f32
    (the forward's) -> (dq [B,Sq,H,dh], dk, dv [B,Sk,KV,dh]) in q's dtype."""
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention_bwd takes {list(DTYPES)}, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        check_cuda_tensor(name, t, q.dtype)
        check_rows(name, t)
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B,S,heads,dh], got {tuple(t.shape)}")
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh or h % kvh
            or o.shape != q.shape or do.shape != q.shape):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"o {tuple(o.shape)} do {tuple(do.shape)}")
    check_cuda_tensor("lse", lse, torch.float32)
    # the bf16 kernels read lse by TMA, from a 16-byte boundary
    if lse.shape != (b, h, sq) or not lse.is_contiguous() or lse.data_ptr() % 16:
        raise ValueError(f"lse must be a contiguous [B,H,Sq] = {(b, h, sq)} starting on a "
                         f"16-byte boundary, got {tuple(lse.shape)} strides {lse.stride()} "
                         f"pointer {lse.data_ptr():#x}")
    if len({t.device for t in (q, k, v, o, do, lse)}) != 1:
        raise ValueError("q, k, v, o, do and lse must be on one device")
    check_head_dim(dh, q.dtype, MAX_HEAD_DIM)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, sk, kvh, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = KERNEL.lib()
    # bf16: the dk/dv pass splits each group's query heads across blocks, whose
    # f32 partials of dk and dv a last pass sums in order
    parts = lib.repro_flash_attention_bwd_head_parts(b, sk, kvh, h // kvh) if (
        q.dtype == torch.bfloat16) else 1
    scratch = (torch.empty((2 * parts * b * sk * kvh * dh,), dtype=torch.float32,
                           device=q.device) if parts > 1 else None)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, do, dk, dv, dq, o)
                                       for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, parts, DTYPES[q.dtype],
        b, sq, sk, h, kvh, dh, ctypes.cast(strides, ctypes.c_void_p), scale, int(causal),
        int(window or 0), int(q_offset), q.device.index or 0, stream)
    KERNEL.check(err)
    KERNEL.launches += 1
    return dq, dk, dv
