"""Dispatch of the kernels (attention, SSD scan) on the tensor's device.

A CPU tensor goes to the plain version in ``ref``; a CUDA tensor launches
the hand-written kernel or raises.  There is no switch and no fallback: a
CUDA tensor never reaches the plain version through these functions.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd

KERNELS = {"flash_attention": _fa.KERNEL, "decode_attention": _da.KERNEL,
           "ssd_scan": _ssd.KERNEL}


def _route(t) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel for device {t.device}")


def mha(q, k, v, *, causal: bool = True, window: Optional[int] = None,
        scale: Optional[float] = None, q_offset: int = 0):
    """Flash attention.  q [B,Sq,H,dh], k/v [B,Sk,KV,dh] -> [B,Sq,H,dh]."""
    if _route(q) == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                   q_offset=q_offset)
    return ref.mha(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, valid_mask, *, scale: Optional[float] = None):
    """Flash-decode.  q [B,1,H,dh], caches [B,C,KV,dh], valid [B,C]."""
    if _route(q) == "cuda":
        return _da.decode_attention(q, k_cache, v_cache, valid_mask, scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, valid_mask, scale=scale)


def ssd(x, dt, a, b_mat, c_mat, chunk: int, h_init=None):
    """Mamba-2 SSD chunked scan (see ``ref.ssd_chunked`` for shapes).

    Returns (y [B,S,H,P], final state [B,H,P,N]), f32.
    """
    if _route(x) == "cuda":
        return _ssd.ssd_scan(x, dt, a, b_mat, c_mat, chunk, h_init=h_init)
    return ref.ssd_chunked(x, dt, a, b_mat, c_mat, chunk, h_init=h_init)


def launch_counts() -> dict:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
