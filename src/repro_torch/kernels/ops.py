"""Dispatch of the kernels (attention, SSD scan) on the tensor's device.

A CPU tensor goes to the plain version in ``ref``; a CUDA tensor launches
the hand-written kernel or raises.  There is no switch and no fallback: a
CUDA tensor never reaches the plain version through these functions.

Where an input of ``mha`` needs a gradient, ``mha`` is an autograd function:
its forward (``mha_fwd``) also keeps the rows' log-sum-exp, and its backward
(``mha_bwd``) launches the backward kernel, or runs ``ref.mha_bwd`` on CPU
tensors.  Without a gradient it takes the serving route, which writes no
log-sum-exp.  ``ssd`` likewise: with a gradient its forward is ``ssd_fwd``
and its backward ``ssd_bwd`` (the SSD backward kernel, or
``ref.ssd_chunked_bwd`` on CPU tensors), which recomputes from the inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_scan_bwd as _ssdb

KERNELS = {"flash_attention": _fa.KERNEL, "flash_attention_bwd": _fab.KERNEL,
           "decode_attention": _da.KERNEL, "ssd_scan": _ssd.KERNEL,
           "ssd_scan_bwd": _ssdb.KERNEL}


def _route(t) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel for device {t.device}")


def mha(q, k, v, *, causal: bool = True, window: Optional[int] = None,
        scale: Optional[float] = None, q_offset: int = 0):
    """Flash attention.  q [B,Sq,H,dh], k/v [B,Sk,KV,dh] -> [B,Sq,H,dh]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale, q_offset)
    if _route(q) == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                   q_offset=q_offset)
    return ref.mha(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset)


def mha_fwd(q, k, v, *, causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None, q_offset: int = 0):
    """Flash attention keeping the rows' log-sum-exp: (o [B,Sq,H,dh], lse
    [B,H,Sq] f32)."""
    if _route(q) == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                   q_offset=q_offset, return_lse=True)
    return ref.mha_fwd_lse(q, k, v, causal=causal, window=window, scale=scale,
                           q_offset=q_offset)


def mha_bwd(q, k, v, o, lse, do, *, causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None, q_offset: int = 0):
    """Gradients (dq, dk, dv) of flash attention from ``mha_fwd``'s o and lse."""
    if _route(q) == "cuda":
        return _fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                        scale=scale, q_offset=q_offset)
    return ref.mha_bwd(q, k, v, o, lse, do, causal=causal, window=window, scale=scale,
                       q_offset=q_offset)


class _FlashAttention(torch.autograd.Function):
    """``mha`` with a gradient: forward and backward through ``mha_fwd`` and
    ``mha_bwd``, looked up when called."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        o, lse = mha_fwd(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = mha_bwd(q, k, v, o, lse, do.contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None, None


def decode_attention(q, k_cache, v_cache, valid_mask, *, scale: Optional[float] = None):
    """Flash-decode.  q [B,1,H,dh], caches [B,C,KV,dh], valid [B,C].

    On the card it has no gradient: no path of the port differentiates
    decode, so a CUDA input that needs one is refused rather than given none.
    """
    if _route(q) == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_cache, v_cache)):
            raise NotImplementedError("flash-decode has no backward kernel: a CUDA input that "
                                      "needs a gradient is refused (ROADMAP.md, Queue 2 item "
                                      "D: decode backward)")
        return _da.decode_attention(q, k_cache, v_cache, valid_mask, scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, valid_mask, scale=scale)


def ssd(x, dt, a, b_mat, c_mat, chunk: int, h_init=None):
    """Mamba-2 SSD chunked scan (see ``ref.ssd_chunked`` for shapes).

    Returns (y [B,S,H,P], final state [B,H,P,N]), f32.  Where an input needs
    a gradient it is an autograd function over ``ssd_fwd`` and ``ssd_bwd``;
    h_init, when given, gets its gradient too.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, a, b_mat, c_mat, h_init)):
        return _SSDScan.apply(x, dt, a, b_mat, c_mat, chunk, h_init)
    return ssd_fwd(x, dt, a, b_mat, c_mat, chunk, h_init=h_init)


def ssd_fwd(x, dt, a, b_mat, c_mat, chunk: int, h_init=None):
    """The SSD scan's forward: (y, final state)."""
    if _route(x) == "cuda":
        return _ssd.ssd_scan(x, dt, a, b_mat, c_mat, chunk, h_init=h_init)
    return ref.ssd_chunked(x, dt, a, b_mat, c_mat, chunk, h_init=h_init)


def ssd_bwd(x, dt, a, b_mat, c_mat, chunk: int, dy, dstate, h_init=None):
    """Gradients (dx, ddt, da, db, dc, dh_init) of the SSD scan from the
    cotangents of y and the final state; dh_init is None where h_init is."""
    if _route(x) == "cuda":
        return _ssdb.ssd_scan_bwd(x, dt, a, b_mat, c_mat, chunk, dy, dstate, h_init=h_init)
    return ref.ssd_chunked_bwd(x, dt, a, b_mat, c_mat, chunk, dy, dstate, h_init=h_init)


class _SSDScan(torch.autograd.Function):
    """``ssd`` with a gradient: forward and backward through ``ssd_fwd`` and
    ``ssd_bwd``, looked up when called.  It saves the inputs only, as the
    JAX package's custom VJP does, and the backward recomputes from them."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, chunk, h_init):
        y, st = ssd_fwd(x, dt, a, b_mat, c_mat, chunk, h_init=h_init)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, h_init)
        ctx.chunk = chunk
        return y, st

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b_mat, c_mat, h_init = ctx.saved_tensors
        dx, ddt, da, db, dc, dh0 = ssd_bwd(x, dt, a, b_mat, c_mat, ctx.chunk, dy.contiguous(),
                                           dstate.contiguous(), h_init=h_init)
        return dx, ddt, da, db, dc, None, dh0


def launch_counts() -> dict:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
