"""Dispatch of the kernels (attention, SSD scan) on the tensor's device.

A CPU tensor goes to the plain version in ``ref``; a CUDA tensor launches
the hand-written kernel or raises.  There is no switch and no fallback: a
CUDA tensor never reaches the plain version through these functions.  A
tensor on the "meta" device (shapes only, nothing computed) takes the plain
version too, so that ``analysis.cost`` counts the same work whichever
implementation runs on the card; any other device raises.

Where an input of ``mha`` needs a gradient, ``mha`` is an autograd function:
its forward (``mha_fwd``) also keeps the rows' log-sum-exp, and its backward
(``mha_bwd``) launches the backward kernel, or runs ``ref.mha_bwd`` on CPU
tensors.  Without a gradient it takes the serving route, which writes no
log-sum-exp.  ``ssd`` and ``decode_attention`` likewise, each with a
backward that recomputes from the inputs: ``ssd_bwd`` (the SSD backward
kernel, or ``ref.ssd_chunked_bwd`` on CPU tensors) and
``decode_attention_bwd`` (the decode backward kernel, or
``ref.decode_attention_bwd``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import decode_attention_bwd as _dab
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_scan_bwd as _ssdb

# the libraries, one a source, each built once
KERNELS = {"flash_attention": _fa.KERNEL, "flash_attention_bwd": _fab.KERNEL,
           "decode_attention": _da.KERNEL, "decode_attention_bwd": _dab.KERNEL,
           "ssd_scan": _ssd.KERNEL, "ssd_scan_bwd": _ssdb.KERNEL}
# what is counted: every library's kernel and flash-decode's stats variant
COUNTED = {**KERNELS, "decode_attention_stats": _da.STATS}


def _route(t) -> str:
    if t.device.type in ("cpu", "cuda", "meta"):
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


def decode_attention(q, k_cache, v_cache, valid_mask, *, scale: Optional[float] = None,
                     return_stats: bool = False):
    """Flash-decode.  q [B,1,H,dh], caches [B,C,KV,dh], valid [B,C] -> [B,1,H,dh].

    ``return_stats=True`` returns the unnormalised (acc [B,KV,R,dh], m
    [B,KV,R], l [B,KV,R]) in f32 instead, mergeable over the shards of a
    cache (on the card: the kernel's stats variant).  Where q or a cache
    needs a gradient the output is an autograd function over the forward and
    ``decode_attention_bwd``; the stats variant has no gradient on the card
    (no path differentiates it), so a CUDA input that needs one is refused.
    """
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_cache, v_cache))
    if return_stats:
        if _route(q) == "cuda":
            if grad:
                raise NotImplementedError("the flash-decode stats variant has no backward: a "
                                          "CUDA input that needs a gradient is refused")
            return _da.decode_attention_stats(q, k_cache, v_cache, valid_mask, scale=scale)
        return ref.decode_attention(q, k_cache, v_cache, valid_mask, scale=scale,
                                    return_stats=True)
    if grad:
        return _DecodeAttention.apply(q, k_cache, v_cache, valid_mask, scale)
    return decode_attention_fwd(q, k_cache, v_cache, valid_mask, scale=scale)


def decode_attention_fwd(q, k_cache, v_cache, valid_mask, *, scale: Optional[float] = None):
    """Flash-decode's output: the kernel, or the plain version off the card."""
    if _route(q) == "cuda":
        return _da.decode_attention(q, k_cache, v_cache, valid_mask, scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, valid_mask, scale=scale)


def decode_attention_bwd(q, k_cache, v_cache, valid_mask, do, *,
                         scale: Optional[float] = None):
    """Gradients (dq, dk_cache, dv_cache) of flash-decode for the output's
    cotangent ``do``."""
    if _route(q) == "cuda":
        return _dab.decode_attention_bwd(q, k_cache, v_cache, valid_mask, do, scale=scale)
    return ref.decode_attention_bwd(q, k_cache, v_cache, valid_mask, do, scale=scale)


class _DecodeAttention(torch.autograd.Function):
    """``decode_attention`` with a gradient: forward and backward through
    ``decode_attention_fwd`` and ``decode_attention_bwd``, looked up when
    called.  It saves the inputs only, as the JAX package's custom VJP does,
    and the backward recomputes from them; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k_cache, v_cache, valid_mask, scale):
        ctx.save_for_backward(q, k_cache, v_cache, valid_mask)
        ctx.scale = scale
        return decode_attention_fwd(q, k_cache, v_cache, valid_mask, scale=scale)

    @staticmethod
    def backward(ctx, do):
        q, k_cache, v_cache, valid_mask = ctx.saved_tensors
        dq, dk, dv = decode_attention_bwd(q, k_cache, v_cache, valid_mask, do.contiguous(),
                                          scale=ctx.scale)
        return dq, dk, dv, None, None


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
    return {name: k.launches for name, k in COUNTED.items()}


def reset_launch_counts() -> None:
    for k in COUNTED.values():
        k.launches = 0
