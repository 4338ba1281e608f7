"""Plain PyTorch versions of the attention kernels (forward only).

Counterpart of ``repro.kernels.ref``.  ``mha`` is a blocked (flash)
attention that never materialises the [Sq, Sk] score matrix;
``decode_attention`` is the blocked flash-decode of one query token over a
cache.  The CPU path runs these, and the tests and ``chip_smoke.py`` hold
the CUDA kernels in ``flash_attention.py`` and ``decode_attention.py``
against them.

Conventions
  q        [B, Sq, H, dh]
  k, v     [B, Sk, KV, dh]        (GQA: H = KV * rep)
  window   sliding-window size (None = unlimited); causal masking optional
  q_offset absolute position of q[0] (decode/chunked prefill)
"""
from __future__ import annotations

from typing import Optional

import torch

# finite, so that a fully masked block gives exp(0) and never NaN
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# What a kernel is held to against these plain versions.  Both compute in
# f32 and round once to the output dtype, so in bf16 an element may differ by
# one bf16 ulp of its value (at most 2^-7 of it); ATOL covers the f32 sums'
# order.  f32 keeps the JAX package's kernel tolerance.
ATOL = 1e-5
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (ATOL + RTOL * |want|), with ``want`` the plain
    version's output: at most 1 where ``got`` agrees with it."""
    w = want.float()
    allowed = ATOL + RTOL[want.dtype] * w.abs()
    return ((got.float() - w).abs() / allowed).max().item()


def _pad_to(x: torch.Tensor, mult: int, dim: int):
    s = x.shape[dim]
    pad = (-s) % mult
    if pad == 0:
        return x, s
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim), s


def _block_mask(qi, ki, *, causal: bool, window: Optional[int]):
    """qi [bq] absolute q positions, ki [bk] absolute k positions -> bool."""
    m = torch.ones((qi.shape[0], ki.shape[0]), dtype=torch.bool, device=qi.device)
    if causal:
        m &= ki[None, :] <= qi[:, None]
    if window is not None:
        m &= ki[None, :] > qi[:, None] - window
    return m


def _mha_fwd_blocks(q5, k, v, *, causal, window, scale, q_offset,
                    block_q, block_k, kv_valid_len=None):
    """Core blocked forward.  Returns (out [B,Sq,KV,R,dh] f32, lse [B,KV,R,Sq])."""
    b, sq, kvh, rep, dh = q5.shape
    sk = k.shape[1]
    nq, nk = sq // block_q, sk // block_k
    f32 = torch.float32
    dev = q5.device
    out = torch.empty((b, kvh, rep, sq, dh), dtype=f32, device=dev)
    lse = torch.empty((b, kvh, rep, sq), dtype=f32, device=dev)
    for iq in range(nq):
        q0 = iq * block_q
        qblk = q5[:, q0:q0 + block_q].to(f32)
        qpos = q_offset + q0 + torch.arange(block_q, device=dev)
        m = torch.full((b, kvh, rep, block_q), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((b, kvh, rep, block_q), dtype=f32, device=dev)
        acc = torch.zeros((b, kvh, rep, block_q, dh), dtype=f32, device=dev)
        for ik in range(nk):
            k0 = ik * block_k
            kblk = k[:, k0:k0 + block_k].to(f32)
            vblk = v[:, k0:k0 + block_k].to(f32)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk, kblk) * scale
            kpos = k0 + torch.arange(block_k, device=dev)
            mask = _block_mask(qpos, kpos, causal=causal, window=window)
            if kv_valid_len is not None:
                mask &= (kpos < kv_valid_len)[None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, vblk)
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[:, :, :, q0:q0 + block_q] = acc / l[..., None]
        lse[:, :, :, q0:q0 + block_q] = m + torch.log(l)
    return out.permute(0, 3, 1, 2, 4), lse


def mha(q, k, v, *, causal: bool = True, window: Optional[int] = None,
        scale: Optional[float] = None, q_offset: int = 0,
        block_q: int = 512, block_k: int = 512, kv_valid_len=None):
    """Blocked flash attention.  q [B,Sq,H,dh], k/v [B,Sk,KV,dh] -> [B,Sq,H,dh].

    Never materialises [Sq,Sk].  ``kv_valid_len`` masks trailing cache slots.
    """
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"n_heads {h} is not a multiple of n_kv_heads {kvh}")
    rep = h // kvh
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    block_q = min(block_q, max(sq, 1))
    block_k = min(block_k, max(k.shape[1], 1))

    q5 = q.reshape(b, sq, kvh, rep, dh)
    q5, sq0 = _pad_to(q5, block_q, 1)
    k, sk0 = _pad_to(k, block_k, 1)
    v, _ = _pad_to(v, block_k, 1)
    if k.shape[1] != sk0 and kv_valid_len is None:  # padded KV slots are masked
        kv_valid_len = sk0
    out, _ = _mha_fwd_blocks(q5, k, v, causal=causal, window=window, scale=scale,
                             q_offset=q_offset, block_q=block_q, block_k=block_k,
                             kv_valid_len=kv_valid_len)
    return out[:, :sq0].reshape(b, sq0, h, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_mask, *,
                     scale: Optional[float] = None,
                     block_k: int = 1024, return_stats: bool = False):
    """q [B,1,H,dh]; k/v_cache [B,C,KV,dh]; valid_mask [B,C] bool.

    Blocked flash-decode over the cache dimension.  With
    ``return_stats=True`` returns (acc [B,KV,R,dh], m [B,KV,R], l [B,KV,R])
    *unnormalised* partials, mergeable across cache shards (flash-decoding's
    split-K combine).
    """
    b, _, h, dh = q.shape
    c = k_cache.shape[1]
    kvh = k_cache.shape[2]
    rep = h // kvh
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    block_k = min(block_k, c)
    k_cache, _ = _pad_to(k_cache, block_k, 1)
    v_cache, _ = _pad_to(v_cache, block_k, 1)
    vm, _ = _pad_to(valid_mask.to(torch.bool), block_k, 1)
    nk = k_cache.shape[1] // block_k
    f32 = torch.float32
    dev = q.device
    qr = q.reshape(b, kvh, rep, dh).to(f32)
    m = torch.full((b, kvh, rep), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((b, kvh, rep), dtype=f32, device=dev)
    acc = torch.zeros((b, kvh, rep, dh), dtype=f32, device=dev)
    for ik in range(nk):
        sl = slice(ik * block_k, (ik + 1) * block_k)
        s = torch.einsum("bgrd,bkgd->bgrk", qr, k_cache[:, sl].to(f32)) * scale
        s = torch.where(vm[:, None, None, sl], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrk,bkgd->bgrd", p,
                                                    v_cache[:, sl].to(f32))
        m = m_new
    if return_stats:
        return acc, m, l
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, dh).to(q.dtype)
