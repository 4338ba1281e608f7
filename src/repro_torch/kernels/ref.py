"""Plain PyTorch versions of the kernels.

Counterpart of ``repro.kernels.ref`` and of ``repro.models.ssm.ssd_chunked``.
``mha`` is a blocked (flash) attention that never materialises the
[Sq, Sk] score matrix; ``mha_fwd_lse`` also returns the rows' log-sum-exp,
and ``mha_bwd`` is the blocked backward that recomputes P from it (the JAX
package's ``_mha_bwd_blocks``); ``decode_attention`` is the blocked flash-decode of
one query token over a cache and ``decode_attention_bwd`` its gradient;
``ssd_chunked`` is the Mamba-2 SSD chunked scan and ``ssd_chunked_bwd`` its
gradient.  The CPU path runs these, and the tests and ``chip_smoke.py`` hold
the CUDA kernels in ``flash_attention.py``, ``flash_attention_bwd.py``,
``decode_attention.py``, ``decode_attention_bwd.py``, ``ssd_scan.py`` and
``ssd_scan_bwd.py`` against them.

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


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor, atol_scale: float = 1.0) -> float:
    """max |got - want| / (ATOL * atol_scale + RTOL * |want|), with ``want``
    the plain version's output: at most 1 where ``got`` agrees with it.

    ``atol_scale`` scales the absolute term with the inputs' size: attention
    inside a model passes max(1, max |v|).  The bf16 flash kernel carries P
    to 16 bits (a bf16 high and low part), so an output near 0, a cancelling
    sum of P |v|, is off by up to ~2^-17 max |v| (2.6e-5 where |v| reaches
    5.8 after a few training steps of h2o-danube-3-4b on an H100).
    """
    w = want.float()
    allowed = ATOL * atol_scale + RTOL[want.dtype] * w.abs()
    return ((got.float() - w).abs() / allowed).max().item()


# Inside a model the loss is a mean over thousands of tokens, so attention's
# gradients are 1e-8..1e-4, below any absolute term set for the kernels'
# test inputs: there the backward is held per (batch, head) by the RMS of
# the difference over the RMS of the plain version's gradient, which does
# not depend on their size.  Both versions round once to bf16 (2^-9 of a
# value on average); the bound is one bf16 ulp, 2^-7.  Zeroing one 64-row
# tile of a head's 4096 rows reads sqrt(64 / 4096) = 0.125.
HEAD_RMS_LIMIT = 2.0 ** -7


def head_rel_rms(got: torch.Tensor, want: torch.Tensor, head_dim: int = 2) -> float:
    """The worst (batch, head)'s RMS of (got - want) over the RMS of want;
    ``head_dim`` is 2 for [B,S,H,dh]."""
    w = want.float().movedim(head_dim, 1).flatten(2)
    d = got.float().movedim(head_dim, 1).flatten(2) - w
    return (d.pow(2).mean(-1).sqrt() / w.pow(2).mean(-1).sqrt().clamp(min=1e-30)).max().item()


# What the backward kernel's dq, dk and dv are held to.  bf16: one bf16 ulp
# of each element, as the forward.  f32: 1e-4, the JAX package's tolerance
# for attention gradients (tests/test_kernels.py); a gradient is a sum over
# up to S rows (dv = P^T dO), so the two versions' orders of summation part
# by more than the forward's 1e-5 (1.05e-5 on dv at S=1000 on an H100).
GRAD_ATOL = {torch.float32: 1e-4, torch.bfloat16: ATOL}


def grad_tolerance_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (GRAD_ATOL + RTOL * |want|), with ``want`` the
    plain backward's gradient: at most 1 where ``got`` agrees with it."""
    w = want.float()
    allowed = GRAD_ATOL[want.dtype] + RTOL[want.dtype] * w.abs()
    return ((got.float() - w).abs() / allowed).max().item()


# The forward's log-sum-exp is f32 in both versions; the kernel takes its
# exponentials with other instructions and sums in another order, a few f32
# ulps of the row sum.  Held to 1e-5 of max(1, |lse|): relative where |lse|
# >= 1, absolute near 0 (a row that sees one key has lse = its one score).
LSE_RTOL = 1e-5


def lse_tolerance_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (LSE_RTOL * max(1, |want|)): at most 1 where the
    kernel's log-sum-exp agrees with ``mha_fwd_lse``'s."""
    w = want.float()
    return ((got.float() - w).abs() / (LSE_RTOL * w.abs().clamp(min=1.0))).max().item()


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


def _blocked(q, k, v, scale, block_q, block_k, kv_valid_len):
    """q, k, v in the blocked layout: q5 [B,Sq',KV,R,dh] and k, v [B,Sk',KV,dh]
    zero-padded to block multiples, with the blocks, the scale and the valid
    KV length (padded KV slots are masked)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"n_heads {h} is not a multiple of n_kv_heads {kvh}")
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    block_q = min(block_q, max(sq, 1))
    block_k = min(block_k, max(k.shape[1], 1))
    q5, _ = _pad_to(q.reshape(b, sq, kvh, h // kvh, dh), block_q, 1)
    k, sk0 = _pad_to(k, block_k, 1)
    v, _ = _pad_to(v, block_k, 1)
    if k.shape[1] != sk0 and kv_valid_len is None:
        kv_valid_len = sk0
    return q5, k, v, scale, block_q, block_k, kv_valid_len


def mha(q, k, v, *, causal: bool = True, window: Optional[int] = None,
        scale: Optional[float] = None, q_offset: int = 0,
        block_q: int = 512, block_k: int = 512, kv_valid_len=None):
    """Blocked flash attention.  q [B,Sq,H,dh], k/v [B,Sk,KV,dh] -> [B,Sq,H,dh].

    Never materialises [Sq,Sk].  ``kv_valid_len`` masks trailing cache slots.
    """
    return mha_fwd_lse(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset,
                       block_q=block_q, block_k=block_k, kv_valid_len=kv_valid_len)[0]


def mha_fwd_lse(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                scale: Optional[float] = None, q_offset: int = 0,
                block_q: int = 512, block_k: int = 512, kv_valid_len=None):
    """``mha`` that also returns each row's log-sum-exp of its scaled, masked
    scores, m + log(max(l, 1e-30)): (o [B,Sq,H,dh] in q's dtype, lse [B,H,Sq]
    f32), head h = kv head h // rep, as ``_mha_fwd_blocks`` orders them."""
    b, sq, h, dh = q.shape
    q5, k, v, scale, block_q, block_k, kv_valid_len = _blocked(q, k, v, scale, block_q,
                                                               block_k, kv_valid_len)
    out, lse = _mha_fwd_blocks(q5, k, v, causal=causal, window=window, scale=scale,
                               q_offset=q_offset, block_q=block_q, block_k=block_k,
                               kv_valid_len=kv_valid_len)
    return (out[:, :sq].reshape(b, sq, h, dh).to(q.dtype),
            lse.reshape(b, h, -1)[:, :, :sq].contiguous())


def _mha_bwd_blocks(q5, k, v, out5, lse, dout5, *, causal, window, scale, q_offset,
                    block_q, block_k, kv_valid_len=None):
    """Core blocked backward (port of ``repro.kernels.ref._mha_bwd_blocks``):
    P recomputed per block from lse, delta = rowsum(dO * O), dS = P (dP -
    delta).  q5/out5/dout5 [B,Sq,KV,R,dh], k/v [B,Sk,KV,dh], lse [B,KV,R,Sq].
    Returns (dq [B,Sq,KV,R,dh], dk, dv [B,Sk,KV,dh]) in f32.  Each q block's
    dq sums the kv blocks in order, and each kv block's dk and dv sum the q
    blocks in order, as the JAX package's scans do."""
    b, sq, kvh, rep, dh = q5.shape
    sk = k.shape[1]
    nq, nk = sq // block_q, sk // block_k
    f32 = torch.float32
    dev = q5.device
    delta = torch.einsum("bqgrd,bqgrd->bgrq", dout5.to(f32), out5.to(f32))
    dq = torch.zeros((b, sq, kvh, rep, dh), dtype=f32, device=dev)
    dk = torch.zeros((b, sk, kvh, dh), dtype=f32, device=dev)
    dv = torch.zeros((b, sk, kvh, dh), dtype=f32, device=dev)
    for iq in range(nq):
        qs = slice(iq * block_q, (iq + 1) * block_q)
        qblk, doblk = q5[:, qs].to(f32), dout5[:, qs].to(f32)
        lse_blk, delta_blk = lse[..., qs], delta[..., qs]
        qpos = q_offset + iq * block_q + torch.arange(block_q, device=dev)
        for ik in range(nk):
            ks = slice(ik * block_k, (ik + 1) * block_k)
            kblk, vblk = k[:, ks].to(f32), v[:, ks].to(f32)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk, kblk) * scale
            kpos = ik * block_k + torch.arange(block_k, device=dev)
            mask = _block_mask(qpos, kpos, causal=causal, window=window)
            if kv_valid_len is not None:
                mask &= (kpos < kv_valid_len)[None, :]
            p = torch.exp(torch.where(mask, s, NEG_INF) - lse_blk[..., None])
            dp = torch.einsum("bqgrd,bkgd->bgrqk", doblk, vblk)
            ds = p * (dp - delta_blk[..., None])
            dq[:, qs] += torch.einsum("bgrqk,bkgd->bqgrd", ds, kblk) * scale
            dv[:, ks] += torch.einsum("bgrqk,bqgrd->bkgd", p, doblk)
            dk[:, ks] += torch.einsum("bgrqk,bqgrd->bkgd", ds, qblk) * scale
    return dq, dk, dv


def mha_bwd(q, k, v, o, lse, do, *, causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None, q_offset: int = 0,
            block_q: int = 512, block_k: int = 512):
    """Gradients of ``mha`` from its output ``o`` and ``lse`` (``mha_fwd_lse``):
    q, o, do [B,Sq,H,dh], k/v [B,Sk,KV,dh], lse [B,H,Sq] -> (dq, dk, dv) in
    the inputs' dtypes, accumulated in f32; dk and dv sum the ``rep`` query
    heads of each kv head."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    sk = k.shape[1]
    q5, kp, vp, scale, block_q, block_k, kv_valid_len = _blocked(q, k, v, scale, block_q,
                                                                 block_k, None)
    o5, _ = _pad_to(o.reshape(b, sq, kvh, h // kvh, dh), block_q, 1)
    do5, _ = _pad_to(do.reshape(b, sq, kvh, h // kvh, dh), block_q, 1)
    lse4, _ = _pad_to(lse.to(torch.float32).reshape(b, kvh, h // kvh, sq), block_q, 3)
    dq, dk, dv = _mha_bwd_blocks(q5, kp, vp, o5, lse4, do5, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset, block_q=block_q,
                                 block_k=block_k, kv_valid_len=kv_valid_len)
    return (dq[:, :sq].reshape(b, sq, h, dh).to(q.dtype), dk[:, :sk].to(k.dtype),
            dv[:, :sk].to(v.dtype))


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


def decode_attention_bwd(q, k_cache, v_cache, valid_mask, do, *,
                         scale: Optional[float] = None):
    """Gradients (dq, dk_cache, dv_cache) of ``decode_attention`` for the
    output's cotangent ``do``: autograd through the plain forward, as the
    JAX package's ``_decode_vjp_bwd`` recomputes through its oracle's VJP."""
    with torch.enable_grad():
        q_, k_, v_ = (t.detach().requires_grad_(True) for t in (q, k_cache, v_cache))
        out = decode_attention(q_, k_, v_, valid_mask, scale=scale)
        return torch.autograd.grad(out, (q_, k_, v_), do)


# What the stats of a decode pass are held to: m is the largest score, an
# f32 sum in another order; l is compared at the plain version's m (l
# exp(m - m_plain), the mass a merge sees), so each score's rounding enters
# once.  Each may differ by STATS_RTOL of its value (~1700 f32 ulps);
# dropping one 256-slot split of 4096 moves l by ~6 %.
STATS_RTOL = 1e-4


def stats_tolerance_ratio(got, want, dtype) -> float:
    """(acc, m, l) of a decode stats pass against the plain version's: the
    worst of m's and l's (at the plain m) |difference| / (ATOL + STATS_RTOL
    |plain|) and ``tolerance_ratio`` of acc / l in ``dtype`` (q's), the
    output the plain decode gives.  A row the plain version finds empty (m = NEG_INF:
    no valid slot) must be empty in ``got`` too, whatever its acc and l
    (its weight in a merge with any valid slot is exp(NEG_INF - m) = 0).
    At most 1 where ``got`` agrees."""
    (acc, m, l), (acc_w, m_w, l_w) = got, want
    if acc.shape != acc_w.shape or m.shape != m_w.shape or l.shape != l_w.shape:
        raise ValueError(f"shapes {tuple(acc.shape)} and {tuple(acc_w.shape)} differ")
    live = m_w > NEG_INF / 2
    if bool(((m > NEG_INF / 2) != live).any()):
        return float("inf")
    if not bool(live.any()):
        return 0.0

    def rel(a, b):
        return ((a - b).abs() / (ATOL + STATS_RTOL * b.abs()))[live].max().item()

    def norm(a, s):
        return (a / torch.clamp(s, min=1e-30)[..., None])[live].to(dtype)
    l_at = l.float() * torch.exp(torch.where(live, m.float() - m_w.float(), 0.0))
    return max(rel(m.float(), m_w.float()), rel(l_at, l_w.float()),
               tolerance_ratio(norm(acc.float(), l.float()), norm(acc_w.float(), l_w.float())))



# What the SSD kernel is held to against ``ssd_chunked``.  Both compute in
# f32 but sum in other orders (the kernel takes decays as differences of
# cumulative sums, as the Pallas kernel does, where the plain version takes
# segment sums), and y is a sum over a whole chunk and the carried state, so
# the error scales with the output's size, not with each element's: each
# (batch, head) is held to SSD_ATOL + SSD_RTOL * its largest |value|, about
# 840 f32 ulps of that scale.  The JAX package holds its Pallas kernel to
# the oracle at 5e-4 absolute on outputs of order 10 (tests/test_kernels.py),
# a looser bound.  Dropping the state that enters one chunk, or one chunk's
# intra-chunk term, moves y by a sizeable part of that scale and fails.
SSD_ATOL = 1e-5
SSD_RTOL = 1e-4


def ssd_tolerance_ratio(got: torch.Tensor, want: torch.Tensor, head_dim: int = 2) -> float:
    """max |got - want| / (SSD_ATOL + SSD_RTOL * max |want|), both maxima
    taken per (batch, head); ``head_dim`` is 2 for y [B,S,H,P] and 1 for the
    state [B,H,P,N].  At most 1 where ``got`` agrees with the plain version."""
    if got.shape != want.shape:
        raise ValueError(f"shapes {tuple(got.shape)} and {tuple(want.shape)} differ")
    w = want.float().movedim(head_dim, 1).flatten(2)
    d = (got.float().movedim(head_dim, 1).flatten(2) - w).abs()
    allowed = SSD_ATOL + SSD_RTOL * w.abs().amax(-1)
    return (d.amax(-1) / allowed).max().item()


def _segsum(dA):
    """Stable segment sum: out[..., i, j] = sum of dA[..., k] for k in (j, i].

    dA [..., L] -> [..., L, L], -inf above the diagonal.
    """
    L = dA.shape[-1]
    x = dA[..., None].expand(*dA.shape, L)  # x[..., k, j] = dA[k]
    ones = torch.ones((L, L), dtype=torch.bool, device=dA.device)
    x = torch.where(torch.tril(ones, diagonal=-1), x, 0.0)  # keep k > j
    seg = torch.cumsum(x, dim=-2)  # [..., i, j] = sum_{k=j+1..i} dA[k]
    return torch.where(torch.tril(ones), seg, float("-inf"))


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, h_init=None):
    """SSD dual form over chunks (port of ``repro.models.ssm.ssd_chunked``).

    x [B,S,H,P] (pre-discretisation), dt [B,S,H] (post-softplus), a [H]
    (negative reals), b_mat/c_mat [B,S,G,N]; head h reads group h // (H/G).
    Returns (y [B,S,H,P], final_state [B,H,P,N]), both f32.  The JAX
    package's four-operand einsum is taken in stages (C B^T over n first),
    so nothing of size [B,NC,L,L,H,N] is made.  A ragged S is zero-padded to
    a chunk multiple, as the JAX package's ``ssm_apply`` pads it: dt = 0 on
    the padding keeps the state exact.
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if h % g:
        raise ValueError(f"{h} heads are not a multiple of {g} groups")
    x, dt, b_mat, c_mat = (_pad_to(t, chunk, 1)[0] for t in (x, dt, b_mat, c_mat))
    rep = h // g
    nc = x.shape[1] // chunk
    f32 = torch.float32

    xc = x.reshape(bsz, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, chunk, h).to(f32)
    bc = b_mat.reshape(bsz, nc, chunk, g, n).to(f32).repeat_interleave(rep, 3)
    cc = c_mat.reshape(bsz, nc, chunk, g, n).to(f32).repeat_interleave(rep, 3)

    dA = (dtc * a.to(f32)).movedim(-1, 2)      # [B,NC,H,L]
    dA_cs = torch.cumsum(dA, dim=-1)           # [B,NC,H,L]

    # ---- intra-chunk (attention-like) ----
    xdt = xc * dtc[..., None]                  # [B,NC,L,H,P]
    w = torch.einsum("bclhn,bcshn->bchls", cc, bc) * torch.exp(_segsum(dA))
    y = torch.einsum("bchls,bcshp->bclhp", w, xdt)
    del w

    # ---- chunk states ----
    decay_to_end = torch.exp(dA_cs[..., -1:] - dA_cs)  # [B,NC,H,L]
    states = torch.einsum("bcshn,bcshp->bchpn", bc, xdt * decay_to_end.movedim(2, 3)[..., None])

    # ---- inter-chunk recurrence over chunks ----
    chunk_decay = torch.exp(dA_cs[..., -1])    # [B,NC,H]
    prev = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) if h_init is None
            else h_init.to(f32))
    prev_states = torch.empty_like(states)     # the state entering each chunk
    for c in range(nc):
        prev_states[:, c] = prev
        prev = states[:, c] + chunk_decay[:, c, :, None, None] * prev

    # ---- inter-chunk contribution ----
    in_decay = torch.exp(dA_cs).movedim(2, 3)  # [B,NC,L,H]: decay from chunk start to l
    y = y + torch.einsum("bclhn,bchpn->bclhp", cc, prev_states) * in_decay[..., None]
    return y.reshape(bsz, nc * chunk, h, p)[:, :s], prev


def ssd_chunked_bwd(x, dt, a, b_mat, c_mat, chunk: int, dy, dstate, h_init=None):
    """Gradients of ``ssd_chunked`` from the cotangents of its outputs, dy
    [B,S,H,P] and dstate [B,H,P,N]: (dx, ddt, da, db, dc, dh_init), f32, in
    the shapes of the inputs; dh_init is None where h_init is.  Autograd
    through the plain forward, which zero-pads a ragged S (dt = 0 on the
    padding): the gradients come back cut to S."""
    f32 = torch.float32
    with torch.enable_grad():
        ins = [t.detach().to(f32).requires_grad_() for t in (x, dt, a, b_mat, c_mat)]
        if h_init is not None:
            ins.append(h_init.detach().to(f32).requires_grad_())
        y, st = ssd_chunked(*ins[:5], chunk, h_init=ins[5] if h_init is not None else None)
        grads = torch.autograd.grad((y, st), ins, (dy.to(f32), dstate.to(f32)))
    return (*grads[:5], grads[5] if h_init is not None else None)


# What the SSD backward kernel is held to against ``ssd_chunked_bwd``: as the
# forward, 1e-5 + 1e-4 of the largest |value| of a slice (1e-4 is the JAX
# package's gradient tolerance, tests/test_kernels.py), the maxima taken per
# (batch, head) for dx and ddt, per (batch, group) for dB and dC, and per
# head for da and dh_init.  ddt is a sum of terms that cancel (the decays'
# gradient), so a bound relative to each element would be meaningless there.
SSD_GRAD_ATOL = 1e-5
SSD_GRAD_RTOL = 1e-4
SSD_GRAD_NAMES = ("dx", "ddt", "da", "db", "dc", "dh_init")
SSD_GRAD_KEEP = {"dx": (0, 2), "ddt": (0, 2), "da": (0,), "db": (0, 2), "dc": (0, 2),
                 "dh_init": (1,)}


def ssd_grad_tolerance_ratio(got: torch.Tensor, want: torch.Tensor, keep,
                             atol_scale: float = 1.0) -> float:
    """max |got - want| / (SSD_GRAD_ATOL * atol_scale + SSD_GRAD_RTOL * max
    |want|), both maxima taken over every dim but those in ``keep``
    (``SSD_GRAD_KEEP`` gives them for each gradient).  At most 1 where
    ``got`` agrees.  ``atol_scale`` scales the absolute term with the
    cotangents' size (the gradient is linear in them): inside a model,
    whose loss is a mean over thousands of tokens, the caller passes their
    largest |value|."""
    if got.shape != want.shape:
        raise ValueError(f"shapes {tuple(got.shape)} and {tuple(want.shape)} differ")
    w = want.float()
    d = (got.float() - w).abs()
    other = [i for i in range(w.dim()) if i not in keep]
    if other:
        w, d = w.abs().amax(dim=other), d.amax(dim=other)
    return (d / (SSD_GRAD_ATOL * atol_scale + SSD_GRAD_RTOL * w.abs())).max().item()


def ssd_grad_ratios(got, want, atol_scale: float = 1.0) -> dict:
    """{name: ssd_grad_tolerance_ratio} of two tuples (dx, ddt, da, db, dc,
    dh_init) as ``ssd_chunked_bwd`` returns them; a None dh_init is left out."""
    return {name: ssd_grad_tolerance_ratio(g, w, SSD_GRAD_KEEP[name], atol_scale)
            for name, g, w in zip(SSD_GRAD_NAMES, got, want) if w is not None}
