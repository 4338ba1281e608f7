"""GQA attention: full-sequence (prefill, encoder, cross-attention) and
cached decode (port of ``repro.models.attention``).

Projections keep the JAX layout: wq/wk/wv [d, heads, dh], wo [H, dh, d].
At ``FLASH_MIN_SEQ`` tokens and above, prefill goes through ``ops.mha``
(the flash kernel on a CUDA tensor); decode on a cache of
``DECODE_KERNEL_MIN_CAPACITY`` slots and above goes through
``ops.decode_attention`` (the flash-decode kernel).  Both thresholds are the
JAX package's, so the port launches its kernels exactly where the reference
reaches its Pallas kernels.

Context-parallel decode (a cache sharded along its slots over the rails)
runs in two parts: ``context_local_stats`` writes the new token where this
shard owns its slot and computes the shard's unnormalised flash-decode
stats through ``ops.decode_attention(return_stats=True)`` at any capacity
(the kernel's stats variant on the card), and ``merge_decode_stats`` merges
them over the rails (flash-decoding's split-K combine).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import rope_apply
from repro_torch.parallel import sharding as sh

# sequences at or above this length take the flash path (never materialises
# [Sq,Sk]); below it the plain sdpa runs
FLASH_MIN_SEQ = 1024
# caches at or above this capacity take the flash-decode path
DECODE_KERNEL_MIN_CAPACITY = 4096


def attn_shapes(cfg: ModelConfig) -> dict:
    """{leaf: (shape, fan_in)} of one attention block."""
    dh, d = cfg.resolved_head_dim, cfg.d_model
    return {
        "wq": ((d, cfg.n_heads, dh), d),
        "wk": ((d, cfg.n_kv_heads, dh), d),
        "wv": ((d, cfg.n_kv_heads, dh), d),
        "wo": ((cfg.n_heads, dh, d), cfg.n_heads * dh),
    }


def _repeat_kv(k, n_heads: int):
    """[B,S,KV,dh] -> [B,S,H,dh] by repeating each group."""
    kv = k.shape[-2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=-2)


def sdpa(q, k, v, *, mask=None, scale: Optional[float] = None):
    """q [B,Sq,H,dh], k/v [B,Sk,H,dh]; softmax in f32.

    As in the JAX package, Q.K^T is rounded to the input dtype before the
    f32 softmax, and the probabilities are cast to v's dtype before P.V.
    """
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def make_mask(sq: int, sk: int, *, causal: bool, window: Optional[int],
              q_offset: int = 0, device="cuda"):
    """[1,1,Sq,Sk] boolean mask."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m[None, None]


def attention(p, x, positions, cfg: ModelConfig, *, causal: bool = True,
              window: Optional[int] = None, context=None, mask=None,
              prefix_len: int = 0, tp=None):
    """Full-sequence attention (train, prefill, encoder, cross-attention).

    x [B,S,D]; context [B,Sk,D] for cross-attention (no rope, no mask: the
    plain sdpa over the source, as in the JAX package) or None (self);
    mask: optional explicit [.,.,Sq,Sk] bool mask (forces sdpa).
    prefix_len: prefix-LM semantics, composed as causal flash over the whole
    sequence plus a small full sdpa over the prefix block.
    tp: the model axis (``parallel.tensor.ModelAxis``); ``p`` then holds this
    rank's shards of the leaves (``shard_heads``).
    """
    if tp is not None and tp.active:
        p, x, context, reduce = shard_heads(p, x, context, cfg, tp)
        out = attention(p, x, positions, cfg, causal=causal, window=window, context=context,
                        mask=mask, prefix_len=prefix_len)
        return reduce(out)
    src = context if context is not None else x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    n_heads = q.shape[2]
    if context is None:  # rope only for self-attention
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)

    if mask is None and context is None and causal and x.shape[1] >= FLASH_MIN_SEQ:
        out = ops.mha(q, k, v, causal=True, window=window)
        if prefix_len:
            pre = sdpa(q[:, :prefix_len],
                       _repeat_kv(k[:, :prefix_len], n_heads),
                       _repeat_kv(v[:, :prefix_len], n_heads))
            out = torch.cat([pre.to(out.dtype), out[:, prefix_len:]], dim=1)
        return torch.einsum("bqhd,hdk->bqk", out, p["wo"])

    k = _repeat_kv(k, n_heads)
    v = _repeat_kv(v, n_heads)
    if mask is None and context is None and (causal or window is not None):
        sq, sk = x.shape[1], src.shape[1]
        mask = make_mask(sq, sk, causal=causal, window=window, device=x.device)
        if prefix_len:
            qi = torch.arange(sq, device=x.device)[:, None]
            ki = torch.arange(sk, device=x.device)[None, :]
            mask = mask | ((qi < prefix_len) & (ki < prefix_len))[None, None]
    out = sdpa(q, k, v, mask=mask)
    return torch.einsum("bqhd,hdk->bqk", out, p["wo"])


def shard_heads(p, x, context, cfg: ModelConfig, tp):
    """(leaves, x, context, reduce) of this rank's share of an attention
    block on the model axis ``tp``, whose leaves ``p`` are this rank's
    shards by the sharding rules.

    Where the query heads split over the axis (wq on its heads, wo on its
    rows), x and the context enter through ``copy``, the rank runs its H/M
    heads and the partial output leaves through ``reduce``.  Its kv heads
    are its shard of wk/wv where the kv heads split too; otherwise wk/wv are
    replicated (Megatron-style KV replication) and the rank takes the kv
    heads its query heads read, through ``copy``, so that their partial
    gradients are summed over the axis.  Where the heads do not split (wq
    and wo fall back to the head dim, which cannot be partitioned) the
    leaves are gathered (``gather_leaf``) and the block runs replicated.
    """
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if not heads_split(cfg, tp):
        full = dict(p)
        for name, shape in (("wq", (d, h, dh)), ("wo", (h, dh, d))):
            td = sh.model_dim(name, shape, tp)
            if td is not None:
                full[name] = tp.gather_leaf(p[name], td)
        return full, x, context, lambda out: out
    local = dict(p)
    if sh.model_dim("wk", (d, kv, dh), tp) is None:
        heads = kv_heads(cfg, tp, x.device)
        for name in ("wk", "wv"):
            local[name] = tp.copy(p[name])[:, heads]
    return (local, tp.copy(x), None if context is None else tp.copy(context), tp.reduce)


def heads_split(cfg: ModelConfig, tp) -> bool:
    """Whether the query heads split over the model axis ``tp``."""
    shape = (cfg.d_model, cfg.n_heads, cfg.resolved_head_dim)
    return sh.model_dim("wq", shape, tp) == 1


def kv_heads(cfg: ModelConfig, tp, device=None):
    """The kv heads (of all ``cfg.n_kv_heads``) that this rank's query heads
    read on the model axis ``tp``: all of them where the query heads do not
    split; the rank's block where the kv heads split too; else, with wk/wv
    replicated, a contiguous run (a slice) or one kv head for each query
    head (an index tensor)."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if tp is None or not tp.active or not heads_split(cfg, tp):
        return slice(None)
    if sh.model_dim("wk", (d, kv, dh), tp) is not None:
        return slice(*tp.block(kv))
    hl, rep = h // tp.size, h // kv
    first, last = tp.rank * hl // rep, ((tp.rank + 1) * hl - 1) // rep
    if hl % rep == 0 or rep % hl == 0:  # a contiguous run of kv heads, each read alike
        return slice(first, last + 1)
    return torch.arange(tp.rank * hl, (tp.rank + 1) * hl, device=device) // rep


def n_kv_heads(cfg: ModelConfig, tp=None) -> int:
    """How many kv heads a rank's cache holds on the model axis ``tp``."""
    heads = kv_heads(cfg, tp)
    if isinstance(heads, slice):
        return len(range(cfg.n_kv_heads)[heads])
    return heads.numel()


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device="cuda",
                  n_kv: Optional[int] = None):
    """Empty K/V [B, capacity, KV, dh] (``n_kv`` kv heads where given: a
    model-axis rank's) and the absolute position of each slot."""
    dh = cfg.resolved_head_dim
    shape = (batch, capacity, cfg.n_kv_heads if n_kv is None else n_kv, dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute position stored in each slot, shared by the batch; -1 = empty
        "slot_pos": torch.full((capacity,), -1, dtype=torch.int32, device=device),
    }


def decode_attention(p, x, pos: int, cache, cfg: ModelConfig, *,
                     window: Optional[int] = None, cross_kv=None, ctx=None, tp=None,
                     rows=None):
    """One-token attention.  x [B,1,D]; pos the absolute position (a Python int).

    Full cache: slot = pos.  SWA ring cache: slot = pos % capacity.
    The cache is updated IN PLACE (its k, v and slot_pos tensors are written
    at the slot), unlike the JAX package, which returns new arrays.
    cross_kv: {"k", "v"} [B,Sk,KV,dh] of ``precompute_cross_kv``: cross-attention
    over the cached encoder K/V (plain sdpa, no rope, no mask); ``cache`` is
    returned unchanged.
    ctx: {"fabric": the rails' ``Fabric``, "index": this shard's index on
    it} for context-parallel decode: the cache holds this shard's slots,
    contiguous ones of the whole cache's (``context_slot``), and the
    shards' stats are merged over the rails (``merge_decode_stats``).
    tp: the model axis; ``p`` then holds this rank's shards of the leaves,
    the rank runs its query heads (``shard_heads``), its cache holds the kv
    heads they read (``kv_heads``; so does ``cross_kv``, given whole) and
    the partial output leaves through ``reduce``.
    rows: weight-resident decode over a batch-sharded cache
    (``parallel.resident.Rows``): x is the whole batch's, the cache holds
    this rank's rows, whose outputs are gathered before ``wo``.
    Returns (out [B,1,D], cache).
    """
    if tp is not None and tp.active:
        p, x, _, reduce = shard_heads(p, x, None, cfg, tp)
        if cross_kv is not None:
            heads = kv_heads(cfg, tp, x.device)
            cross_kv = {k: v[:, :, heads] for k, v in cross_kv.items()}
        out, cache = decode_attention(p, x, pos, cache, cfg, window=window, cross_kv=cross_kv,
                                      ctx=ctx, rows=rows)
        return reduce(out), cache
    if cross_kv is not None:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        out = sdpa(q, _repeat_kv(cross_kv["k"], q.shape[2]),
                   _repeat_kv(cross_kv["v"], q.shape[2]))
        return torch.einsum("bqhd,hdk->bqk", out, p["wo"]), cache
    pos = int(pos)
    capacity = cache["k"].shape[1]
    q, k_new, v_new = decode_qkv(p, x, pos, cfg)
    if rows is not None:
        q, k_new, v_new = rows.local(q), rows.local(k_new), rows.local(v_new)
    if ctx is not None:
        fab = ctx["fabric"]
        stats = context_local_stats(q, k_new, v_new, pos, cache, ctx["index"], fab.n_shards,
                                    window)
        out = merge_decode_stats(*stats, fab).to(q.dtype)
        return torch.einsum("bqhd,hdk->bqk", out, p["wo"]), cache

    slot = pos if window is None else pos % capacity
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["slot_pos"][slot] = pos
    valid = _valid_slots(cache["slot_pos"], pos, window)

    if capacity >= DECODE_KERNEL_MIN_CAPACITY:  # no repeat_kv
        vm = valid[None, :].expand(q.shape[0], capacity)
        out = ops.decode_attention(q, cache["k"], cache["v"], vm)
    else:
        k = _repeat_kv(cache["k"], q.shape[2])
        v = _repeat_kv(cache["v"], q.shape[2])
        out = sdpa(q, k, v, mask=valid[None, None, None, :])
    if rows is not None:
        out = rows.gather(out)
    return torch.einsum("bqhd,hdk->bqk", out, p["wo"]), cache


def decode_qkv(p, x, pos: int, cfg: ModelConfig):
    """q [B,1,H,dh] and the new token's k, v [B,1,KV,dh] at position
    ``pos``, rope applied to q and k."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    posv = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    return rope_apply(q, posv, cfg.rope_theta), rope_apply(k_new, posv, cfg.rope_theta), v_new


def _valid_slots(slot_pos, pos: int, window: Optional[int]):
    """[C] bool: the slots holding a position the query at ``pos`` sees."""
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid &= slot_pos > pos - window
    return valid


def context_slot(pos, local_cap: int, index: int, n: int, window: Optional[int]):
    """(owned, local slot) of position ``pos`` (an int or an integer tensor)
    on shard ``index`` of ``n``, each holding ``local_cap`` contiguous slots
    of a cache of ``n * local_cap``: the cache's slot is pos, or pos modulo
    its slots on a sliding window's ring, and its owner is slot //
    local_cap.  The reference takes the offset from the step's capacity,
    not the cache's own slots, and writes without the ring (ROADMAP Queue
    3); this gives the unsharded decode's slots."""
    slot = pos if window is None else pos % (n * local_cap)
    return slot // local_cap == index, slot - index * local_cap


def context_local_stats(q, k_new, v_new, pos: int, cache, index: int, n: int,
                        window: Optional[int]):
    """The local part of context-parallel decode on shard ``index`` of
    ``n``: the new token's K/V [B,1,KV,dh] written where this shard owns its
    slot, then the shard's unnormalised stats (acc [B,KV,R,dh], m, l
    [B,KV,R], f32) of q [B,1,H,dh] over its valid slots."""
    owned, slot = context_slot(pos, cache["k"].shape[1], index, n, window)
    if owned:
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        cache["slot_pos"][slot] = pos
    valid = _valid_slots(cache["slot_pos"], pos, window)
    vm = valid[None, :].expand(q.shape[0], valid.shape[0])
    return ops.decode_attention(q, cache["k"], cache["v"], vm, return_stats=True)


def merge_decode_stats(acc, m, l, fab):
    """The shards' stats merged over the rails ``fab`` (anything with
    ``pmax`` and ``all_reduce``): m_g = max m, then l and acc rescaled by
    exp(m - m_g) and summed, as the JAX package's split-K combine does.
    Returns the attention output [..., B,1,H,dh] in f32 (heads (KV,
    R)-major; leading dims as the stats')."""
    m_g = fab.pmax(m)
    scale = torch.exp(m - m_g)
    l_g = fab.all_reduce(l * scale)
    acc_g = fab.all_reduce(acc * scale[..., None])
    out = acc_g / torch.clamp(l_g, min=1e-30)[..., None]
    return out.flatten(-3, -2).unsqueeze(-3)


def precompute_cross_kv(p, context, cfg: ModelConfig):
    """The encoder-side K/V [B,Sk,KV,dh] of one cross-attention block, made
    once a request (encoder-decoder decode)."""
    return {
        "k": torch.einsum("bsd,dhk->bshk", context, p["wk"]),
        "v": torch.einsum("bsd,dhk->bshk", context, p["wv"]),
    }
