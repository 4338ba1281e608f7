"""LM stacks: init, forward, loss and cached decode (port of
``repro.models.transformer``: the dense, SSM, MoE and hybrid families, the
VLM prefix-LM over stubbed patch embeddings and the audio encoder-decoder
over stubbed frame embeddings).

Parameters are a plain dict in the JAX package's tree layout:
``{"embed", "layers": [one dict per period position], "final_norm",
"unembed"}``, with every layer leaf stacked ``[n_periods, ...]``; a model
with a frontend adds ``frontend_proj`` [d_embed, d], an encoder-decoder
``encoder = {"layers", "final_norm"}`` and, on every decoder layer, the
cross-attention block ``cross`` with its pre-norm ``norm_x``.  The JAX
package scans over periods; here a Python loop walks them.

``layer_param_fn`` is the FSDP hook: the trainer stores parameter shards and
passes a gather function that ``stack_apply`` calls on each period's
parameters inside the period's body, so each period's weights are gathered
just in time and autograd sends the gradients back through the gather's
transpose; ``layer_param_fn_enc`` is the same hook for the encoder's stack.
With ``remat="full"`` the body runs under ``torch.utils.checkpoint``, so the
backward gathers again, as the JAX package's scan under ``jax.checkpoint``
does; ``remat="dots"`` keeps the outputs of the products without batch
dimensions as well (``save_dots``).

``tp`` is the model axis (``parallel.tensor.ModelAxis``, tensor and expert
parallelism): the parameters the layers see are then this rank's shards by
the sharding rules, and each layer runs its share (``attention.shard_heads``,
``ssm.shard_mixer``, ``moe_apply``'s experts, the MLP's d_ff); the embedding
and the logits are vocab-parallel.  Without it (or at size 1) every layer
runs whole.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import EncoderConfig, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (cross_entropy, dense_init, mlp_apply, padded_vocab,
                                       rms_norm, rms_norm_init, stacked_init)
from repro_torch.parallel import sharding as sh

ParamFn = Optional[Callable[[Any], Any]]


def _check_family(cfg: ModelConfig) -> None:
    """The families are dense decoders, pure-SSM (Mamba-2) models, MoE
    decoders (attention layers and a ``MoEConfig``), hybrids (a pattern of
    attention and Mamba-2 layers, MoE optional), the VLM prefix-LM (a dense
    decoder with a patch ``FrontendConfig``) and the audio encoder-decoder
    (a dense decoder with an ``EncoderConfig`` over a frame frontend).  A
    family without the sub-config it needs, or a layout no configuration of
    the zoo has, raises."""
    kinds = set(cfg.pattern)
    attn_only = cfg.ssm is None and kinds == {"attn"}
    needs = {"moe": ("a MoEConfig (cfg.moe)", cfg.moe is not None),
             "vlm": ("a FrontendConfig (cfg.frontend)", cfg.frontend is not None),
             "audio": ("an EncoderConfig (cfg.encoder) and a FrontendConfig (cfg.frontend)",
                       cfg.encoder is not None and cfg.frontend is not None)}
    if cfg.family in needs and not needs[cfg.family][1]:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} needs "
                                  f"{needs[cfg.family][0]}")
    dense = attn_only and not cfg.moe
    layout = {"dense": dense, "moe": attn_only, "vlm": dense, "audio": dense,
              "ssm": cfg.ssm is not None and kinds == {"mamba"} and not cfg.moe,
              "hybrid": cfg.ssm is not None and kinds <= {"attn", "mamba"}}
    extras = ((cfg.frontend is not None) == (cfg.family in ("vlm", "audio"))
              and (cfg.encoder is not None) == (cfg.family == "audio"))
    if not (layout.get(cfg.family, False) and extras):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} with layers {sorted(kinds)}, "
                                  f"moe {cfg.moe is not None}, ssm {cfg.ssm is not None}, "
                                  f"frontend {cfg.frontend is not None} and encoder "
                                  f"{cfg.encoder is not None} is a layout no configuration of "
                                  f"the model zoo has")


def _enc_cfg(e: EncoderConfig, base: ModelConfig) -> ModelConfig:
    """The encoder seen as a dense ModelConfig, for reuse of the layers (its
    head dim is d_model / n_heads)."""
    return base.replace(name=base.name + "-enc", family="dense", n_layers=e.n_layers,
                        d_model=e.d_model, n_heads=e.n_heads, n_kv_heads=e.n_kv_heads,
                        d_ff=e.d_ff, moe=None, ssm=None, layer_pattern=None, frontend=None,
                        encoder=None, head_dim=None)


def period_spec(cfg: ModelConfig) -> Tuple[Tuple[str, Optional[str]], ...]:
    """((mixer_kind, ffn_kind), ...) for one period."""
    moe_every = cfg.moe.moe_every if cfg.moe else 1
    plen = math.lcm(len(cfg.pattern), moe_every)
    out = []
    for i in range(plen):
        kind = cfg.pattern[i % len(cfg.pattern)]
        if cfg.layer_has_moe(i):
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "dense"
        else:
            ffn = None
        out.append((kind, ffn))
    return tuple(out)


def n_periods(cfg: ModelConfig) -> int:
    plen = len(period_spec(cfg))
    assert cfg.n_layers % plen == 0, (cfg.name, cfg.n_layers, plen)
    return cfg.n_layers // plen


def _init_stack(cfg: ModelConfig, dtype, gen, device, *, cross: bool) -> list:
    """One dict a period position, leaves stacked [n_periods, ...]; with
    ``cross``, each layer's cross-attention block and its pre-norm."""
    d, np_ = cfg.d_model, n_periods(cfg)
    layers = []
    for kind, ffn in period_spec(cfg):
        lp = {"norm1": torch.zeros((np_, d), dtype=torch.float32, device=device)}
        if kind == "attn":
            lp["mixer"] = stacked_init(attn.attn_shapes(cfg), np_, dtype, gen, device)
        else:
            lp["mixer"] = ssm_mod.ssm_init(cfg, np_, dtype, gen, device)
        if cross:
            lp["norm_x"] = torch.zeros((np_, d), dtype=torch.float32, device=device)
            lp["cross"] = stacked_init(attn.attn_shapes(cfg), np_, dtype, gen, device)
        if ffn is not None:
            lp["norm2"] = torch.zeros((np_, d), dtype=torch.float32, device=device)
        if ffn == "moe":
            lp["ffn"] = moe_mod.moe_init(cfg, np_, dtype, gen, device)
        elif ffn == "dense":
            lp["ffn"] = stacked_init({"w_gate": ((d, cfg.d_ff), d), "w_up": ((d, cfg.d_ff), d),
                                      "w_down": ((cfg.d_ff, d), cfg.d_ff)},
                                     np_, dtype, gen, device)
        layers.append(lp)
    return layers


def init_lm(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random parameters from a seeded generator on ``device``.

    Each matrix is drawn in f32 and cast to ``cfg.dtype``; norm scales, the
    MoE router and the SSM's conv, decay and skip leaves stay f32, as in the
    JAX package.
    Layer leaves are drawn one period at a time, so the f32 peak is one period's largest
    leaf, not a whole stacked leaf (7.5 GB for llama3-8b's w_gate).  On the
    "meta" device it makes the tree of shapes and dtypes only (a template).
    """
    _check_family(cfg)
    device = torch.device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    d, vp = cfg.d_model, padded_vocab(cfg)
    params = {
        "embed": dense_init((vp, d), dtype, gen, device, in_axis_size=d),
        "layers": _init_stack(cfg, dtype, gen, device, cross=cfg.family == "audio"),
        "final_norm": rms_norm_init(d, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init((d, vp), dtype, gen, device)
    if cfg.frontend is not None:
        params["frontend_proj"] = dense_init((cfg.frontend.d_embed, d), dtype, gen, device)
    if cfg.encoder is not None:
        ecfg = _enc_cfg(cfg.encoder, cfg)
        params["encoder"] = {"layers": _init_stack(ecfg, dtype, gen, device, cross=False),
                             "final_norm": rms_norm_init(ecfg.d_model, device)}
    return params


def param_count(params) -> int:
    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(count(v) for v in t)
        return t.numel()
    return count(params)


def _period(tree, p: int):
    """The period-``p`` slice of a stacked tree (views, no copies); a leaf
    may also be a list with one tensor per period."""
    if isinstance(tree, dict):
        return {k: _period(v, p) for k, v in tree.items()}
    return tree[p]


def _apply_sublayer(lp, x, positions, cfg: ModelConfig, spec, *, causal: bool,
                    mask=None, enc_out=None, prefix_len: int = 0, tp=None):
    """One layer; a layer with a ``cross`` block attends to ``enc_out``
    after its self-attention.  Returns (x, the MoE layer's aux loss, or None)."""
    kind, ffn = spec
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if kind == "attn":
        h = attn.attention(lp["mixer"], h, positions, cfg, causal=causal,
                           window=cfg.sliding_window, mask=mask, prefix_len=prefix_len, tp=tp)
    else:
        h = ssm_mod.ssm_apply(lp["mixer"], h, cfg, tp=tp)
    x = x + h
    if "cross" in lp:
        h = rms_norm(x, lp["norm_x"], cfg.norm_eps)
        x = x + attn.attention(lp["cross"], h, positions, cfg, context=enc_out, tp=tp)
    aux = None
    if ffn is not None:
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        if ffn == "moe":
            h, aux = moe_mod.moe_apply(lp["ffn"], h, cfg, tp=tp)
        else:
            h = _dense_ffn(lp["ffn"], h, cfg, tp)
        x = x + h
    return x, aux


def _dense_ffn(p, x, cfg: ModelConfig, tp=None):
    """The dense MLP, over its d_ff shard where d_ff splits over ``tp``."""
    split = sh.model_dim("w_gate", (cfg.d_model, cfg.d_ff), tp) is not None
    return mlp_apply(p, x, cfg.mlp_act, tp=tp if split else None)


_NO_BATCH_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def save_dots(ctx, op, *args, **kwargs):
    """The policy of remat "dots" (the JAX package's
    ``checkpoint_dots_with_no_batch_dims``): save the outputs of products
    without batch dimensions (the projections ``bsd,dhk->bshk`` and
    ``bqhd,hdk->bqk``, the MLP's, the SSM's and the router's in and out
    products) and recompute everything else in the backward (norms, RoPE,
    the flash forward, MoE's batched expert products ``ecd,edf->ecf``, the
    FSDP gathers).  ``torch.einsum`` lowers a product without batch dims to
    ``bmm`` with batch size 1 and a batched one to ``bmm`` with batch E, so
    the op alone cannot tell them apart: the leading dim can.  A kernel
    launched through ctypes inside an autograd function is invisible here
    and runs again in the recompute, as under "full"."""
    if op in _NO_BATCH_PRODUCTS or (op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(save_dots)


def stack_apply(layers, x, positions, cfg: ModelConfig, *, causal: bool = True,
                mask=None, enc_out=None, prefix_len: int = 0,
                layer_param_fn: ParamFn = None, tp=None):
    """Run the period stack over x [B,S,D].  Returns (x, the sum of the MoE
    layers' aux losses over periods and positions).

    ``layer_param_fn`` maps one period's parameters (a list over the period's
    positions) to the ones the layers use, inside the period's body.
    ``cfg.remat``: "none" keeps every activation for the backward; "full"
    keeps each period's input only and runs the body again in the backward;
    "dots" keeps the outputs of the products without batch dims besides
    (``save_dots``) and recomputes the rest.  ``tp``: the model axis.
    """
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: none, full or dots")
    specs = period_spec(cfg)

    def body(h, per_params):
        pp = layer_param_fn(per_params) if layer_param_fn else per_params
        auxs = []
        for pos, spec in enumerate(specs):
            h, a = _apply_sublayer(pp[pos], h, positions, cfg, spec, causal=causal, mask=mask,
                                   enc_out=enc_out, prefix_len=prefix_len, tp=tp)
            if a is not None:
                auxs.append(a)
        return h, auxs

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(n_periods(cfg)):
        per = [_period(lp, p) for lp in layers]
        if cfg.remat == "full" and torch.is_grad_enabled():
            x, auxs = checkpoint(body, x, per, use_reentrant=False)
        elif cfg.remat == "dots" and torch.is_grad_enabled():
            x, auxs = checkpoint(body, x, per, use_reentrant=False, context_fn=_dots_contexts)
        else:
            x, auxs = body(x, per)
        for a in auxs:
            total = total + a
    return x, total


def vocab_axis(cfg: ModelConfig, tp):
    """``tp`` where the vocab splits over it (embed on its rows, unembed on
    its columns), else None."""
    split = sh.model_dim("embed", (padded_vocab(cfg), cfg.d_model), tp) is not None
    return tp if split else None


def embed_lookup(params, tokens, cfg: ModelConfig, tp=None):
    """The token embeddings [..., D]; over a vocab split by the model axis,
    each rank looks up the tokens of its rows (the others read 0) and the
    sum leaves through ``reduce``."""
    tp = vocab_axis(cfg, tp)
    if tp is None:
        return params["embed"][tokens]
    table = params["embed"]
    lo, hi = tp.block(table.shape[0] * tp.size)
    mine = (tokens >= lo) & (tokens < hi)
    x = table[(tokens - lo).clamp(0, hi - lo - 1)]
    return tp.reduce(torch.where(mine[..., None], x, torch.zeros_like(x)))


def unembed(params, x, cfg: ModelConfig, tp=None):
    """Logits of final hidden states x [..., D] -> [..., padded vocab]; over
    a vocab split by the model axis ``tp``, this rank's slice of them (x
    enters through ``copy``)."""
    tp = vocab_axis(cfg, tp)
    if tp is not None:
        x = tp.copy(x)
    if cfg.tie_embeddings:
        return torch.einsum("...d,vd->...v", x, params["embed"])
    return torch.einsum("...d,dv->...v", x, params["unembed"])


def frontend(params, feats, cfg: ModelConfig, dtype, tp=None):
    """A frontend's features [B,T,d_embed] (patches or frames), cast to
    ``dtype`` and projected to [B,T,D]; where ``frontend_proj``'s output
    columns split over the model axis, each rank projects its columns and
    they are gathered (``gather_last``)."""
    x = torch.einsum("bte,ed->btd", feats.to(dtype), params["frontend_proj"])
    split = sh.model_dim("frontend_proj", (cfg.frontend.d_embed, cfg.d_model), tp) is not None
    return tp.gather_last(x) if split else x


def _prefix_inputs(params, batch, cfg: ModelConfig, tp=None):
    """The input embeddings [B,S_total,D] and the prefix length: a VLM's
    patches [B,T,d_embed], cast to the embeddings' dtype and projected, in
    front of the text's."""
    x = embed_lookup(params, batch["tokens"], cfg, tp)
    if cfg.family != "vlm":
        return x, 0
    pre = frontend(params, batch["patches"], cfg, x.dtype, tp)
    return torch.cat([pre, x], dim=1), pre.shape[1]


def encode(params, frames, cfg: ModelConfig, *, layer_param_fn: ParamFn = None, tp=None):
    """The audio encoder over stubbed frame embeddings [B,T,d_embed]:
    projected, non-causal layers, final norm -> [B,T,D]."""
    ecfg = _enc_cfg(cfg.encoder, cfg)
    x = frontend(params, frames, cfg, getattr(torch, cfg.dtype), tp)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = stack_apply(params["encoder"]["layers"], x, positions, ecfg, causal=False,
                       layer_param_fn=layer_param_fn, tp=tp)
    return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def lm_forward(params, batch, cfg: ModelConfig, *, last_only: bool = False,
               hidden: bool = False, layer_param_fn: ParamFn = None,
               layer_param_fn_enc: ParamFn = None, tp=None):
    """Teacher-forced forward.  Returns (logits, moe_aux) like the JAX package.

    batch: {"tokens" [B,S]}, with "patches" (vlm) or "frames" (audio).
    Logits (or hidden states) are of the text positions only.
    last_only: logits of the final position only.
    hidden: the final (normed) hidden states [B,S,D] in place of the logits,
    for a caller that applies ``unembed`` to a few positions at a time.
    layer_param_fn, layer_param_fn_enc: see ``stack_apply``, for the decoder's
    and the encoder's stack.
    tp: the model axis; the logits are then this rank's vocab slice where
    the vocab splits over it (``vocab_axis``).
    """
    _check_family(cfg)
    enc_out = None
    if cfg.family == "audio":
        enc_out = encode(params, batch["frames"], cfg, layer_param_fn=layer_param_fn_enc, tp=tp)
    x, n_prefix = _prefix_inputs(params, batch, cfg, tp)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = stack_apply(params["layers"], x, positions, cfg, causal=True, enc_out=enc_out,
                         prefix_len=n_prefix, layer_param_fn=layer_param_fn, tp=tp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    if last_only:
        x = x[:, -1:]
    out = x if hidden else unembed(params, x, cfg, tp)
    return out, aux


def lm_loss(params, batch, cfg: ModelConfig, *, layer_param_fn: ParamFn = None,
            layer_param_fn_enc: ParamFn = None, aux_weight: float = 0.01, tp=None):
    """(loss, {"ce", "moe_aux"}) for a teacher-forced batch with "targets";
    over a model axis ``tp`` the cross-entropy is vocab-parallel, and every
    rank of the axis holds the same loss."""
    logits, aux = lm_forward(params, batch, cfg, layer_param_fn=layer_param_fn,
                             layer_param_fn_enc=layer_param_fn_enc, tp=tp)
    loss, ce = cross_entropy(logits, batch["targets"], cfg.vocab_size, tp=vocab_axis(cfg, tp))
    return loss + aux_weight * aux, {"ce": ce, "moe_aux": aux}


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int, device="cuda", *,
                      tp=None, context_shards: int = 1):
    """Per-period-position caches, leaves stacked [n_periods, ...].

    An attention position keeps a KV cache; a sliding-window architecture a
    ring cache of ``min(capacity, sliding_window)`` slots.  A Mamba position
    keeps its conv window and SSM state, whatever the capacity.
    ``context_shards``: a shard's cache of context-parallel decode, 1/n of
    each attention cache's slots (the cache's own, after the window).
    ``tp``: a model-axis rank's, the kv heads, conv channels and SSD heads
    of its share.
    """
    _check_family(cfg)
    np_ = n_periods(cfg)
    dtype = getattr(torch, cfg.dtype)
    caches = []
    for kind, _ in period_spec(cfg):
        if kind == "attn":
            cap = capacity
            if cfg.sliding_window is not None:
                cap = min(capacity, cfg.sliding_window)
            if cap % context_shards:
                raise ValueError(f"{cap} cache slots do not split over {context_shards} shards")
            one = attn.init_kv_cache(cfg, batch, cap // context_shards, dtype, device,
                                     n_kv=attn.n_kv_heads(cfg, tp))
        else:
            one = ssm_mod.init_ssm_cache(cfg, batch, device, tp=tp)
        caches.append({k: v[None].repeat((np_,) + (1,) * v.dim()) for k, v in one.items()})
    return caches


def init_cross_state(params, enc_out, cfg: ModelConfig):
    """Each decoder layer's cross-attention K/V over the encoder output
    ``enc_out`` [B,Sk,D]: one dict a period position, leaves stacked
    [n_periods, B, Sk, KV, dh] like ``init_decode_state``'s."""
    out = []
    for lp in params["layers"]:
        per = [attn.precompute_cross_kv(_period(lp["cross"], p), enc_out, cfg)
               for p in range(n_periods(cfg))]
        out.append({k: torch.stack([c[k] for c in per]) for k in ("k", "v")})
    return out


def decode_step(params, state, token, pos: int, cfg: ModelConfig, *, cross_state=None,
                layer_param_fn: ParamFn = None, ctx=None, tp=None, rows=None):
    """One decode step.  token [B,1] integer, pos the absolute position (int).

    ``state`` is updated in place and returned.  An encoder-decoder model
    takes ``cross_state`` (``init_cross_state`` of the encoded frames).
    ``layer_param_fn``: the FSDP hook of ``stack_apply``, called on each
    period's parameters.  ``ctx``: context-parallel decode over the rails
    (``attention.decode_attention``).  ``tp``: the model axis; every rank
    gets the whole logits (its vocab slices gathered).  ``rows``:
    weight-resident decode over batch-sharded caches: each mixer steps this
    rank's rows of the whole batch's token (``parallel.resident.Rows``).
    Returns (logits [B,1,V], state).
    """
    _check_family(cfg)
    if cfg.encoder is not None and cross_state is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: decode_step needs cross_state "
                         f"= init_cross_state(params, encode(params, frames, cfg), cfg)")
    x = embed_lookup(params, token, cfg, tp)
    specs = period_spec(cfg)
    for p in range(n_periods(cfg)):
        pp = [_period(lp, p) for lp in params["layers"]]
        if layer_param_fn is not None:
            pp = layer_param_fn(pp)
        for i, (kind, ffn) in enumerate(specs):
            lp = pp[i]
            z = rms_norm(x, lp["norm1"], cfg.norm_eps)
            if kind == "attn":
                z, _ = attn.decode_attention(lp["mixer"], z, pos, _period(state[i], p), cfg,
                                             window=cfg.sliding_window, ctx=ctx, tp=tp,
                                             rows=rows)
            else:
                z, _ = ssm_mod.ssm_decode(lp["mixer"], z, _period(state[i], p), cfg, tp=tp,
                                          rows=rows)
            x = x + z
            if "cross" in lp:
                z = rms_norm(x, lp["norm_x"], cfg.norm_eps)
                z, _ = attn.decode_attention(lp["cross"], z, pos, None, cfg,
                                             cross_kv=_period(cross_state[i], p), tp=tp)
                x = x + z
            if ffn is not None:
                z = rms_norm(x, lp["norm2"], cfg.norm_eps)
                if ffn == "moe":  # B groups of one token; the aux loss is not used
                    z, _ = moe_mod.moe_apply(lp["ffn"], z, cfg, tp=tp)
                else:
                    z = _dense_ffn(lp["ffn"], z, cfg, tp)
                x = x + z
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, x, cfg, tp)
    vtp = vocab_axis(cfg, tp)
    return (logits if vtp is None else vtp.gather_last(logits)), state


def prefill(params, batch, cfg: ModelConfig, capacity: int):
    """Last-token logits of the whole prompt, with the batch's patches or
    frames (the caches are built by decode)."""
    return lm_forward(params, batch, cfg, last_only=True)
