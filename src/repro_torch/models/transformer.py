"""Decoder LM: init, forward, loss and cached decode (port of
``repro.models.transformer``: the dense, SSM and MoE families).

Parameters are a plain dict in the JAX package's tree layout:
``{"embed", "layers": [one dict per period position], "final_norm",
"unembed"}``, with every layer leaf stacked ``[n_periods, ...]``.  The JAX
package scans over periods; here a Python loop walks them.

``layer_param_fn`` is the FSDP hook: the trainer stores parameter shards and
passes a gather function that ``stack_apply`` calls on each period's
parameters inside the period's body, so each period's weights are gathered
just in time and autograd sends the gradients back through the gather's
transpose.  With ``remat="full"`` the body runs under
``torch.utils.checkpoint``, so the backward gathers again, as the JAX
package's scan under ``jax.checkpoint`` does.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (cross_entropy, dense_init, mlp_apply, padded_vocab,
                                       rms_norm, rms_norm_init, stacked_init)

ParamFn = Optional[Callable[[Any], Any]]


def _check_family(cfg: ModelConfig) -> None:
    """The ported families are dense decoders, pure-SSM (Mamba-2) models and
    MoE decoders (attention layers and a ``MoEConfig``); other families
    raise and name their item of the roadmap."""
    todo = {"moe": "item 6, hybrid", "hybrid": "item 6, hybrid",
            "vlm": "item 7, remaining families", "audio": "item 7, remaining families"}
    attn_only = cfg.ssm is None and set(cfg.pattern) == {"attn"}
    ported = ((cfg.family == "dense" and attn_only and not cfg.moe)
              or (cfg.family == "moe" and attn_only and cfg.moe is not None)
              or (cfg.family == "ssm" and cfg.ssm is not None and set(cfg.pattern) == {"mamba"}
                  and not cfg.moe))
    if cfg.family == "moe" and cfg.moe is None:
        raise NotImplementedError(f"{cfg.name}: family 'moe' needs a MoEConfig (cfg.moe)")
    if not ported or cfg.encoder or cfg.frontend:
        item = todo.get(cfg.family, "item 7, remaining families")
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP.md, Queue 1: {item})")


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
    d, np_ = cfg.d_model, n_periods(cfg)
    vp = padded_vocab(cfg)
    layers = []
    for kind, ffn in period_spec(cfg):
        lp = {"norm1": torch.zeros((np_, d), dtype=torch.float32, device=device)}
        if kind == "attn":
            lp["mixer"] = stacked_init(attn.attn_shapes(cfg), np_, dtype, gen, device)
        else:
            lp["mixer"] = ssm_mod.ssm_init(cfg, np_, dtype, gen, device)
        if ffn is not None:
            lp["norm2"] = torch.zeros((np_, d), dtype=torch.float32, device=device)
        if ffn == "moe":
            lp["ffn"] = moe_mod.moe_init(cfg, np_, dtype, gen, device)
        elif ffn == "dense":
            lp["ffn"] = stacked_init({"w_gate": ((d, cfg.d_ff), d), "w_up": ((d, cfg.d_ff), d),
                                      "w_down": ((cfg.d_ff, d), cfg.d_ff)},
                                     np_, dtype, gen, device)
        layers.append(lp)
    params = {
        "embed": dense_init((vp, d), dtype, gen, device, in_axis_size=d),
        "layers": layers,
        "final_norm": rms_norm_init(d, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init((d, vp), dtype, gen, device)
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
                    mask=None, prefix_len: int = 0):
    """One layer.  Returns (x, the MoE layer's aux loss, or None)."""
    kind, ffn = spec
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if kind == "attn":
        h = attn.attention(lp["mixer"], h, positions, cfg, causal=causal,
                           window=cfg.sliding_window, mask=mask, prefix_len=prefix_len)
    else:
        h = ssm_mod.ssm_apply(lp["mixer"], h, cfg)
    x = x + h
    aux = None
    if ffn is not None:
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        if ffn == "moe":
            h, aux = moe_mod.moe_apply(lp["ffn"], h, cfg)
        else:
            h = mlp_apply(lp["ffn"], h, cfg.mlp_act)
        x = x + h
    return x, aux


def stack_apply(layers, x, positions, cfg: ModelConfig, *, causal: bool = True,
                mask=None, prefix_len: int = 0, layer_param_fn: ParamFn = None):
    """Run the period stack over x [B,S,D].  Returns (x, the sum of the MoE
    layers' aux losses over periods and positions).

    ``layer_param_fn`` maps one period's parameters (a list over the period's
    positions) to the ones the layers use, inside the period's body.
    ``cfg.remat``: "none" keeps every activation for the backward; "full"
    keeps each period's input only and runs the body again in the backward.
    """
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"remat {cfg.remat!r} is not ported yet (ROADMAP.md, "
                                  "Queue 1: training, remat='dots')")
    specs = period_spec(cfg)

    def body(h, per_params):
        pp = layer_param_fn(per_params) if layer_param_fn else per_params
        auxs = []
        for pos, spec in enumerate(specs):
            h, a = _apply_sublayer(pp[pos], h, positions, cfg, spec, causal=causal, mask=mask,
                                   prefix_len=prefix_len)
            if a is not None:
                auxs.append(a)
        return h, auxs

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(n_periods(cfg)):
        per = [_period(lp, p) for lp in layers]
        if cfg.remat == "full" and torch.is_grad_enabled():
            x, auxs = checkpoint(body, x, per, use_reentrant=False)
        else:
            x, auxs = body(x, per)
        for a in auxs:
            total = total + a
    return x, total


def unembed(params, x, cfg: ModelConfig):
    """Logits of final hidden states x [..., D] -> [..., padded vocab]."""
    if cfg.tie_embeddings:
        return torch.einsum("...d,vd->...v", x, params["embed"])
    return torch.einsum("...d,dv->...v", x, params["unembed"])


def lm_forward(params, batch, cfg: ModelConfig, *, last_only: bool = False,
               hidden: bool = False, layer_param_fn: ParamFn = None):
    """Teacher-forced forward.  Returns (logits, moe_aux) like the JAX package.

    batch: {"tokens" [B,S]}.  last_only: logits of the final position only.
    hidden: the final (normed) hidden states [B,S,D] in place of the logits,
    for a caller that applies ``unembed`` to a few positions at a time.
    layer_param_fn: see ``stack_apply``.
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = stack_apply(params["layers"], x, positions, cfg, causal=True,
                         layer_param_fn=layer_param_fn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    out = x if hidden else unembed(params, x, cfg)
    return out, aux


def lm_loss(params, batch, cfg: ModelConfig, *, layer_param_fn: ParamFn = None,
            aux_weight: float = 0.01):
    """(loss, {"ce", "moe_aux"}) for a teacher-forced batch with "targets"."""
    logits, aux = lm_forward(params, batch, cfg, layer_param_fn=layer_param_fn)
    loss, ce = cross_entropy(logits, batch["targets"], cfg.vocab_size)
    return loss + aux_weight * aux, {"ce": ce, "moe_aux": aux}


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int, device="cuda"):
    """Per-period-position caches, leaves stacked [n_periods, ...].

    An attention position keeps a KV cache; a sliding-window architecture a
    ring cache of ``min(capacity, sliding_window)`` slots.  A Mamba position
    keeps its conv window and SSM state, whatever the capacity.
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
            one = attn.init_kv_cache(cfg, batch, cap, dtype, device)
        else:
            one = ssm_mod.init_ssm_cache(cfg, batch, device)
        caches.append({k: v[None].repeat((np_,) + (1,) * v.dim()) for k, v in one.items()})
    return caches


def decode_step(params, state, token, pos: int, cfg: ModelConfig):
    """One decode step.  token [B,1] integer, pos the absolute position (int).

    ``state`` is updated in place and returned.  Returns (logits [B,1,V], state).
    """
    _check_family(cfg)
    x = params["embed"][token]
    specs = period_spec(cfg)
    for p in range(n_periods(cfg)):
        for i, (kind, ffn) in enumerate(specs):
            lp = _period(params["layers"][i], p)
            z = rms_norm(x, lp["norm1"], cfg.norm_eps)
            if kind == "attn":
                z, _ = attn.decode_attention(lp["mixer"], z, pos, _period(state[i], p), cfg,
                                             window=cfg.sliding_window)
            else:
                z, _ = ssm_mod.ssm_decode(lp["mixer"], z, _period(state[i], p), cfg)
            x = x + z
            if ffn is not None:
                z = rms_norm(x, lp["norm2"], cfg.norm_eps)
                if ffn == "moe":  # B groups of one token; the aux loss is not used
                    z, _ = moe_mod.moe_apply(lp["ffn"], z, cfg)
                else:
                    z = mlp_apply(lp["ffn"], z, cfg.mlp_act)
                x = x + z
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg), state


def prefill(params, batch, cfg: ModelConfig, capacity: int):
    """Last-token logits of the whole prompt (the caches are built by decode)."""
    return lm_forward(params, batch, cfg, last_only=True)
