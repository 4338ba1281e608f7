"""Mixture-of-experts FFN: shared + fine-grained routed experts, DeepSeek-MoE
style (port of ``repro.models.moe``).

Plain functions on tensors.  Tokens come grouped, x [G, T, D] (the model
passes its batch rows as groups; decode passes B groups of one token), and
each group has its own expert capacity.  The position of each routing choice
inside its expert's buffer comes from a stable argsort over expert ids
(GShard priority: flattened (T, K) order), so no [T, E, C] one-hot is
made; ``make_dispatch`` keeps that one-hot as a small-shape oracle for the
tests.  Tokens are scattered into an [E, C, D] buffer per group with
``index_add``, the experts run as batched products over E (cuBLAS, as the
JAX package leaves them to XLA), and the rows are gathered back and summed
over K in f32.

The router is a softmax over E in f32, top-k, with the gates renormalised
over the chosen experts; shared experts always run.  A Switch-style
load-balance loss is returned beside the output.

Expert parallelism (EP) on a model axis: the routed experts are sharded on
their expert dim and the router on its expert columns.  The tokens are
replicated over the axis, so the router's leaf is gathered and the routing
and its aux loss run on every rank as at one rank; each rank dispatches only
the choices routed to its E/M experts, and the partial combine leaves
through ``reduce``.  No all-to-all is needed (the JAX package's manual
``ep_axis`` all-to-all is on no model path).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import mlp_apply, stacked_init
from repro_torch.parallel import sharding as sh


def moe_capacity(moe: MoEConfig, tokens_per_group: int) -> int:
    """Per-group expert capacity, padded to a multiple of 4."""
    c = int(tokens_per_group * moe.top_k * moe.capacity_factor / moe.n_experts)
    c = max(c, moe.top_k)
    return (c + 3) // 4 * 4


def moe_init(cfg: ModelConfig, n_periods: int, dtype, gen: torch.Generator, device) -> dict:
    """Stacked leaves [n_periods, ...]: ``router`` [d, E] in f32 whatever
    ``dtype``, the routed experts [E, d, de] / [E, de, d] and, with shared
    experts, a gated MLP of width de * n_shared under ``shared``; each
    period's leaves are drawn in turn."""
    moe = cfg.moe
    d = cfg.d_model
    de = moe.d_expert if moe.d_expert is not None else cfg.d_ff
    e = moe.n_experts
    p = stacked_init({"router": ((d, e), d, torch.float32), "w_gate": ((e, d, de), d),
                      "w_up": ((e, d, de), d), "w_down": ((e, de, d), de)},
                     n_periods, dtype, gen, device)
    if moe.n_shared_experts:
        ds = de * moe.n_shared_experts
        p["shared"] = stacked_init({"w_gate": ((d, ds), d), "w_up": ((d, ds), d),
                                    "w_down": ((ds, d), ds)}, n_periods, dtype, gen, device)
    return p


def router_topk(logits, moe: MoEConfig, generator: Optional[torch.Generator] = None):
    """logits [G,T,E] -> (gates [G,T,K] renormalised, idx [G,T,K], probs [G,T,E]).

    The K choices come in order of descending probability.  Jitter is added
    to the logits only when a generator is passed (the model paths pass none).
    """
    if moe.router_jitter and generator is not None:
        logits = logits + moe.router_jitter * torch.randn(
            logits.shape, generator=generator, dtype=torch.float32, device=logits.device)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.topk(probs, moe.top_k, dim=-1, sorted=True)
    gates = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def choice_positions(idx, n_experts: int):
    """Position of each routing choice inside its expert's buffer.

    idx [G,T,K] -> pos [G,T,K]; choices are prioritised in flattened (T, K)
    order.  A stable argsort over expert ids per group, all groups at once.
    """
    g, t, k = idx.shape
    flat = idx.reshape(g, t * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_e = flat.gather(1, order)
    experts = torch.arange(n_experts, dtype=flat.dtype, device=flat.device)
    seg_start = torch.searchsorted(sorted_e, experts.expand(g, n_experts).contiguous(),
                                   side="left")
    ranks = torch.arange(t * k, device=flat.device)[None, :] - seg_start.gather(1, sorted_e)
    return torch.empty_like(flat).scatter_(1, order, ranks).reshape(g, t, k)


def make_dispatch(idx, gates, moe: MoEConfig, capacity: int):
    """Einsum one-hot dispatch/combine: the small-shape oracle for tests.

    idx [G,T,K], gates [G,T,K] -> dispatch, combine [G,T,E,C] (f32).
    """
    pos = choice_positions(idx, moe.n_experts)
    fits = (pos < capacity).to(torch.float32)
    onehot_e = F.one_hot(idx, moe.n_experts).to(torch.float32)
    onehot_c = F.one_hot(pos.clamp(max=capacity - 1), capacity).to(torch.float32) * fits[..., None]
    disp = torch.einsum("gtke,gtkc->gtec", onehot_e, onehot_c)
    comb = torch.einsum("gtk,gtke,gtkc->gtec", gates.to(torch.float32), onehot_e, onehot_c)
    return disp, comb


def load_balance_loss(probs, idx, moe: MoEConfig):
    """Switch-Transformer aux loss: E * sum_e f_e * P_e (1.0 when balanced).
    f averages the one-hot choices over (G, T, K), P the probabilities over (G, T)."""
    e = moe.n_experts
    f = F.one_hot(idx, e).to(torch.float32).mean(dim=(0, 1, 2))
    p = probs.mean(dim=(0, 1))
    return e * (f * p).sum()


def _expert_ffn(p, x, act: str):
    """x [E,C',D] through each expert's gated MLP."""
    g = torch.einsum("ecd,edf->ecf", x, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", x, p["w_up"])
    g = F.gelu(g, approximate="tanh") if act == "geglu" else F.silu(g)
    return torch.einsum("ecf,efd->ecd", g * u, p["w_down"])


def scatter_dispatch(x, idx, pos, fits, n_experts: int, capacity: int):
    """x [G,T,D], idx/pos/fits [G,T,K] -> buffers [G,E,C,D] in x's dtype.

    Each group's buffer has a scratch row past its E*C slots, where the
    choices that do not fit land; it is sliced off.  Every live slot
    receives exactly one row, so the add is exact in any dtype, and a
    dropped choice gets no gradient.
    """
    g, t, d = x.shape
    k = idx.shape[-1]
    rows = n_experts * capacity + 1
    slot = torch.where(fits, idx * capacity + pos, rows - 1).reshape(g, t * k)
    slot = slot + rows * torch.arange(g, device=x.device)[:, None]
    src = x.repeat_interleave(k, dim=1).reshape(g * t * k, d)
    buf = torch.zeros((g * rows, d), dtype=x.dtype, device=x.device).index_add(
        0, slot.reshape(-1), src)
    return buf.reshape(g, rows, d)[:, :-1].reshape(g, n_experts, capacity, d)


def gather_combine(buf, idx, pos, fits, gates):
    """buf [G,E,C,D], idx/pos/fits/gates [G,T,K] -> y [G,T,D] in f32.

    The rows are gathered in the buffer's dtype; the weights gates * fits and
    the sum over K are f32.  A dropped choice's slot is clamped into the
    buffer and weighted 0.
    """
    g, e, c, d = buf.shape
    t, k = idx.shape[1], idx.shape[2]
    slot = torch.clamp(idx * c + pos, max=e * c - 1).reshape(g, t * k)
    slot = slot + e * c * torch.arange(g, device=buf.device)[:, None]
    rows = buf.reshape(g * e * c, d).index_select(0, slot.reshape(-1))
    w = (gates * fits.to(gates.dtype)).reshape(g, t, k, 1).to(torch.float32)
    return (rows.reshape(g, t, k, d).to(torch.float32) * w).sum(2)


def expert_parallel(cfg: ModelConfig, tp) -> bool:
    """Whether the routed experts split over the model axis ``tp`` (EP)."""
    moe = cfg.moe
    de = moe.d_expert if moe.d_expert is not None else cfg.d_ff
    return sh.model_dim("ffn/w_gate", (moe.n_experts, cfg.d_model, de), tp) is not None


def moe_route(p, x, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None, tp=None):
    """The routing of x [G,T,D]: ((gates, idx, pos, fits) [G,T,K], aux loss).
    On a model axis it runs replicated, over the router's leaf gathered
    where it splits (``gather_leaf``: each rank's gradient of it is whole)."""
    moe = cfg.moe
    router = p["router"]
    if sh.model_dim("ffn/router", (cfg.d_model, moe.n_experts), tp) is not None:
        router = tp.gather_leaf(router, 1)
    logits = torch.einsum("gtd,de->gte", x.to(torch.float32), router.to(torch.float32))
    gates, idx, probs = router_topk(logits, moe, generator)
    aux = load_balance_loss(probs, idx, moe)
    pos = choice_positions(idx, moe.n_experts)
    return (gates, idx, pos, pos < moe_capacity(moe, x.shape[1])), aux


def moe_experts(p, x, route, cfg: ModelConfig, tp=None):
    """The routed experts' combine y [G,T,D] in f32 for the routing
    ``route``.  Under EP (``tp``) ``p`` holds this rank's E/M experts: the
    rank dispatches only the choices routed to them (the others do not fit
    here), x and the gates enter through ``copy`` and y is partial."""
    gates, idx, pos, fits = route
    g, t, d = x.shape
    n_local, capacity = cfg.moe.n_experts, moe_capacity(cfg.moe, t)
    if tp is not None:
        lo, hi = tp.block(n_local)
        n_local, x, gates = hi - lo, tp.copy(x), tp.copy(gates)
        fits = fits & (idx >= lo) & (idx < hi)
        idx = (idx - lo).clamp(0, n_local - 1)
    buf = scatter_dispatch(x, idx, pos, fits, n_local, capacity)
    ebuf = buf.transpose(0, 1).reshape(n_local, g * capacity, d)
    h = _expert_ffn(p, ebuf, cfg.mlp_act)
    h = h.reshape(n_local, g, capacity, d).transpose(0, 1)  # [G,E,C,D]
    return gather_combine(h, idx, pos, fits, gates)


def moe_apply(p, x, cfg: ModelConfig, *,
              generator: Optional[torch.Generator] = None,
              tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN.  x [G,T,D] grouped tokens -> (y [G,T,D], aux loss, a scalar).

    tp: the model axis; ``p`` then holds this rank's shards of the leaves.
    """
    moe = cfg.moe
    route, aux = moe_route(p, x, cfg, generator=generator, tp=tp)
    if expert_parallel(cfg, tp):
        y = tp.reduce(moe_experts(p, x, route, cfg, tp))
    else:
        y = moe_experts(p, x, route, cfg)
    y = y.to(x.dtype)
    if moe.n_shared_experts:
        de = moe.d_expert if moe.d_expert is not None else cfg.d_ff
        split = sh.model_dim("ffn/shared/w_gate", (cfg.d_model, de * moe.n_shared_experts),
                             tp) is not None
        y = y + mlp_apply(p["shared"], x, cfg.mlp_act, tp=tp if split else None)
    return y, aux
