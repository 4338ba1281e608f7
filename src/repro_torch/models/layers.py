"""Core layers: norms, RoPE, gated MLPs, initialisers (port of ``repro.models.layers``).

Plain functions on tensors; parameters are plain dicts of tensors with the
JAX package's (in_dim, ..., out_dim) layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dense_init(shape, dtype, generator: torch.Generator, device, in_axis_size=None,
               out: torch.Tensor = None):
    """LeCun-normal init drawn in f32 on ``generator``, then cast to ``dtype``.

    ``out`` receives the cast values in place (a slice of a stacked leaf), so
    only one f32 draw of ``shape`` is alive at a time.
    """
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / max(fan_in, 1) ** 0.5
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    x.mul_(std)
    if out is None:
        return x.to(dtype)
    out.copy_(x)
    return out


def stacked_init(shapes: dict, n_periods: int, dtype, generator: torch.Generator,
                 device) -> dict:
    """Stacked leaves [n_periods, ...] of ``{name: (shape, fan_in)}``, in
    ``dtype``, or of ``{name: (shape, fan_in, leaf_dtype)}``; each leaf is
    drawn one period at a time."""
    out = {}
    for name, (shape, fan_in, *dt) in shapes.items():
        leaf_dtype = dt[0] if dt else dtype
        leaf = torch.empty((n_periods,) + shape, dtype=leaf_dtype, device=device)
        for p in range(n_periods):
            dense_init(shape, leaf_dtype, generator, device, in_axis_size=fan_in, out=leaf[p])
        out[name] = leaf
    return out


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256 so it shards over any mesh axis."""
    return ((cfg.vocab_size + 255) // 256) * 256


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(torch.float32))).to(dt)


def rms_norm_init(d, device="cuda"):
    # zero-centred scale (gemma-style "1 + w")
    return torch.zeros((d,), dtype=torch.float32, device=device)


def rope_apply(x, positions, theta: float):
    """Half-split rotary embedding with f32 angles.

    x: [..., S, H, dh]  positions: broadcastable to [..., S] (integer)
    """
    dh = x.shape[-1]
    half = dh // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions.to(torch.float32)[..., None] * freq  # [..., S, half]
    sin = torch.sin(ang)[..., None, :]  # [..., S, 1, half]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1, r2, x[..., 2 * half:].to(r1.dtype)], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p, x, act: str = "swiglu", tp=None):
    """Gated MLP: SwiGLU, or GeGLU with the tanh GELU.

    With a model axis ``tp``, ``p`` holds this rank's d_ff shard (w_gate and
    w_up column-parallel, w_down row-parallel): x enters through ``copy``
    and the partial output leaves through ``reduce``.
    """
    if tp is not None:
        return tp.reduce(mlp_apply(p, tp.copy(x), act))
    g = torch.einsum("...d,df->...f", x, p["w_gate"])
    u = torch.einsum("...d,df->...f", x, p["w_up"])
    if act == "geglu":
        g = F.gelu(g, approximate="tanh")
    else:
        g = F.silu(g)
    return torch.einsum("...f,fd->...d", g * u, p["w_down"])


def cross_entropy(logits, targets, vocab_size: int, z_loss: float = 1e-4, tp=None):
    """Token CE with padded-vocab masking and z-loss, in f32.  logits [..., Vp].

    Returns (mean of ce + z_loss * lse^2, mean ce), as the JAX package does.
    With a model axis ``tp`` the logits are this rank's vocab slice
    (``vocab_parallel_cross_entropy``).
    """
    if tp is not None:
        return vocab_parallel_cross_entropy(logits, targets, vocab_size, z_loss, tp)
    lg = logits.to(torch.float32)
    vp = lg.shape[-1]
    if vp > vocab_size:
        neg = torch.zeros((vp,), dtype=torch.float32, device=lg.device)
        neg[vocab_size:] = -1e9
        lg = lg + neg
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, targets[..., None].long()).squeeze(-1)
    ce = lse - gold
    return (ce + z_loss * lse.square()).mean(), ce.mean()


def vocab_parallel_cross_entropy(logits, targets, vocab_size: int, z_loss: float, tp):
    """``cross_entropy`` over logits [..., Vp / M] of this rank's vocab slice
    (rows ``tp.block(Vp)``): the max (outside the gradient), the sum of
    exps and the target's logit are summed over the model axis, whose ranks
    then hold the same loss.  The padded-vocab mask sits at each rank's
    offset.  Each rank's logits get their own slice of the gradient, so the
    sums leave through ``reduce``."""
    lg = logits.to(torch.float32)
    vl = lg.shape[-1]
    lo, hi = tp.block(vl * tp.size)
    if hi > vocab_size:
        neg = torch.zeros((vl,), dtype=torch.float32, device=lg.device)
        neg[max(vocab_size - lo, 0):] = -1e9
        lg = lg + neg
    m = tp.max(lg.detach().amax(-1))
    lse = torch.log(tp.reduce(torch.exp(lg - m[..., None]).sum(-1))) + m
    t = targets.long() - lo
    mine = (t >= 0) & (t < vl)
    gold = lg.gather(-1, t.clamp(0, vl - 1)[..., None]).squeeze(-1)
    gold = tp.reduce(torch.where(mine, gold, torch.zeros_like(gold)))
    ce = lse - gold
    return (ce + z_loss * lse.square()).mean(), ce.mean()
