"""AdamW with global-norm clipping (port of ``repro.train.optimizer``).

The state mirrors the stored parameter leaves (f32 ``m`` and ``v``), so under
FSDP each rank updates its own shards and the step needs no collective but
the scalar global norm.  The update runs in place, leaf by leaf and in
slices of at most ``_SLICE`` elements along the leading dim, so its f32
temporaries stay small (h2o-danube-3-4b's stacked w_gate [24, 3840, 10240]
alone is 3.8 GB in f32).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.tree import leaves, tree_map

_SLICE = 1 << 26  # elements of one slice of the update


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": 0}


def lr_at(cfg: OptConfig, step: int) -> float:
    return cfg.lr * min(step / max(cfg.warmup_steps, 1), 1.0)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (one device's view)."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))


def _slices(t: torch.Tensor):
    if t.dim() == 0 or t.numel() <= _SLICE:
        return [t]
    rows = max(1, _SLICE // (t.numel() // t.shape[0]))
    return list(t.split(rows))


@torch.no_grad()
def adamw_update(params, grads, opt, cfg: OptConfig, gnorm: Optional[torch.Tensor] = None):
    """Update ``params`` and ``opt`` in place; returns (params, opt, metrics).

    ``gnorm`` is the global gradient norm; by default this device's
    ``global_norm(grads)``, which is the global one only where the leaves are
    whole (a sharded caller passes its own).  Decay applies to leaves of two
    dims or more, stacked ones included, as in the JAX package.
    """
    step = opt["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt["m"]), leaves(opt["v"])):
        decay = p.dim() >= 2
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            g32 = gs.float() * scale
            ms.mul_(cfg.b1).add_((1.0 - cfg.b1) * g32)
            vs.mul_(cfg.b2).add_((1.0 - cfg.b2) * g32.square())
            delta = (ms / b1c) / (torch.sqrt(vs / b2c) + cfg.eps)
            if decay:
                delta += cfg.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * delta)
    opt["step"] = step
    return params, opt, {"grad_norm": gnorm, "lr": lr}
