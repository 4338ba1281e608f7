"""Serving steps on one device: last-token prefill and cached decode (port of
``repro.serve.step``).

The JAX package runs these on a photonic mesh, gathering each period's
weights over the rails (or sharding the cache along the sequence).  This
slice runs one device, a 1x1 mesh; the rail-sharded variants raise until
the fabric slice lands.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf

_FABRIC_ITEM = "ROADMAP.md, Queue 1: fabric and rail-sharded serving"


@dataclass(frozen=True)
class ServeSetup:
    cfg: ModelConfig
    # batch >= n_dp: batch-shard the cache; else context-shard it (long_500k)
    context_shard: bool = False


def _check_one_device(setup: ServeSetup, mesh: Optional[Tuple[int, ...]]) -> None:
    if mesh is not None and math.prod(mesh) != 1:
        raise NotImplementedError(f"mesh {'x'.join(map(str, mesh))}: rail-sharded serving "
                                  f"is not ported yet ({_FABRIC_ITEM}); use a 1x1 mesh")
    if setup.context_shard:
        raise NotImplementedError(f"context-sharded decode is not ported yet ({_FABRIC_ITEM})")


def init_serve_state(setup: ServeSetup, mesh, params, batch: int, capacity: int):
    """Decode caches on the parameters' device."""
    _check_one_device(setup, mesh)
    return tf.init_decode_state(setup.cfg, batch, capacity, device=params["embed"].device)


def make_decode_step(setup: ServeSetup, mesh, params_tpl, *, batch: int, capacity: int):
    """decode(params, state, token, pos, cross=None) -> (logits [B,1,V], state
    updated in place); an encoder-decoder passes ``cross``, the
    ``tf.init_cross_state`` of its encoded frames."""
    _check_one_device(setup, mesh)
    cfg = setup.cfg

    def step(params, state, token, pos: int, cross=None):
        return tf.decode_step(params, state, token, pos, cfg, cross_state=cross)

    return step


def make_prefill_step(setup: ServeSetup, mesh, params_tpl):
    """prefill(params, batch) -> last-token logits [B,1,V] (forward only); the
    batch carries a VLM's "patches" or an encoder-decoder's "frames"."""
    _check_one_device(setup, mesh)
    cfg = setup.cfg

    def step(params, batch):
        logits, _ = tf.lm_forward(params, batch, cfg, last_only=True)
        return logits

    return step
