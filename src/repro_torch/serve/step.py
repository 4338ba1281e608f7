"""Serving steps: last-token prefill and cached decode over the photonic rails
(port of ``repro.serve.step``).

Decode carries no rail data traffic for a dense model: the batch is
rail-local and the model axis is the scale-up domain.  Prefill runs the
per-period FSDP AllGather rings.  Long context at a small batch shards each
attention cache along its slots over the rails and merges the shards'
flash-decode stats there (small per-head scalars: management traffic).

Parameters are stored as ``train.step`` stores them (``init_serve_params``,
or the parameters of ``train.step.init_sharded_state``): FSDP over the rails
(the mesh's data-parallel axes, ("pod", "data") or ("data",)) and TP on
"model".  Each step gathers the top-level leaves once a call and each
period's layer leaves inside the period's body (``layer_param_fn``), over a
``Fabric`` of the rails: "photonic" rings or "eps" native collectives.  A
step takes the GLOBAL batch or tokens, serves this rank's rows of them and
returns their logits (whole, over the vocab; the ranks of one model group
hold the same rows).

Caches (``init_serve_state``).  Batch-sharded: rows B / n_dp of every cache,
a batch the rails do not divide raises.  Context-sharded
(``context_shard``): the whole batch, cap / n_dp contiguous slots of every
attention cache, where cap is the cache's own slot count (min(capacity,
window)), and the SSM caches whole (replicated over the rails).  On a model
axis each rank's caches hold only the kv heads its query heads read and the
conv channels and SSD heads of its share; the JAX package's cache specs
name the rail axes only, so GSPMD keeps them whole over "model" there.

``mesh``: a ``torch.distributed`` ``DeviceMesh`` with dims (data, model) or
(pod, data, model), as ``launch.train.make_mesh`` builds it, or the tuple
(1, 1): one device, no process group.  ``weight_resident`` (the reference's
GSPMD weight-resident decode) is refused until ROADMAP Queue 1 item 2b.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.fabric import Fabric
from repro_torch.models import transformer as tf
from repro_torch.parallel.tensor import ModelAxis
from repro_torch.train import step as st
from repro_torch.tree import tree_map

_RESIDENT_ITEM = "ROADMAP.md, Queue 1 item 2b: weight-resident decode"


@dataclass(frozen=True)
class ServeSetup:
    cfg: ModelConfig
    fabric: str = "photonic"  # "photonic" | "eps"
    # batch >= n_dp: batch-shard the cache; else context-shard it (long_500k)
    context_shard: bool = False
    # weights kept sharded in place, activation partials reduced over the
    # rails (the reference's GSPMD fallback): not ported
    weight_resident: bool = False


class _Layout:
    """The rails' ``Fabric``, the model axis (None where it has one rank)
    and the FSDP dims of the global template (None where nothing is
    gathered) of a setup on a mesh."""

    def __init__(self, setup: ServeSetup, mesh, params_tpl=None):
        if setup.weight_resident:
            raise NotImplementedError(f"weight-resident decode is not ported ({_RESIDENT_ITEM})")
        if setup.fabric not in ("photonic", "eps"):
            raise ValueError(f"fabric {setup.fabric!r}: photonic or eps")
        self.fd_top = self.fd_stacks = None
        if isinstance(mesh, tuple):
            if math.prod(mesh) != 1:
                raise ValueError(f"mesh {mesh}: a tuple is one device, (1, 1); pass a "
                                 f"DeviceMesh of the processes (launch.train.make_mesh)")
            self.fab, self.tp = Fabric(("data",), (1,), setup.fabric), None
            return
        self.fab = Fabric.from_mesh(mesh, st.dp_axes_of(mesh), setup.fabric)
        tp = ModelAxis.from_mesh(mesh)
        self.tp = tp if tp.active else None
        if self.fab.n_shards > 1 and params_tpl is not None:
            fd_tree, _ = st.meta_trees(params_tpl, rails=self.fab.axes,
                                       n_rails=self.fab.n_shards,
                                       model_size=st.model_size_of(mesh))
            self.fd_top, self.fd_stacks = st._split_stacks(fd_tree)

    @property
    def n(self) -> int:
        return self.fab.n_shards

    def rows(self, x):
        """This rank's rows of a global batch-major tensor."""
        b = x.shape[0]
        if b % self.n:
            raise ValueError(f"batch {b} does not split over {self.n} rails")
        bl, i = b // self.n, self.fab.axis_index()
        return x[i * bl:(i + 1) * bl]

    def gathered(self, params):
        """(the parameters with their top-level leaves gathered, the hook
        of the decoder's stack, the hook of an encoder's)."""
        if self.fd_top is None:
            return params, None, None
        top, stacks = st._split_stacks(params)
        out = dict(st._gather_with_meta(top, self.fd_top, self.fab), layers=stacks["layers"])
        fab, fds = self.fab, self.fd_stacks

        def gfn(period):
            return st._gather_with_meta(period, fds["layers"], fab, dim_off=-1)
        gfn_enc = None
        if "encoder" in stacks:
            out["encoder"] = dict(out["encoder"], layers=stacks["encoder"])

            def gfn_enc(period):
                return st._gather_with_meta(period, fds["encoder"], fab, dim_off=-1)
        return out, gfn, gfn_enc


def init_serve_params(setup: ServeSetup, mesh, *, seed: int = 0, device="cuda"):
    """This rank's stored shards of ``init_lm(cfg, seed)`` (the parameters
    of ``train.step.init_sharded_state``, without the optimizer's state)."""
    lay = _Layout(setup, mesh)
    if isinstance(mesh, tuple):
        return tf.init_lm(setup.cfg, seed=seed, device=device)
    return st.init_sharded_params(setup.cfg, mesh, lay.fab, seed=seed, device=device)


def init_serve_state(setup: ServeSetup, mesh, params, batch: int, capacity: int):
    """This rank's decode caches (see the module's docstring), on the
    parameters' device; ``batch`` is the global batch."""
    lay = _Layout(setup, mesh)
    device = params["embed"].device
    if setup.context_shard:
        return tf.init_decode_state(setup.cfg, batch, capacity, device, tp=lay.tp,
                                    context_shards=lay.n)
    if batch % lay.n:
        raise ValueError(f"batch {batch} does not split over {lay.n} rails")
    return tf.init_decode_state(setup.cfg, batch // lay.n, capacity, device, tp=lay.tp)


def make_decode_step(setup: ServeSetup, mesh, params_tpl, *, batch: int, capacity: int):
    """decode(params, state, token, pos, cross=None) -> (logits [B_local,1,V],
    state updated in place): ``token`` [B,1] is the global batch's (each
    rank decodes its rows; context-sharded, all of them), ``params`` the
    stored shards, ``state`` this rank's ``init_serve_state``; an
    encoder-decoder passes ``cross``, the ``tf.init_cross_state`` of its
    encoded frames over the whole batch and every head.  ``params_tpl`` is a
    tree of the GLOBAL parameters (real or on the meta device)."""
    cfg = setup.cfg
    lay = _Layout(setup, mesh, params_tpl)
    ctx = None
    if setup.context_shard:
        cap = capacity if cfg.sliding_window is None else min(capacity, cfg.sliding_window)
        if cap % lay.n:
            raise ValueError(f"{cap} cache slots do not split over {lay.n} rails")
        ctx = {"fabric": lay.fab, "index": lay.fab.axis_index()}
    elif batch % lay.n:
        raise ValueError(f"batch {batch} does not split over {lay.n} rails")

    @torch.no_grad()
    def step(params, state, token, pos: int, cross=None):
        if not setup.context_shard:
            token = lay.rows(token)
            if cross is not None:  # [n_periods, B, Sk, KV, dh]
                cross = tree_map(lambda t: lay.rows(t.transpose(0, 1)).transpose(0, 1), cross)
        p, gfn, _ = lay.gathered(params)
        return tf.decode_step(p, state, token, pos, cfg, cross_state=cross,
                              layer_param_fn=gfn, ctx=ctx, tp=lay.tp)

    step.fabric, step.model = lay.fab, lay.tp
    return step


def make_prefill_step(setup: ServeSetup, mesh, params_tpl):
    """prefill(params, batch) -> last-token logits [B_local,1,V] of this
    rank's rows of the global batch (forward only); the batch carries a
    VLM's "patches" or an encoder-decoder's "frames"."""
    cfg = setup.cfg
    lay = _Layout(setup, mesh, params_tpl)
    vtp = tf.vocab_axis(cfg, lay.tp)

    @torch.no_grad()
    def step(params, batch):
        local = {k: lay.rows(v) for k, v in batch.items()}
        p, gfn, gfn_enc = lay.gathered(params)
        logits, _ = tf.lm_forward(p, local, cfg, last_only=True, layer_param_fn=gfn,
                                  layer_param_fn_enc=gfn_enc, tp=lay.tp)
        return logits if vtp is None else vtp.gather_last(logits)

    step.fabric, step.model = lay.fab, lay.tp
    return step
