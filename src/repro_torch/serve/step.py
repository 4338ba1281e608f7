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

Weight-resident decode (``weight_resident``, the reference's GSPMD
weight-resident step): the same parameters and caches, but no weight
crosses the rails.  Each matrix leaf stays on its stored shard and each
product reduces or gathers an activation over the rails instead
(``parallel.resident``); the step takes the whole batch's token, runs the
products on every row, each mixer on this rank's cache rows, and returns
this rank's rows' logits, as the gathered step does.  Prefill ignores the
flag, as the reference's does.

``mesh``: a ``torch.distributed`` ``DeviceMesh`` with dims (data, model) or
(pod, data, model), as ``launch.train.make_mesh`` builds it, or the tuple
(1, 1): one device, no process group.  Where the rails have one rank the
resident step runs its products over the one shard and is bit-equal to the
gathered step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.fabric import Fabric
from repro_torch.models import transformer as tf
from repro_torch.parallel import resident
from repro_torch.parallel.tensor import ModelAxis
from repro_torch.train import step as st
from repro_torch.tree import tree_map

#: the top-level leaves a decode step reads (the rest serve prefill)
_DECODE_TOP = ("embed", "unembed", "final_norm")


@dataclass(frozen=True)
class ServeSetup:
    cfg: ModelConfig
    fabric: str = "photonic"  # "photonic" | "eps"
    # batch >= n_dp: batch-shard the cache; else context-shard it (long_500k)
    context_shard: bool = False
    # weight-resident decode: weights kept sharded in place, activation
    # partials reduced (or slices gathered) over the rails
    weight_resident: bool = False


class _Layout:
    """The rails' ``Fabric``, the model axis (None where it has one rank)
    and the FSDP dims of the global template (None where nothing is
    gathered or kept resident) of a setup on a mesh."""

    def __init__(self, setup: ServeSetup, mesh, params_tpl=None):
        if setup.fabric not in ("photonic", "eps"):
            raise ValueError(f"fabric {setup.fabric!r}: photonic or eps")
        self.fd_top = self.fd_stacks = None
        if isinstance(mesh, tuple):
            if math.prod(mesh) != 1:
                raise ValueError(f"mesh {mesh}: a tuple is one device, (1, 1); pass a "
                                 f"DeviceMesh of the processes (launch.train.make_mesh)")
            self.fab, self.tp = Fabric(("data",), (1,), setup.fabric), None
        else:
            self.fab = Fabric.from_mesh(mesh, st.dp_axes_of(mesh), setup.fabric)
            tp = ModelAxis.from_mesh(mesh)
            self.tp = tp if tp.active else None
        # one rail rank gathers nothing, but a resident step keeps its leaves
        # on their (whole) shards all the same
        if params_tpl is not None and (self.fab.n_shards > 1 or setup.weight_resident):
            fd_tree, _ = st.meta_trees(params_tpl, rails=self.fab.axes,
                                       n_rails=self.fab.n_shards,
                                       model_size=1 if self.tp is None else self.tp.size)
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
    tree of the GLOBAL parameters (real or on the meta device).  With
    ``setup.weight_resident``, the step of ``resident_decode_step`` over this
    rank's ``resident.Rails`` (one rank on (1, 1)), with the same signature
    and outputs; its ``rails`` counts the combines it ran."""
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
    if setup.weight_resident:
        rails = resident.Rails(lay.fab)
        rows = None if setup.context_shard else rails.rows()
        inner = resident_decode_step(cfg, rails, lay.fd_top, lay.fd_stacks, ctx=ctx, tp=lay.tp,
                                     rows=rows)

        def step(params, state, token, pos: int, cross=None):
            logits, state = inner(params, state, token, pos, cross)
            return (logits if rows is None else rows.local(logits)), state
        step.fabric, step.model, step.rails = lay.fab, lay.tp, rails
        return step

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


def resident_decode_step(cfg: ModelConfig, rails, fd_top, fd_stacks, *, ctx=None, tp=None,
                         rows=None):
    """decode(stored, state, token, pos, cross=None) -> (the whole batch's
    logits [B,1,V], state updated in place) with every matrix leaf resident
    on the rails (``parallel.resident``): ``rails`` a ``Rails``, then
    ``stored`` is this rank's shards, or another object with its methods
    (``ranks``, ``parts``, ``reduce``, ``join``, ``gather_leaf``); ``fd_top`` and
    ``fd_stacks`` the FSDP dims of ``st._split_stacks`` of the template at
    ``rails.n`` rails; ``token`` and ``cross`` the whole batch's.  ``ctx``,
    ``tp`` and ``rows`` go to ``tf.decode_step``."""
    @torch.no_grad()
    def step(stored, state, token, pos: int, cross=None):
        top = {k: stored[k] for k in _DECODE_TOP if k in stored}
        params = dict(resident.place(top, {k: fd_top[k] for k in top}, rails),
                      layers=stored["layers"])

        def gfn(period):
            return resident.place(period, fd_stacks["layers"], rails, dim_off=-1)
        return tf.decode_step(params, state, token, pos, cfg, cross_state=cross,
                              layer_param_fn=gfn, ctx=ctx, tp=tp, rows=rows)
    return step


def make_prefill_step(setup: ServeSetup, mesh, params_tpl):
    """prefill(params, batch) -> last-token logits [B_local,1,V] of this
    rank's rows of the global batch (forward only); the batch carries a
    VLM's "patches" or an encoder-decoder's "frames".  The gathered prefill
    whatever ``setup.weight_resident`` says."""
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
