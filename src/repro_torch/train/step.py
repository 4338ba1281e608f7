"""The FSDP train step over photonic rails (port of ``repro.train.step``).

Photonic mode (the paper's system): parameters are stored FSDP-sharded along
each leaf's rail-divisible dim over the rail axes ("pod", "data"); the
top-level leaves are ring-all-gathered once a step and each period's layer
leaves (of the decoder's stack and of an encoder's) just in time inside the
period's body (phase "DP AllGather").
Autograd through the gathers sends the gradients back over the ring
reduce-scatter (phase "DP ReduceScatter").  Scalars (loss, metrics, the
gradient norm) are management traffic: ``dist.all_reduce`` outside the
differentiated path.

EPS mode (electrical baseline): the same math with the native collectives.
On one device every collective is the identity, as in the JAX package.

Multi-pod: by default hierarchical FSDP over ("pod", "data").  ``hsdp=True``
shards over "data" only, replicates over "pod", and sums every gradient over
the pods after the data reduce-scatter: a ring AllReduce on a fabric of the
pod axis, or, with ``compress_pod_grads``, an int8 exchange with error
feedback (``compressed_pod_allreduce``).

Tensor and expert parallelism: a ``model`` dim of the mesh (the scale-up
domain, native collectives, never the rails) shards each leaf along its TP
dim as well (``parallel.sharding``), so after the rail gather a rank holds
its TP shard and the layers run Megatron-style over ``parallel.tensor``'s
conjugate functions.  The ranks of one model group take the same batch
slice and hold the same loss.

Each rank differentiates its LOCAL loss / n_dp: no collective other than the
gathers and the model axis's conjugates sits on the differentiated path, so
the cross-rank sum happens exactly once, in the reduce-scatter (and, under
HSDP, the pod sum).  Gradients of rail-replicated leaves (no rail-divisible
dim) are then ring-all-reduced.  All sharding metadata is derived once from
the GLOBAL parameter template, never from local shards.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.fabric import Fabric
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.tensor import ModelAxis
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update
from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class TrainSetup:
    cfg: ModelConfig
    fabric: str = "photonic"           # "photonic" | "eps"
    hsdp: bool = False                 # pod-replicated params + explicit AR
    compress_pod_grads: bool = False   # int8 + error feedback on pod AR
    accum: int = 1                     # gradient accumulation microbatches
    bidirectional_rings: bool = False  # both ring directions per gather (halves)
    opt: OptConfig = field(default_factory=OptConfig)


def mesh_axes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def rail_axes_of(mesh, hsdp: bool) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_axes(mesh) and not hsdp else ("data",)


def dp_axes_of(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def model_size_of(mesh) -> int:
    """The size of the mesh's ``model`` dim; 1 where it has none."""
    return mesh_axes(mesh).get(sh.MODEL_AXIS, 1)


def meta_trees(params_tpl, *, rails, n_rails: int, model_size: int):
    """(fd_tree, td_tree) of per-leaf FSDP/TP dims over the global template."""
    specs = sh._walk(params_tpl, lambda pstr, leaf, st: sh.leaf_spec(
        pstr, leaf.shape, n_rails=n_rails, rail_axes=rails, model_size=model_size,
        stacked=st))
    return tree_map(lambda s: s[1], specs), tree_map(lambda s: s[2], specs)


def _gather_with_meta(tree, fd_tree, fab: Fabric, *, dim_off: int = 0):
    """Ring-gather each sharded leaf; dim_off=-1 for a period's slices, whose
    leading stack dim is gone."""
    return tree_map(lambda leaf, fd: leaf if fd is None else fab.all_gather(leaf, fd + dim_off),
                    tree, fd_tree)


def _fixup_grads(grads, fd_tree, fab: Fabric):
    """Ring-AllReduce the gradients of rail-replicated leaves."""
    return tree_map(lambda g, fd: fab.all_reduce(g) if fd is None else g, grads, fd_tree)


def _psum(x: torch.Tensor, fab: Fabric) -> torch.Tensor:
    """Sum over every axis of ``fab``: management traffic, never differentiated."""
    for group, n in zip(fab.groups, fab.sizes):
        if n > 1:
            dist.all_reduce(x, group=group)
    return x


def fabric_of(setup: TrainSetup, mesh) -> Fabric:
    if setup.fabric not in ("photonic", "eps"):
        raise ValueError(f"fabric {setup.fabric!r}: photonic or eps")
    return Fabric.from_mesh(mesh, rail_axes_of(mesh, setup.hsdp), setup.fabric,
                            setup.bidirectional_rings)


@torch.no_grad()
def compressed_pod_allreduce(grads, ef, fab: Fabric, pod_fab: Fabric, model: ModelAxis = None):
    """int8 + error-feedback sum of the gradients over the pods (port of
    ``repro.train.step.compressed_pod_allreduce``); returns the summed
    gradients and updates ``ef`` in place.

    Each leaf: x = g + ef; one scale per leaf and pod from the largest |x|
    over the WHOLE leaf (the reference's data and model axes stay
    GSPMD-auto inside its pod-manual ``shard_map``, so its max spans the
    data and model shards: here an all-reduce MAX over ``fab`` and
    ``model``, one for every leaf at once); q = round(x /
    scale) in int8, half to even as ``jnp.round``; q and the scale
    ring-all-gathered over the pods and summed as q * scale; ef = x - q *
    scale.  The wire carries int8, 4x fewer bytes than f32.
    """
    for g, e in zip(leaves(grads), leaves(ef)):
        e.add_(g)  # x, in place of ef: no f32 copy of the gradients
    amax = fab.pmax(torch.stack([e.abs().max() for e in leaves(ef)]))
    if model is not None:
        amax = model.max(amax)
    out = []
    for x, a, g in zip(leaves(ef), amax, leaves(grads)):
        scale = torch.clamp(a, min=1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        x.sub_(q.float() * scale)
        qs = pod_fab.all_gather(q[None], 0)
        ss = pod_fab.all_gather(scale.reshape(1), 0)
        out.append((qs.float() * ss.reshape((-1,) + (1,) * g.dim())).sum(0).to(g.dtype))
    it = iter(out)
    return tree_map(lambda _: next(it), grads)


def gather_tree(tree, fd_tree, fab: Fabric, td_tree=None, model: ModelAxis = None):
    """Stored shards (parameters, gradients, optimizer moments) -> global
    tensors: over the rails, then over the model axis along each leaf's TP
    dim (``td_tree``)."""
    with torch.no_grad():
        tree = _gather_with_meta(tree, fd_tree, fab)
        if model is None or not model.active:
            return tree
        return tree_map(lambda t, td: t if td is None else model.gather(t, td), tree, td_tree)


def shard_tree(tree, fd_tree, td_tree, index: int, n: int, model: ModelAxis):
    """Global tensors -> this rank's shards (copies, so the globals can go):
    its block of each leaf's TP dim on the model axis and of its FSDP dim
    (rail index ``index`` of ``n``)."""
    def one(t, fd, td):
        out = t
        for dim, i, k in ((td, model.rank, model.size), (fd, index, n)):
            if dim is not None and k > 1:
                size = out.shape[dim] // k
                out = out.narrow(dim, i * size, size)
        return t if out is t else out.clone()
    return tree_map(one, tree, fd_tree, td_tree)


def split_periods(tree):
    """The tree with each stacked layer leaf (of ``layers`` and
    ``encoder/layers``) as a list of its periods' slices (views), which
    ``tf.stack_apply`` reads as the stack."""
    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key == "layers":
            return tree_map(lambda t: [t[p] for p in range(t.shape[0])], node)
        return node
    return walk(tree)


def period_leaves(stored):
    """Leaves for autograd that view ``stored``, one per period of each
    stacked layer leaf (``split_periods``): autograd through a slice of a
    stacked leaf would make a zero gradient of the whole stack for every
    period, O(depth²) bytes a backward."""
    return tree_map(lambda t: t.detach().requires_grad_(), split_periods(stored))


def autograd_leaves(stored, gbuf):
    """``period_leaves`` of the stored shards, each with ``.grad`` set to a
    view of the gradient buffers, so that the backward accumulates in place
    into them."""
    def leaf(x, g):
        x.grad = g
        return x
    return tree_map(leaf, period_leaves(stored), split_periods(gbuf))


def _split_stacks(tree):
    """(the tree without its layer stacks, {path: stack}): the stacks of the
    decoder (``layers``) and of an encoder (``encoder/layers``), which stay
    stored and are gathered one period at a time."""
    top = {k: v for k, v in tree.items() if k != "layers"}
    stacks = {"layers": tree["layers"]}
    if "encoder" in tree:
        top["encoder"] = {k: v for k, v in tree["encoder"].items() if k != "layers"}
        stacks["encoder"] = tree["encoder"]["layers"]
    return top, stacks


def make_train_step(setup: TrainSetup, mesh, params_tpl):
    """step(params, opt, ef, batch) -> (params, opt, ef, metrics), updating
    the stored shards and the optimizer state in place.

    ``mesh`` is a ``torch.distributed`` ``DeviceMesh`` with dims ("data",),
    ("pod", "data"), ("data", "model") or ("pod", "data", "model") (the
    order of ``init_device_mesh``); ``params_tpl`` a tree of the GLOBAL
    parameters (real or on the meta device), which fixes the sharding
    metadata once.  The step takes the global batch and trains on this
    rank's slice of it (flat data-parallel index, major axis first; the
    ranks of one model group take the same slice).
    ``step.grads_fn(params, batch)`` returns the gradients of the stored
    shards and the metrics without the update.
    """
    cfg = setup.cfg
    fab = fabric_of(setup, mesh)
    tp = ModelAxis.from_mesh(mesh)
    # every data-parallel axis: the batch slice and the loss's sum span them
    dp_fab = Fabric.from_mesh(mesh, dp_axes_of(mesh), setup.fabric)
    pod_fab = Fabric.from_mesh(mesh, ("pod",), setup.fabric) \
        if setup.hsdp and "pod" in mesh_axes(mesh) else None
    n_dp = dp_fab.n_shards
    fd_tree, td_tree = meta_trees(params_tpl, rails=fab.axes, n_rails=fab.n_shards,
                                  model_size=model_size_of(mesh))
    fd_top, fd_stacks = _split_stacks(fd_tree)

    def gfn(period_params):
        return _gather_with_meta(period_params, fd_stacks["layers"], fab, dim_off=-1)

    def gfn_enc(period_params):
        return _gather_with_meta(period_params, fd_stacks["encoder"], fab, dim_off=-1)

    def loss_fn(work, batch):
        top, stacks = _split_stacks(work)
        params = dict(_gather_with_meta(top, fd_top, fab), layers=stacks["layers"])
        if "encoder" in stacks:
            params["encoder"] = dict(params["encoder"], layers=stacks["encoder"])
        loss, m = tf.lm_loss(params, batch, cfg, layer_param_fn=gfn,
                             layer_param_fn_enc=gfn_enc if "encoder" in stacks else None,
                             tp=tp if tp.active else None)
        return loss / n_dp, m

    def local_batch(batch):
        b = batch["tokens"].shape[0]
        if b % (n_dp * setup.accum):
            raise ValueError(f"global batch {b} is not a multiple of {n_dp} ranks x "
                             f"{setup.accum} microbatches")
        bl, i = b // n_dp, dp_fab.axis_index()
        return {k: v[i * bl:(i + 1) * bl] for k, v in batch.items()}

    def grads_fn(stored, batch):
        local = local_batch(batch)
        gbuf = tree_map(torch.zeros_like, stored)
        work = autograd_leaves(stored, gbuf)
        acc = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32), stored) \
            if setup.accum > 1 else None
        bm = local["tokens"].shape[0] // setup.accum
        loss = torch.zeros((), dtype=torch.float32, device=local["tokens"].device)
        for i in range(setup.accum):
            l, m = loss_fn(work, {k: v[i * bm:(i + 1) * bm] for k, v in local.items()})
            l.backward()
            loss += l.detach().float()
            if acc is not None:
                for a, g in zip(leaves(acc), leaves(gbuf)):
                    a += g
                    g.zero_()
        grads = gbuf if acc is None else tree_map(lambda a: a / setup.accum, acc)
        grads = _fixup_grads(grads, fd_tree, fab)
        # metrics: the last microbatch's ce, as the JAX package reports it
        stats = _psum(torch.stack([loss / setup.accum, m["ce"].detach().float()]), dp_fab)
        return grads, {"loss": stats[0], "ce": stats[1] / n_dp, "moe_aux": m["moe_aux"].detach()}

    def pod_sync(grads, ef):
        """(grads summed over the pods, ef): the identity unless HSDP runs
        over a pod axis; ``ef`` is updated in place when compressing."""
        if pod_fab is None:
            return grads, ef
        if setup.compress_pod_grads:
            return compressed_pod_allreduce(grads, ef, fab, pod_fab, tp), ef
        return tree_map(pod_fab.all_reduce, grads), ef

    def global_norm(grads):
        """Squares of the sharded leaves summed over the rails, of the
        replicated ones counted once (after the pod sync, so pods agree);
        on a model axis, of the model-sharded leaves summed over it too."""
        # (squares, rail-sharded, model-sharded) of each leaf, paired by key
        parts = leaves(tree_map(lambda g, fd, td: (g.float().square().sum(), fd is not None,
                                                   td is not None and tp.active),
                                grads, fd_tree, td_tree))
        zero = torch.zeros((), dtype=torch.float32, device=parts[0][0].device)

        def total(rails: bool, model: bool):
            return sum((q for q, r, m in parts if r == rails and m == model), zero)
        if not tp.active:
            return torch.sqrt(_psum(total(True, False), fab) + total(False, False))
        both, model_only = tp.reduce(torch.stack([total(True, True),
                                                  total(False, True)])).unbind()
        return torch.sqrt(_psum(both + total(True, False), fab) + model_only
                          + total(False, False))

    def step(params, opt, ef, batch):
        grads, metrics = grads_fn(params, batch)
        grads, ef = pod_sync(grads, ef)
        params, opt, om = adamw_update(params, grads, opt, setup.opt, gnorm=global_norm(grads))
        return params, opt, ef, {**metrics, **om}

    step.grads_fn = grads_fn
    step.pod_sync = pod_sync
    step.fabric = fab
    step.fd_tree = fd_tree
    step.td_tree = td_tree
    step.model = tp
    return step


def init_sharded_state(setup: TrainSetup, mesh, *, seed: int = 0, device="cuda"):
    """(params, opt, ef): this rank's shards of ``init_lm(cfg, seed)``, f32
    AdamW moments of the same shapes, and the error-feedback state: f32
    zeros of the same shapes under HSDP with compression, else ``{}``."""
    params = init_sharded_params(setup.cfg, mesh, fabric_of(setup, mesh), seed=seed,
                                 device=device)
    return params, adamw_init(params), ef_init(setup, params)


def init_sharded_params(cfg: ModelConfig, mesh, fab: Fabric, *, seed: int = 0, device="cuda"):
    """This rank's shards of ``init_lm(cfg, seed)``: FSDP over the rails of
    ``fab``, TP on the mesh's model axis."""
    params = tf.init_lm(cfg, seed=seed, device=device)
    fd_tree, td_tree = meta_trees(params, rails=fab.axes, n_rails=fab.n_shards,
                                  model_size=model_size_of(mesh))
    return shard_tree(params, fd_tree, td_tree, fab.axis_index(), fab.n_shards,
                      ModelAxis.from_mesh(mesh))


def ef_init(setup: TrainSetup, params):
    """Zero error feedback shaped like the stored shards, where it is kept."""
    if not (setup.hsdp and setup.compress_pod_grads):
        return {}
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
