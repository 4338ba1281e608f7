"""GPipe pipeline parallelism over a rail axis (port of
``repro.parallel.pipeline``).

The paper's PP traffic is point-to-point activation Send/Recv between
adjacent stages: on photonic rails a one-hop circuit, ``Fabric.shift`` with
the +1 ring permutation.  Stages are the ranks of a ``pipe`` group, each
owning ``n_periods / n_stages`` periods of the layer stack; microbatches
stream through ``n_micro + n_stages - 1`` ticks.  At tick t, stage s runs
microbatch t - s, while it lies in 0..n_micro - 1.

The JAX package computes every stage's embedding, layers and logits at
every tick and keeps what ``jnp.where`` selects; here only the work it keeps
runs.  Every rank takes part in the shift at every tick (the send/recv pairs
must match), and the ring's wrap from the last stage to stage 0 is carried
and ignored, as in the JAX package.

The train step runs its backward as an explicit schedule: the forward's
ticks reversed, the cotangent of each stage's input crossing to the previous
stage by ``shift(g, -1)``, then ``torch.autograd.backward`` on that stage's
saved output for its microbatch.  (An autograd function around the shift
would not do: autograd reaches only nodes with a path to a rank's own loss,
and stage 0 has none, so its shifts would never post their receives.)  The
gradient is that of ``lm_loss(aux_weight=0)`` over the whole batch; the JAX
package's step returns ``n_stages`` times it (ROADMAP.md, Queue 3).

``pipe`` is what the schedule needs of the group: ``n_stages``, ``stages``
(the stage indices this process runs, in order), ``shift(xs, delta)`` and
``sum(xs)`` over lists with one tensor per local stage.  ``FabricPipe`` is a
rank's: one stage, the group's ``Fabric``.  ``LocalPipe`` runs every stage
in one process in turn, a local hand-off in place of the wire.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.fabric import Fabric
from repro_torch.models import transformer as tf
from repro_torch.models.layers import cross_entropy, rms_norm
from repro_torch.train.step import autograd_leaves
from repro_torch.tree import leaves, tree_map


def _periods_a_stage(n_periods: int, n_stages: int, what: str) -> int:
    if n_periods % n_stages:
        raise ValueError(f"{what}: {n_periods} periods do not split into {n_stages} stages")
    return n_periods // n_stages


def stage_layers(cfg: ModelConfig, n_stages: int) -> int:
    """Periods a stage owns; refuses a split that leaves a remainder."""
    return _periods_a_stage(tf.n_periods(cfg), n_stages, cfg.name)


def stage_params(params, stage: int, n_stages: int):
    """Stage ``stage``'s parameters: rows ``stage*k:(stage+1)*k`` of each
    stacked ``layers`` leaf (views), the other leaves as they are (stage 0
    uses ``embed``, the last stage ``final_norm`` and ``unembed``)."""
    k = _periods_a_stage(leaves(params["layers"])[0].shape[0], n_stages, "params")
    return {**params, "layers": tree_map(lambda t: t[stage * k:(stage + 1) * k],
                                         params["layers"])}


class FabricPipe:
    """A rank's view of a pipe group: its own stage, the group's Fabric."""

    def __init__(self, fab: Fabric):
        self.fab = fab
        self.n_stages = fab.n_shards
        self.stages = (fab.axis_index(),)

    def shift(self, xs: list, delta: int) -> list:
        return [self.fab.shift(xs[0], delta)]

    def sum(self, xs: list) -> list:
        return [self.fab.all_reduce(xs[0])]


class LocalPipe:
    """Every stage of a pipe group in this process, run in turn: the shift
    is a local hand-off along the ring and the sum adds the stages' tensors
    in stage order."""

    def __init__(self, n_stages: int):
        self.n_stages = n_stages
        self.stages = tuple(range(n_stages))

    def shift(self, xs: list, delta: int) -> list:
        return [xs[(s - delta) % self.n_stages] for s in self.stages]

    def sum(self, xs: list) -> list:
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return [total] * self.n_stages


def _stage_cfg(cfg: ModelConfig, pipe, batch, n_micro: int) -> ModelConfig:
    """The configuration of one stage's slice of the stack (its periods)."""
    if cfg.family in ("vlm", "audio"):
        raise ValueError(f"{cfg.name}: the pipeline embeds tokens only ({cfg.family} takes "
                         "patches or frames), as in the JAX package")
    if batch["tokens"].shape[0] % n_micro:
        raise ValueError(f"batch {batch['tokens'].shape[0]} is not a multiple of {n_micro} "
                         "microbatches")
    return cfg.replace(n_layers=stage_layers(cfg, pipe.n_stages) * len(tf.period_spec(cfg)))


def _activation(batch, cfg: ModelConfig, n_micro: int):
    """Zeros of one microbatch's activations [B / n_micro, S, D]."""
    bsz, seq = batch["tokens"].shape
    return torch.zeros((bsz // n_micro, seq, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                       device=batch["tokens"].device)


def _ticks(trees: list, batch, cfg: ModelConfig, pipe, n_micro: int, keep: bool):
    """The GPipe forward.  Returns (each local stage's loss sum, f32, and,
    where ``keep``, each local stage's (input leaf or None, output, loss
    piece or None) for its microbatches in order)."""
    scfg = _stage_cfg(cfg, pipe, batch, n_micro)
    tokens, targets = batch["tokens"], batch["targets"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    last = pipe.n_stages - 1
    x_prev = [_activation(batch, cfg, n_micro) for _ in pipe.stages]
    mb = x_prev[0].shape[0]
    sums = [torch.zeros((), dtype=torch.float32, device=tokens.device) for _ in pipe.stages]
    saved = [[] for _ in pipe.stages]
    for t in range(n_micro + last):
        x_recv = pipe.shift(x_prev, 1)  # Send/Recv: the previous stage's output arrives
        x_prev = []
        for i, (s, p) in enumerate(zip(pipe.stages, trees)):
            m = t - s
            if not 0 <= m < n_micro:
                x_prev.append(x_recv[i])
                continue
            rows = slice(m * mb, (m + 1) * mb)
            leaf = None
            if s == 0:
                x = tf.embed_lookup(p, tokens[rows], cfg)
            else:
                leaf = x = x_recv[i].detach().requires_grad_(keep)
            x, _ = tf.stack_apply(p["layers"], x, positions, scfg)  # MoE aux dropped
            piece = None
            if s == last:
                h = rms_norm(x, p["final_norm"], cfg.norm_eps)
                piece, _ = cross_entropy(tf.unembed(p, h, cfg), targets[rows], cfg.vocab_size)
                sums[i] = sums[i] + piece.detach()
            if keep:
                saved[i].append((leaf, x, piece))
            x_prev.append(x.detach())
    return sums, saved


def _loss(sums: list, pipe, n_micro: int) -> list:
    """The global mean loss on every local stage: the last stage's sum over
    the microbatches / n_micro, summed over the group (the others add 0)."""
    last = pipe.n_stages - 1
    return pipe.sum([v / n_micro if s == last else torch.zeros_like(v)
                     for s, v in zip(pipe.stages, sums)])


def pipeline_loss(trees: list, batch, cfg: ModelConfig, *, pipe, n_micro: int) -> list:
    """The GPipe forward and loss, without gradients.  ``trees``: the
    parameters of each local stage (``stage_params``); batch: {"tokens",
    "targets"} [B, S], the same on every rank.  Returns the loss on each
    local stage."""
    with torch.no_grad():
        sums, _ = _ticks(trees, batch, cfg, pipe, n_micro, keep=False)
        return _loss(sums, pipe, n_micro)


def pipeline_grads(trees: list, batch, cfg: ModelConfig, *, pipe, n_micro: int):
    """(each local stage's gradients, each local stage's loss): the
    gradients of ``lm_loss(aux_weight=0)`` over the whole batch, in the
    parameters' dtypes; the replicated leaves' summed over the group (a
    tied embedding gets stage 0's and the last stage's)."""
    gbufs = [tree_map(torch.zeros_like, p) for p in trees]
    work = [autograd_leaves(p, g) for p, g in zip(trees, gbufs)]
    sums, saved = _ticks(work, batch, cfg, pipe, n_micro, keep=True)
    last = pipe.n_stages - 1
    g_send = [_activation(batch, cfg, n_micro) for _ in pipe.stages]
    for t in reversed(range(n_micro + last)):
        g_recv = pipe.shift(g_send, -1)  # the next stage's input cotangent arrives
        g_send = []
        for i, s in enumerate(pipe.stages):
            leaf = None
            if 0 <= t - s < n_micro:
                leaf, x, piece = saved[i].pop()
                if s == last:
                    torch.autograd.backward(piece, torch.full_like(piece, 1.0 / n_micro))
                else:
                    torch.autograd.backward(x, g_recv[i])
            g_send.append(leaf.grad if leaf is not None else torch.zeros_like(g_recv[i]))
    for key in gbufs[0]:
        if key != "layers":
            for g, total in zip(gbufs, pipe.sum([g[key] for g in gbufs])):
                g[key] = total
    return gbufs, _loss(sums, pipe, n_micro)


def sgd_update(params, grads, lr: float) -> None:
    """Plain SGD in place: p = (p - lr g) in f32, cast back to p's dtype."""
    with torch.no_grad():
        for p, g in zip(leaves(params), leaves(grads)):
            p.copy_((p.float() - lr * g.float()).to(p.dtype))


def make_pipeline_train_step(cfg: ModelConfig, mesh, *, pipe_axis: str, n_micro: int,
                             lr: float = 1e-3):
    """step(params, batch) -> (params, loss): one SGD step of this rank's
    stage (``stage_params``), updated in place.  ``mesh`` is a
    ``torch.distributed`` ``DeviceMesh`` with a ``pipe_axis`` dim; the stage
    is this rank's index along it.  ``step.grads_fn(params, batch)`` returns
    (gradients, loss) without the update; ``step.pipe`` the group."""
    pipe = FabricPipe(Fabric.from_mesh(mesh, (pipe_axis,)))

    def grads_fn(params, batch):
        grads, loss = pipeline_grads([params], batch, cfg, pipe=pipe, n_micro=n_micro)
        return grads[0], loss[0]

    def step(params, batch):
        grads, loss = grads_fn(params, batch)
        sgd_update(params, grads, lr)
        return params, loss

    step.grads_fn = grads_fn
    step.pipe = pipe
    return step
