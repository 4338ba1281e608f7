"""The model axis: tensor and expert parallelism (TP, EP) over the scale-up
domain, Megatron-style.

The JAX package leaves its ``model`` axis to GSPMD, which inserts the
collectives itself; this module holds the port's own.  Per the paper (Fig. 1)
TP and EP run on the electrical scale-up domain, so they are native
``torch.distributed`` collectives on the model group (NCCL on the card, gloo
on the CPU), never the photonic rail rings of ``fabric.py``.

``ModelAxis`` keeps them behind one small object: its ``size``, its
``rank`` and the conjugate autograd functions a partitioned layer needs.

  copy         identity forward, all-reduce backward: a replicated
               activation (or leaf) enters a partitioned region
  reduce       all-reduce forward, identity backward: partial results leave
  all_sum      all-reduce forward and backward: a statistic summed over the
               shards that each shard then uses for its own part
  gather_last  all-gather of the last dim forward, this rank's slice backward
  gather_leaf  all-gather of a model-sharded leaf along its TP dim for
               replicated compute, this rank's slice backward
  max, gather  an all-reduce MAX and an all-gather outside the
               differentiated path (statistics, checkpoints)

At size 1 every op returns its input and launches nothing.  ``launches``
counts the collectives this object has run.  Outside autograd ``copy`` is
the identity; ``gather_leaf`` gathers a leaf that is held in parts (one with
a ``local_map``) part by part.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

MODEL_AXIS = "model"


class ModelAxis:
    """The model axis of a mesh: ``size`` ranks, this one ``rank``, their
    process ``group``."""

    def __init__(self, group=None, size: int = 1, rank: int = 0):
        self.group, self.size, self.rank = group, size, rank
        self.launches = 0

    @classmethod
    def from_mesh(cls, mesh) -> "ModelAxis":
        """The ``model`` dim of a ``DeviceMesh``; size 1 where it has none."""
        names = mesh.mesh_dim_names or ()
        if MODEL_AXIS not in names or mesh.size(names.index(MODEL_AXIS)) == 1:
            return cls()
        group = mesh.get_group(MODEL_AXIS)
        return cls(group, dist.get_world_size(group), dist.get_rank(group))

    @property
    def active(self) -> bool:
        return self.size > 1

    def block(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's even block of ``n``."""
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} model ranks")
        b = n // self.size
        return self.rank * b, (self.rank + 1) * b

    # -- collectives (counted) --
    def _all_reduce(self, x, op=dist.ReduceOp.SUM):
        x = x.contiguous().clone()
        dist.all_reduce(x, op=op, group=self.group)
        self.launches += 1
        return x

    def _all_gather(self, x, dim: int):
        moved = x.movedim(dim, 0).contiguous()
        full = moved.new_empty((self.size * moved.shape[0],) + moved.shape[1:])
        dist.all_gather_into_tensor(full, moved, group=self.group)
        self.launches += 1
        return full.movedim(0, dim)

    def _slice(self, x, dim: int):
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    # -- the conjugate functions --
    def copy(self, x):
        return _Copy.apply(x, self) if self.active and torch.is_grad_enabled() else x

    def reduce(self, x):
        return _Reduce.apply(x, self) if self.active else x

    def all_sum(self, x):
        return _AllSum.apply(x, self) if self.active else x

    def gather_last(self, x):
        return _Gather.apply(x, self, x.dim() - 1) if self.active else x

    def gather_leaf(self, x, dim: int):
        if not self.active:
            return x
        if isinstance(x, torch.Tensor):
            return _Gather.apply(x, self, dim)
        return x.local_map(lambda t: self.gather(t, dim))

    @torch.no_grad()
    def max(self, x):
        return self._all_reduce(x, dist.ReduceOp.MAX) if self.active else x

    @torch.no_grad()
    def gather(self, x, dim: int):
        """All-gather along ``dim`` outside the differentiated path."""
        return self._all_gather(x, dim) if self.active else x


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._all_reduce(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp._all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp._all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._all_reduce(g), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp._all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._slice(g, ctx.dim).contiguous(), None, None
