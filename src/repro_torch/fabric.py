"""Photonic-rail collectives over ``torch.distributed`` (port of
``repro.core._fabric_rings``): the datapath.  The switches the control
plane programs between phases (``FabricSpec``, the OCS and packet-switch
backends) are modelled in ``repro_torch.core.fabric``, a module of its own.

An optical circuit switch gives a *matching* between rail ports at any
instant, so the only legal collectives are chains of point-to-point
transfers along a ring.  Each hop here is one ``dist.batch_isend_irecv``:
send to the group's next rank, receive from its previous one.

  ring_all_gather      FSDP forward parameter gather ("AllGather" phase)
  ring_reduce_scatter  FSDP gradient scatter, the exact transpose of the
                       gather: the same ring run backwards, summing in the
                       order the JAX package's linear transpose sums
  ring_all_reduce      optimizer-adjacent ARs (flat, padded, RS then AG)
  ring_all_to_all      ring-forwarded AllToAll (n - 1 hops of the whole buffer)
  shift                point-to-point ring shift (PP Send/Recv, pod rings)

``Fabric(kind="eps")``, the electrical baseline, runs the same interface on
the native collectives.  The gather is an autograd function whose backward
is the reduce-scatter, and the other way round, so a loss differentiated
through a gathered parameter sends its gradient back over the ring, as the
JAX package's AD transpose does.  Every operation returns its input when the
axis size is 1.  Each ``Fabric`` counts the bytes this rank sends
(``bytes_sent``), as a ring sends them: (n - 1) shards a gather, (n - 1)
chunks of 1/n a reduce-scatter, both for a (padded) all-reduce or a max,
the whole buffer n - 1 times a photonic all-to-all ((n - 1)/n of it a
native one), the buffer once a shift; ``bytes_by_axis`` splits the count
over the fabric's axes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def gather_bytes_by_axis(nbytes: int, sizes: Sequence[int]) -> list:
    """Bytes a rank sends on each axis (in the order of ``sizes``, major
    first) to all-gather its part of ``nbytes``; the gather runs the minor
    axis first, so each axis moves the parts gathered before it."""
    sent = [0] * len(sizes)
    for i in reversed(range(len(sizes))):
        sent[i] = (sizes[i] - 1) * nbytes
        nbytes *= sizes[i]
    return sent


def gather_bytes(nbytes: int, sizes: Sequence[int]) -> int:
    """Bytes a rank sends to all-gather its part of ``nbytes`` over axes of
    ``sizes`` (major first; the gather runs the minor axis first)."""
    return sum(gather_bytes_by_axis(nbytes, sizes))


def scatter_bytes_by_axis(nbytes: int, sizes: Sequence[int]) -> list:
    """Bytes a rank sends on each axis to reduce-scatter ``nbytes`` (major
    axis first)."""
    sent = []
    for n in sizes:
        nbytes //= n
        sent.append((n - 1) * nbytes)
    return sent


def scatter_bytes(nbytes: int, sizes: Sequence[int]) -> int:
    """Bytes a rank sends to reduce-scatter ``nbytes`` (major axis first)."""
    return sum(scatter_bytes_by_axis(nbytes, sizes))


def all_reduce_bytes_by_axis(numel: int, element_size: int, sizes: Sequence[int]) -> list:
    """Bytes a rank sends on each axis to all-reduce ``numel`` elements: a
    ring reduce-scatter and all-gather of the buffer padded to n chunks."""
    return [2 * (n - 1) * -(-numel // n) * element_size if n > 1 else 0 for n in sizes]


def all_reduce_bytes(numel: int, element_size: int, sizes: Sequence[int]) -> int:
    """Bytes a rank sends to all-reduce ``numel`` elements, axis by axis: a
    ring reduce-scatter and all-gather of the buffer padded to n chunks."""
    return sum(all_reduce_bytes_by_axis(numel, element_size, sizes))


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _hops(pairs, group):
    """One ring hop: [(send tensor, to rank, receive tensor, from rank), ...]
    (ranks within ``group``), all in one batch."""
    ops = []
    for send, to, recv, frm in pairs:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, to), group))
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def _merge_axis(buf: torch.Tensor, axis: int) -> torch.Tensor:
    """[n, ...] -> the leading stack dim merged into dim ``axis`` of the rest."""
    n, rest = buf.shape[0], buf.shape[1:]
    moved = buf.movedim(0, axis)
    return moved.reshape(rest[:axis] + (n * rest[axis],) + rest[axis + 1:])


def _split_halves(x, axis: int, bidirectional: bool, n: int):
    """The parts of ``x`` that travel each ring direction: both halves when
    the bidirectional ring applies (even dim, more than two ranks)."""
    if bidirectional and x.shape[axis] % 2 == 0 and n > 2:
        lo, hi = x.chunk(2, dim=axis)
        return [(lo.contiguous(), 1), (hi.contiguous(), -1)]
    return [(x.contiguous(), 1)]


def _ring_all_gather(x, group, n: int, axis: int, bidirectional: bool):
    idx = dist.get_rank(group)
    parts = _split_halves(x, axis, bidirectional, n)
    bufs = []
    for part, _ in parts:
        buf = part.new_empty((n,) + part.shape)
        buf[idx] = part
        bufs.append(buf)
    shards = [part for part, _ in parts]
    for k in range(1, n):
        recvs = [torch.empty_like(s) for s in shards]
        _hops([(s, (idx + d) % n, r, (idx - d) % n)
               for s, r, (_, d) in zip(shards, recvs, parts)], group)
        for buf, r, (_, d) in zip(bufs, recvs, parts):
            # after k hops in direction d the resident shard is rank idx - d k's
            buf[(idx - d * k) % n] = r
        shards = recvs
    buf = bufs[0] if len(bufs) == 1 else torch.cat(bufs, dim=axis + 1)
    return _merge_axis(buf, axis)


def _ring_reduce_scatter(x, group, n: int, axis: int, bidirectional: bool):
    """The transpose of ``_ring_all_gather``: chunk j of every rank's ``x``
    summed into rank j.  The partial sum of chunk s starts at the rank the
    gather reached last (s - d) and travels against the gather's direction,
    so it sums ((x_{s-d} + x_{s-2d}) + ...) + x_s, the JAX transpose's order."""
    idx = dist.get_rank(group)
    chunks = x.chunk(n, dim=axis)
    if bidirectional and chunks[0].shape[axis] % 2 == 0 and n > 2:
        halves = [c.chunk(2, dim=axis) for c in chunks]
        parts = [([h[0] for h in halves], 1), ([h[1] for h in halves], -1)]
    else:
        parts = [(list(chunks), 1)]
    partial = [cs[(idx + d) % n].contiguous() for cs, d in parts]
    for k in range(n - 1):
        recvs = [torch.empty_like(p) for p in partial]
        _hops([(p, (idx - d) % n, r, (idx + d) % n)
               for p, r, (_, d) in zip(partial, recvs, parts)], group)
        partial = [r + cs[(idx + 2 * d + d * k) % n] for r, (cs, d) in zip(recvs, parts)]
    return partial[0] if len(partial) == 1 else torch.cat(partial, dim=axis)


def _ring_all_to_all(xstack, group, n: int):
    """Slot j of the result holds the chunk rank j addressed to this rank."""
    idx = dist.get_rank(group)
    out = torch.empty_like(xstack)
    out[idx] = xstack[idx]
    buf = xstack.contiguous()
    for k in range(1, n):
        recv = torch.empty_like(buf)
        _hops([(buf, (idx + 1) % n, recv, (idx - 1) % n)], group)
        out[(idx - k) % n] = recv[idx]  # the buffer now came from rank idx - k
        buf = recv
    return out


def _shift(x, group, n: int, delta: int):
    recv = torch.empty_like(x)
    idx = dist.get_rank(group)
    _hops([(x.contiguous(), (idx + delta) % n, recv, (idx - delta) % n)], group)
    return recv


def _native_all_gather(x, group, n: int, axis: int):
    moved = x.movedim(axis, 0).contiguous()
    full = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
    dist.all_gather_into_tensor(full, moved, group=group)
    return full.movedim(0, axis)


def _native_reduce_scatter(x, group, n: int, axis: int):
    moved = x.movedim(axis, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, axis)


@dataclass(frozen=True)
class Fabric:
    """Rail collectives over one or more mesh axes (major axis first).

    ``groups`` holds one process group per axis (a ``DeviceMesh``'s, see
    ``from_mesh``); a group's rank is this process's index along that axis.
    """

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    kind: str = "photonic"  # "photonic" | "eps"
    bidirectional: bool = False  # both ring directions at once (halves)
    groups: tuple = ()
    _sent: dict = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def from_mesh(cls, mesh, axes, kind: str = "photonic", bidirectional: bool = False):
        """The fabric of ``axes`` of a ``torch.distributed`` ``DeviceMesh``."""
        return cls(tuple(axes), tuple(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes),
                   kind, bidirectional, tuple(mesh.get_group(a) for a in axes))

    @property
    def bytes_sent(self) -> int:
        """The bytes this rank has sent over the fabric since it was made
        (or since ``reset_bytes``): the sum of ``bytes_by_axis``."""
        return sum(self._sent.values())

    @property
    def bytes_by_axis(self) -> dict:
        """{axis: bytes this rank has sent on it} since the fabric was made
        (or since ``reset_bytes``)."""
        return {a: self._sent.get(a, 0) for a in self.axes}

    def reset_bytes(self) -> None:
        self._sent.clear()

    def _count(self, per_axis) -> None:
        for a, n in zip(self.axes, per_axis):
            self._sent[a] = self._sent.get(a, 0) + n

    @property
    def n_shards(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out

    def _axes(self, reverse: bool = False):
        out = list(zip(self.groups or (None,) * len(self.axes), self.sizes))
        return reversed(out) if reverse else out

    # -- AllGather: minor axis first, so the flat shard index is major-first --
    def all_gather(self, x, axis: int = 0):
        if self.n_shards == 1:
            return x
        return _AllGather.apply(x, self, axis)

    def reduce_scatter(self, x, axis: int = 0):
        """The transpose of ``all_gather``: major axis first."""
        if self.n_shards == 1:
            return x
        return _ReduceScatter.apply(x, self, axis)

    def _gather(self, x, axis):
        self._count(gather_bytes_by_axis(_nbytes(x), self.sizes))
        for group, n in self._axes(reverse=True):
            if n == 1:
                continue
            if self.kind == "photonic":
                x = _ring_all_gather(x, group, n, axis, self.bidirectional)
            else:
                x = _native_all_gather(x, group, n, axis)
        return x

    def _scatter(self, x, axis):
        self._count(scatter_bytes_by_axis(_nbytes(x), self.sizes))
        for group, n in self._axes():
            if n == 1:
                continue
            if self.kind == "photonic":
                x = _ring_reduce_scatter(x, group, n, axis, self.bidirectional)
            else:
                x = _native_reduce_scatter(x, group, n, axis)
        return x

    def all_reduce(self, x):
        """Flat, padded ring ReduceScatter then AllGather, axis by axis."""
        self._count(all_reduce_bytes_by_axis(x.numel(), x.element_size(), self.sizes))
        for group, n in self._axes():
            if n == 1:
                continue
            if self.kind != "photonic":
                x = x.clone()
                dist.all_reduce(x, group=group)
                continue
            flat = x.reshape(-1)
            pad = (-flat.shape[0]) % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            full = _ring_all_gather(_ring_reduce_scatter(flat, group, n, 0, False),
                                    group, n, 0, False)
            x = full[:flat.shape[0] - pad].reshape(x.shape)
        return x

    def pmax(self, x):
        """Max of a small statistic over every axis: management traffic."""
        self._count(all_reduce_bytes_by_axis(x.numel(), x.element_size(), self.sizes))
        x = x.clone()
        for group, n in self._axes():
            if n > 1:
                dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
        return x

    def all_to_all(self, xstack):
        if len(self.axes) != 1:
            raise ValueError("all_to_all spans a single rail axis")
        group, n = self.groups[0] if self.groups else None, self.sizes[0]
        if n == 1:
            return xstack
        if self.kind == "photonic":
            self._count([(n - 1) * _nbytes(xstack)])
            return _ring_all_to_all(xstack, group, n)
        self._count([(n - 1) * _nbytes(xstack) // n])
        out = torch.empty_like(xstack)
        dist.all_to_all_single(out, xstack.contiguous(), group=group)
        return out

    def shift(self, x, delta: int = 1, axis_idx: int = -1):
        """Shift along one rail axis (default: the minor axis)."""
        n = self.sizes[axis_idx]
        if n == 1:
            return x
        self._count([_nbytes(x) if a == self.axes[axis_idx] else 0 for a in self.axes])
        return _shift(x, self.groups[axis_idx], n, delta)

    def axis_index(self) -> int:
        """Flat shard index (major axis first)."""
        idx = 0
        for group, n in self._axes():
            idx = idx * n + (dist.get_rank(group) if n > 1 else 0)
        return idx


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fab, axis):
        ctx.fab, ctx.axis = fab, axis
        return fab._gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.fab._scatter(g.contiguous(), ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fab, axis):
        ctx.fab, ctx.axis = fab, axis
        return fab._scatter(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.fab._gather(g.contiguous(), ctx.axis), None, None
