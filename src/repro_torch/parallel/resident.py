"""Weight-resident decode's products over the rails (the port of the JAX
package's GSPMD weight-resident step, ``repro.serve.step``'s
``_make_resident_decode_step``).

There the parameters keep their stored FSDP x TP shardings and XLA's
partitioner reduces activation-sized partial sums over the rails instead of
gathering the weights every token.  Here each matrix leaf stays on its
stored shard as a ``RailShard``, handed to the model's unchanged code in
place of the tensor: ``torch.einsum(eq, x, leaf)`` reaches
``RailShard.__torch_function__``, which runs the product on the shard and
combines over the rails.  The activations are replicated over the rails;
let c be the leaf's letter of its FSDP dim in ``eq``:

  c contracted       x's slice of c times the shard, the partial sums
                     all-reduced (llama's wq [d, H, dh] on d, w_down on f)
  c in the output    the shard's slice of the output, all-gathered along c
                     (wo [H, dh, d] on d, w_gate on f, the vocabulary head);
                     where x carries c too (an expert dim of a MoE leaf
                     [E, d, f]), x's slice of c

An embedding sharded on its rows looks up the tokens of its slice (zeros
elsewhere) and all-reduces; on its columns it gathers the looked-up slices.
Small leaves (norm scales, the conv weights, ``a_log``, ``d_skip``,
``dt_bias``, the router) are gathered each step, as the gathered step
gathers them.  The rails' ranks compose with the model axis as the stored
shards do: a leaf's TP dim is never its FSDP dim (``parallel.sharding``).

``Rails``, this process's rank of a ``Fabric``, carries the combines: each
process holds one shard of each leaf, and the fabric counts the bytes it
sends.  A ``RailShard`` asks its rails only for ``ranks``, ``reduce`` and
``join``, and ``place`` for ``parts`` and ``gather_leaf``, so an object
that runs several ranks in one process can stand in for them.
Batch-sharded caches keep their rows: each mixer takes this rank's rows of
its inputs and gathers its outputs over the rails once (``rails.rows()``).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

#: leaves kept on their shards (every other sharded leaf is gathered)
RESIDENT_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
                             "w_out", "embed", "unembed"})


def _axis(subs: str, letter: str, ndim: int) -> int:
    """The dim of ``letter`` in einsum subscripts ``subs`` of an operand of
    ``ndim`` dims (with or without an ellipsis)."""
    if "..." not in subs:
        return subs.index(letter)
    pre, post = subs.split("...")
    return pre.index(letter) if letter in pre else ndim - len(post) + post.index(letter)


class RailShard:
    """A leaf kept on the rails: ``parts`` are the shards of the ranks this
    process runs (``rails.ranks()``) along dim ``fsdp`` of the leaf's
    ``shape``.
    ``torch.einsum(eq, x, leaf)`` and an embedding lookup ``leaf[tokens]``
    run over the rails; selecting along another dim (``leaf[:, heads]``,
    ``index_select``) and ``local_map`` keep it resident; any other torch
    function on it raises."""

    def __init__(self, parts: Sequence[torch.Tensor], fsdp: int, rails):
        self.parts, self.fsdp, self.rails = list(parts), fsdp, rails
        shape = list(self.parts[0].shape)
        shape[fsdp] *= rails.n
        self.shape = torch.Size(shape)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.einsum and len(args) == 3 and isinstance(args[2], RailShard) \
                and isinstance(args[1], torch.Tensor) and not kwargs:
            return args[2].product(args[0], args[1])
        raise NotImplementedError(f"{getattr(func, '__name__', func)} of a rail-resident leaf: "
                                  f"only torch.einsum(eq, x, leaf) runs over the rails")

    @property
    def device(self):
        return self.parts[0].device

    def dim(self) -> int:
        return len(self.shape)

    def local_map(self, fn) -> "RailShard":
        """``fn`` applied to each shard, which keeps its FSDP dim."""
        return RailShard([fn(p) for p in self.parts], self.fsdp, self.rails)

    def product(self, eq: str, x: torch.Tensor) -> torch.Tensor:
        ins, out = eq.replace(" ", "").split("->")
        xs, ws = ins.split(",")
        if "..." in ws:
            raise NotImplementedError(f"einsum {eq!r}: the leaf's subscripts have an ellipsis")
        c = ws[self.fsdp]
        k = self.parts[0].shape[self.fsdp]
        xd = _axis(xs, c, x.dim()) if c in xs else None
        partials = [torch.einsum(eq, x if xd is None else x.narrow(xd, r * k, k), p)
                    for r, p in zip(self.rails.ranks(), self.parts)]
        if c in out:
            return self.rails.join(partials, _axis(out, c, partials[0].dim()))
        return self.rails.reduce(partials)

    def __getitem__(self, idx):
        if isinstance(idx, torch.Tensor):
            return self._lookup(idx)
        idx = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(i, int) for i in idx) or sum(isinstance(i, torch.Tensor)
                                                        for i in idx) > 1:
            raise NotImplementedError(f"indexing a rail-resident leaf by {idx}")
        if self.fsdp < len(idx) and not (isinstance(idx[self.fsdp], slice)
                                         and idx[self.fsdp] == slice(None)):
            raise NotImplementedError(f"indexing a rail-resident leaf along its FSDP dim "
                                      f"{self.fsdp}")
        return self.local_map(lambda p: p[idx])

    def index_select(self, dim: int, index: torch.Tensor) -> "RailShard":
        if dim % len(self.shape) == self.fsdp:
            raise NotImplementedError("index_select along a rail-resident leaf's FSDP dim")
        return self.local_map(lambda p: p.index_select(dim, index))

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """Rows ``tokens`` of a 2-D table (an embedding)."""
        if len(self.shape) != 2:
            raise NotImplementedError("a lookup of a rail-resident leaf that is not 2-D")
        if self.fsdp == 1:
            return self.rails.join([p[tokens] for p in self.parts], tokens.dim())
        k = self.parts[0].shape[0]
        parts = []
        for r, p in zip(self.rails.ranks(), self.parts):
            mine = (tokens >= r * k) & (tokens < (r + 1) * k)
            rows = p[(tokens - r * k).clamp(0, k - 1)]
            parts.append(torch.where(mine[..., None], rows, torch.zeros_like(rows)))
        return self.rails.reduce(parts)


class Rows:
    """A batch-sharded cache's rows on rank ``index`` of the rails: ``local``
    takes them of a tensor over the whole batch (dim 0), ``gather`` brings
    a mixer's outputs of every rank's rows back over the fabric."""

    def __init__(self, rails: "Rails"):
        self.rails = rails

    def local(self, t: torch.Tensor) -> torch.Tensor:
        b = t.shape[0] // self.rails.n
        return t[self.rails.index * b:(self.rails.index + 1) * b]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.rails.fab.all_gather(t, 0)


class Rails:
    """This process's rank (``index`` of ``n``) on the rails of ``fab``: one
    shard of each leaf, combined over the fabric's rings.  ``combines``
    counts the products' reduces and joins (one rank too, where they move
    nothing)."""

    def __init__(self, fab):
        self.fab, self.n, self.index = fab, fab.n_shards, fab.axis_index()
        self.combines = 0

    def ranks(self) -> List[int]:
        return [self.index]

    def parts(self, leaf: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """This rank's shard of a stored leaf (it stores only that)."""
        return [leaf]

    def rows(self) -> Rows:
        return Rows(self)

    def reduce(self, partials):
        self.combines += 1
        return self.fab.all_reduce(partials[0])

    def join(self, parts, dim: int):
        self.combines += 1
        return self.fab.all_gather(parts[0], dim)

    def gather_leaf(self, leaf: torch.Tensor, dim: int) -> torch.Tensor:
        return self.fab.all_gather(leaf, dim)


def place(stored, fd_tree, rails, *, dim_off: int = 0, resident: bool = True):
    """The leaves a resident step's model code reads: each stored leaf with
    an FSDP dim as a ``RailShard`` where it is a matrix the products read
    (``RESIDENT_LEAVES``), else gathered over the rails; ``resident=False``
    gathers every one (the gathered step's traffic).  ``dim_off`` is -1 for
    a period's slices, whose stack dim is gone."""
    def walk(node, fd, key=""):
        if isinstance(node, dict):
            return {k: walk(v, fd[k], k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, fd[i], key) for i, v in enumerate(node)]
        if fd is None:
            return node
        if resident and key in RESIDENT_LEAVES:
            return RailShard(rails.parts(node, fd + dim_off), fd + dim_off, rails)
        return rails.gather_leaf(node, fd + dim_off)
    return walk(stored, fd_tree)
