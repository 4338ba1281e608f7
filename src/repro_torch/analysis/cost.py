"""The work of a call: FLOPs counted over the plain versions, and the bytes
of its inputs and outputs (the port's stand-in for
``repro.analysis.hlo_cost``, which reads them from XLA's compiled module).

``counted_flops`` runs the function on the "meta" device under
``torch.utils.flop_counter.FlopCounterMode``: shapes only, nothing is
computed, and ``kernels.ops`` sends a meta tensor to each kernel's plain
version.  So the count is the same work whichever implementation runs on
the card (the CUDA kernels are ``ctypes`` launches that the counter cannot
see).  It counts the products (matmuls, batched matmuls, convolutions),
as XLA's cost analysis counts them once per op: the attention's plain
version computes every score of the causal square, and MoE's expert
products run over the padded capacity.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _to_meta(tree):
    """The tree with every tensor replaced by a meta tensor of its shape,
    dtype and ``requires_grad``."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta").requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def counted_flops(fn, *args) -> int:
    """FLOPs that ``fn(*args)`` dispatches, run on meta copies of ``args``."""
    meta = _to_meta(args)
    with FlopCounterMode(display=False) as counter:
        fn(*meta)
    return int(counter.get_total_flops())


def io_bytes(args, out) -> int:
    """Bytes of every tensor in ``args`` and ``out``: each input read once,
    each output written once."""
    return sum(t.numel() * t.element_size() for t in _tensors(args) + _tensors(out))
