"""Parameters to and from a flat dict of numpy arrays keyed by path string.

Keys are spelled as the JAX package's parameter paths (``embed``,
``layers/0/mixer/wq``, ``layers/0/ffn/w_gate``, ``final_norm``, ``unembed``,
``frontend_proj``, ``encoder/layers/0/mixer/wq``):
a numeric segment is an index into a list (the period positions), any other
segment a dict key.  So a tree flattened on the JAX side hands over one to
one; this module itself never sees JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel import sharding


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: the tensor shares its memory
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        idx = sorted(node, key=int)
        if [int(i) for i in idx] != list(range(len(idx))):
            raise ValueError(f"list indices {idx} are not 0..{len(idx) - 1}")
        return [node[i] for i in idx]
    return node


# Leaves the JAX package keeps in f32 whatever the model's dtype: the norm
# scales (the cross-attention's pre-norm ``norm_x`` too), the MoE router and
# the SSM's conv, decay and skip parameters.
F32_LEAVES = frozenset({"norm1", "norm2", "norm_x", "final_norm", "norm_w", "router",
                        "conv_w", "conv_b", "a_log", "dt_bias", "d_skip"})


def from_numpy(tree: dict, device, dtype=None) -> dict:
    """{path: array} -> the port's nested parameters on ``device``.

    ``dtype`` (a torch dtype or its name: the model's ``cfg.dtype``) casts
    the floating leaves that the JAX package makes in the model's dtype;
    those it keeps in f32 (``F32_LEAVES``, by their last path segment) are
    made f32.  So a tree that ``to_numpy`` turned to f32 comes back with
    the model's dtypes.
    """
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    root: dict = {}
    for path, arr in tree.items():
        parts = path.split("/")
        node = root
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        t = _tensor(np.asarray(arr))
        if dtype is not None and t.is_floating_point():
            t = t.to(torch.float32 if parts[-1] in F32_LEAVES else dtype)
        node[parts[-1]] = t.to(device)
    return _listify(root)


def flatten(tree) -> dict:
    """A tree of dicts and lists -> {path: leaf}."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = ((str(i), v) for i, v in enumerate(node))
        else:
            out[prefix] = node
            return
        for k, v in items:
            walk(v, f"{prefix}/{k}" if prefix else k)

    walk(tree, "")
    return out


def to_numpy(params) -> dict:
    """The port's parameters -> {path: array}; bf16 leaves come back as f32."""
    out = {}
    for path, t in flatten(params).items():
        t = t.detach().cpu()
        out[path] = (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()
    return out


def shards_from_numpy(tree: dict, index: int, n_rails: int, device, dtype=None, *,
                      model_index: int = 0, model_size: int = 1) -> dict:
    """Global {path: array} (e.g. the JAX package's ``init_lm``) -> the port's
    stored shards of rail rank ``index`` of ``n_rails`` (flat index, major
    axis first) and model rank ``model_index`` of ``model_size``, by the
    port's sharding rules.  ``to_numpy`` of the gathered parameters gives
    the global arrays back."""
    out = {}
    for path, arr in tree.items():
        arr = np.asarray(arr)
        stacked = path.startswith("layers") or "/layers/" in path
        _, fd, td = sharding.leaf_spec(path, arr.shape, n_rails=n_rails, rail_axes=("data",),
                                       model_size=model_size, stacked=stacked)
        for dim, i, n in ((td, model_index, model_size), (fd, index, n_rails)):
            if dim is not None and n > 1:
                size = arr.shape[dim] // n
                arr = np.take(arr, np.arange(i * size, (i + 1) * size), axis=dim)
        out[path] = arr
    return from_numpy(out, device, dtype)
