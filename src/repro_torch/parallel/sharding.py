"""Per-leaf sharding rules (port of the rules in ``repro.parallel.sharding``).

Each parameter leaf is stored FSDP-sharded over the rail axes along its
largest rail-divisible dim, excluding its TP dim, and sharded over the
scale-up ``model`` axis along its TP dim: the first candidate of its rule
that the model size divides, else it is replicated over ``model``.  Stacked
layer leaves carry a leading [n_periods] dim that is never sharded.  The
train step passes the mesh's real model size, so every leaf gets the JAX
package's (spec, FSDP dim, TP dim); ``parallel.tensor`` and the layers do
the model axis's compute.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

MODEL_AXIS = "model"

# name pattern -> preferred TP dim candidates (index into the *unstacked*
# shape; negative ok).  First candidate whose size divides the model axis
# wins; otherwise the leaf is replicated over `model`.
_TP_RULES: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    (r"\bembed$", (0,)),            # vocab-sharded lookup table
    (r"\bunembed$", (1,)),          # vocab-sharded output projection
    (r"\bfrontend_proj$", (1,)),
    (r"\brouter$", (1,)),           # expert dim
    (r"moe/.*\bw_(gate|up|down)$", (0,)),   # E dim => expert parallelism
    (r"\bw_(gate|up)$", (1,)),      # d_ff
    (r"\bw_down$", (0,)),           # d_ff
    (r"\bwq$", (1, 2)),             # heads, else head_dim
    (r"\bw[kv]$", (1,)),            # kv heads or replicate
    (r"\bwo$", (0, 1)),
    (r"\bw_in$", (1,)),             # ssm fused in-proj columns
    (r"\bw_out$", (0,)),            # d_inner
    (r"\bconv_w$", (1,)),
    (r"\b(a_log|dt_bias|d_skip)$", (0,)),
    (r"\bnorm", ()),                # norms replicated over model
)


def _path_str(path) -> str:
    """"a/b/0/c" from a sequence of dict keys and list indices."""
    return "/".join(str(k) for k in path)


def _is_moe_leaf(pstr: str) -> bool:
    # routed-expert weights live under layers/<pos>/ffn with a leading E dim;
    # distinguish from dense mlp by rank at call site instead.
    return "ffn" in pstr and "shared" not in pstr


def tp_dim(pstr: str, shape, model_size: int) -> Optional[int]:
    """TP dim for an (unstacked) leaf shape, or None."""
    name = pstr.split("/")[-1]
    moe3d = _is_moe_leaf(pstr) and name in ("w_gate", "w_up", "w_down") \
        and len(shape) == 3
    for pat, cands in _TP_RULES:
        target = ("moe/" + name) if moe3d else name
        if re.search(pat, target if "moe/" in pat else name):
            for c in cands:
                c = c % len(shape) if shape else 0
                if c < len(shape) and shape[c] % model_size == 0:
                    return c
            return None
    return None


def fsdp_dim(shape, n_rails: int, exclude: Optional[int]) -> Optional[int]:
    """Largest rail-divisible dim (excluding the TP dim), else None."""
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if i == exclude:
            continue
        if s % n_rails == 0 and s > best_size:
            best, best_size = i, s
    return best


def leaf_spec(pstr: str, shape, *, n_rails: int, rail_axes, model_size: int,
              stacked: bool):
    """(spec, fsdp_dim, tp_dim) for one leaf: spec names the mesh axis of each
    dim (the rail axes, ``MODEL_AXIS`` or None).  ``stacked`` leaves have a
    leading n_periods dim (never sharded); dims refer to the full (stacked)
    shape."""
    base = shape[1:] if stacked else shape
    td = tp_dim(pstr, base, model_size)
    fd = fsdp_dim(base, n_rails, td)
    off = 1 if stacked else 0
    spec = [None] * len(shape)
    if td is not None:
        spec[td + off] = MODEL_AXIS
    if fd is not None:
        spec[fd + off] = tuple(rail_axes) if len(rail_axes) > 1 else rail_axes[0]
    return (tuple(spec),
            None if fd is None else fd + off,
            None if td is None else td + off)


def _walk(params, fn, _path=()):
    """Map fn(pstr, leaf, stacked) over a tree of dicts and lists, keeping
    its structure; a leaf is anything else (a tensor, real or on the meta
    device)."""
    if isinstance(params, dict):
        return {k: _walk(v, fn, _path + (k,)) for k, v in params.items()}
    if isinstance(params, list):
        return [_walk(v, fn, _path + (i,)) for i, v in enumerate(params)]
    pstr = _path_str(_path)
    stacked = pstr.startswith("layers") or "/layers/" in pstr
    return fn(pstr, params, stacked)


def model_dim(pstr: str, shape, tp) -> Optional[int]:
    """The TP dim of an unstacked leaf of GLOBAL ``shape`` on the model axis
    ``tp`` (a ``parallel.tensor.ModelAxis``, or None); None where the axis
    partitions nothing or the leaf is replicated over it.  The layers ask
    this to know what their leaves hold."""
    if tp is None or tp.size == 1:
        return None
    return tp_dim(pstr, shape, tp.size)
