"""Checkpoint save / restore / reshard in the JAX package's on-disk format
(port of ``repro.train.checkpoint``), so each package restores the other's.

Format: one ``.npy`` per leaf of ``params``, ``opt`` (``m``, ``v``, and
``step`` as an int32 0-d array) and ``ef``, each the full (unsharded) array,
bf16 widened to f32 (lossless); and ``manifest.json``:
``{"leaves": [{"tree", "key", "file", "dtype", "shape"}, ...], "extra"}``.
``key`` is the JAX ``keystr`` of the leaf's path (``['layers'][0]['mixer']
['wq']``: a dict key is ``['k']``, a list index ``[i]``), ``dtype`` the
leaf's own (``bfloat16`` for a widened leaf), and leaves are listed in the
JAX flattening order (dict keys sorted).

``restore`` shards every global array for this rank by the FSDP and TP dims
of the TARGET setup and mesh, which may differ from those it was saved under
(elastic reshard: ("data", "model") of 4 x 2 -> ("pod", "data", "model") of
2 x 2 x 2, FSDP <-> HSDP, a model axis of another size).  Writes go to
``<dir>.tmp`` and then ``os.replace``, so a crash mid-save never corrupts the
previous checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train import step as st
from repro_torch.tree import tree_map

_TREES = ("params", "opt", "ef")


def _keyed(tree, prefix: str = ""):
    """[(keystr, leaf)] in the JAX flattening order: dict keys sorted, lists
    in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _keyed(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _keyed(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _keystr_tree(tree, prefix: str = ""):
    """The tree with each leaf replaced by its keystr."""
    if isinstance(tree, dict):
        return {k: _keystr_tree(v, f"{prefix}['{k}']") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keystr_tree(v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return prefix


def file_name(tree: str, key: str) -> str:
    """The reference's file name of a leaf."""
    return (f"{tree}{key}".replace("/", "_").replace("'", "").replace("[", "_")
            .replace("]", "") + ".npy")


def manifest_records(params, opt, ef):
    """[(tree, key, leaf)] of a checkpoint of these trees; ``opt["step"]`` is
    a Python int."""
    trees = {"params": params, "opt": {"m": opt["m"], "v": opt["v"], "step": opt["step"]},
             "ef": ef}
    return [(name, key, leaf) for name in _TREES for key, leaf in _keyed(trees[name])]


def save(ckpt_dir: str, params, opt, ef, *, fd_tree, fabric, td_tree=None, model=None,
         extra: Optional[Dict] = None):
    """Write the global arrays of this rank's stored shards (parameters,
    AdamW moments, error feedback: ``fd_tree`` and ``fabric`` are the train
    step's, and on a model axis its ``td_tree`` and ``model`` too).  Every
    rank gathers each leaf in turn over the rails and the model axis (a
    collective); rank 0
    writes it, so no rank holds more than one global leaf at a time.  Under
    HSDP each pod has its own ``ef``: pod 0's is written, as the reference
    writes the one replica its ``device_get`` reads."""
    rank0 = dist.get_rank() == 0
    tmp = ckpt_dir + ".tmp"
    if rank0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    fds = dict(_keyed(fd_tree))
    tds = dict(_keyed(td_tree)) if td_tree is not None else {}
    manifest: Dict[str, Any] = {"leaves": [], "extra": extra or {}}
    for name, key, leaf in manifest_records(params, opt, ef):
        if isinstance(leaf, int):  # the optimizer's step
            arr, dtype = np.asarray(leaf, dtype=np.int32), "int32"
        else:
            pkey = key[5:] if name == "opt" else key
            full = st.gather_tree(leaf, fds[pkey], fabric, tds.get(pkey), model)
            dtype = str(full.dtype).removeprefix("torch.")
            arr = full.detach().to("cpu", torch.float32 if full.dtype == torch.bfloat16
                                   else full.dtype).numpy() if rank0 else None
            del full
        if rank0:
            fname = file_name(name, key)
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({"tree": name, "key": key, "file": fname,
                                       "dtype": dtype, "shape": list(arr.shape)})
    if rank0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        os.replace(tmp, ckpt_dir)
    if dist.get_world_size() > 1:
        dist.barrier()


def restore(ckpt_dir: str, setup: st.TrainSetup, mesh, params_tpl, device
            ) -> Tuple[Any, Any, Any, Dict]:
    """(params, opt, ef, extra) of this rank, re-sharded for ``setup`` on
    ``mesh`` (which may differ from what the checkpoint was saved under);
    ``params_tpl`` is a tree of the global parameters (on the meta device
    will do).  Each array is memory-mapped and only this rank's slice is
    read.  Leaves come back in their manifest dtype, the moments and ``ef``
    in f32.  A checkpoint without ``ef`` restored where the setup keeps one
    (FSDP -> HSDP with compression) starts it at zeros."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    recs = {(r["tree"], r["key"]): r for r in manifest["leaves"]}
    fab = st.fabric_of(setup, mesh)
    model = st.ModelAxis.from_mesh(mesh)
    fd_tree, td_tree = st.meta_trees(params_tpl, rails=fab.axes, n_rails=fab.n_shards,
                                     model_size=st.model_size_of(mesh))
    fds, tds = dict(_keyed(fd_tree)), dict(_keyed(td_tree))
    index, n = fab.axis_index(), fab.n_shards

    def block(arr, dim, i: int, k: int):
        size = arr.shape[dim] // k
        return arr[(slice(None),) * dim + (slice(i * size, (i + 1) * size),)]

    def load(tree: str, key: str, fd, td) -> torch.Tensor:
        rec = recs[(tree, key)]
        arr = np.load(os.path.join(ckpt_dir, rec["file"]), mmap_mode="r")
        if td is not None and model.active:
            arr = block(arr, td, model.rank, model.size)
        if fd is not None and n > 1:
            arr = block(arr, fd, index, n)
        return torch.from_numpy(np.array(arr)).to(device).to(getattr(torch, rec["dtype"]))

    keys = _keystr_tree(params_tpl)

    def place(tree: str, prefix: str = ""):
        return tree_map(lambda k: load(tree, prefix + k, fds[k], tds[k]), keys)

    params = place("params")
    opt = {"m": place("opt", "['m']"), "v": place("opt", "['v']"),
           "step": int(np.load(os.path.join(ckpt_dir, recs[("opt", "['step']")]["file"])))}
    if any(t == "ef" for t, _ in recs):
        ef = place("ef")
    else:
        ef = st.ef_init(setup, params)
    return params, opt, ef, manifest["extra"]
