"""Multi-pod dry-run: one rank's step of every (arch x shape x mesh x fabric)
cell on the meta device, over a fake process group (port of
``repro.launch.dryrun``).

For each cell this driver forms a fake ``torch.distributed`` group of the
mesh's world size (the fake backend on the "cpu" and "meta" devices: every
collective returns at once and moves nothing), builds the port's
``DeviceMesh`` and the production step (``make_train_step``,
``make_prefill_step`` or ``make_decode_step``, photonic rails by default)
from a parameter template on the meta device, and runs rank 0's step once
on meta tensors: shapes only, nothing is computed or allocated.  It
records:

  * FLOPs: what the step dispatches, counted by ``FlopCounterMode`` (the
    kernels run their plain versions on meta, ``kernels.ops``, as in the
    calibration);
  * collective bytes a rank sends on each mesh axis: the rails ("data",
    "pod") from the step's ``Fabric`` (``bytes_by_axis``), the scale-up
    domain ("model") from its ``ModelAxis`` (``bytes_sent``);
  * a per-device memory fit in place of XLA's ``memory_analysis``: the
    peak of live meta storage during the step (``LiveBytes``), where each
    kernel call counts only the outputs the CUDA kernel allocates, not its
    plain version's intermediates (the plain attention's scores);
  * the roofline's three terms and bottleneck (``analysis.roofline``, the
    ``h100`` profile by default) and the control plane's record
    (``sim.opus_sim.mesh_plane_profile``).

A cell that fails records its error and the run exits 1; none is skipped
but those ``shape_applicable`` rules out, as in the JAX package.

Usage (no GPU, no ``--device``: the dry-run touches no card):
  python -m repro_torch.launch.dryrun --arch yi_9b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--fabric photonic|eps]
Results as JSON under results/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
import weakref
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import flops as flopsa
from repro_torch.analysis import memmodel
from repro_torch.analysis.roofline import from_corrected
from repro_torch.configs.base import (ASSIGNED_ARCHS, SHAPES, ShapeConfig, get_config,
                                      shape_applicable)
from repro_torch.hardware import PROFILES
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf
from repro_torch.serve.step import (ServeSetup, init_serve_state, make_decode_step,
                                    make_prefill_step)
from repro_torch.train import step as st
from repro_torch.train.optimizer import adamw_init

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
OUT = "results/dryrun_torch"
# the kernels' entries in ``ops`` (``KernelCalls``)
KERNEL_ENTRIES = ("mha", "mha_fwd", "mha_bwd", "decode_attention", "decode_attention_fwd",
                  "decode_attention_bwd", "ssd", "ssd_fwd", "ssd_bwd")
# which port quantity fills each key of the record the JAX package writes
FILLED_BY = {
    "corrected_flops": "FlopCounterMode over rank 0's step on the meta device (the kernels' "
                       "plain versions)",
    "corrected_bytes": "analysis.memmodel.traffic_for (the JAX package's roofline bytes)",
    "collectives": "bytes rank 0 sends a step: Fabric.bytes_by_axis (rails), "
                   "ModelAxis.bytes_sent (model), as ring equivalents",
    "memory_analysis": "peak of live meta storage during the step (LiveBytes); "
                       "argument_size: the step's inputs on this rank, temp_size: peak less "
                       "them",
    "roofline": "analysis.roofline.from_corrected of the three above",
    "control_plane": "sim.opus_sim.mesh_plane_profile",
}


class LiveBytes(TorchDispatchMode):
    """Bytes of live tensor storage: ``peak`` over what ran inside the mode.

    ``track`` registers tensors that exist before the step (its inputs);
    every storage an op creates counts from then until it is freed.  Inside
    ``kernel()`` new storages are deferred: at its exit the ones still alive
    (the call's outputs, and what autograd saved of them) count, and those
    freed inside (a plain version's intermediates) never do.
    """

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._refs = {}       # storage key -> (weakref, nbytes, counted)
        self._deferred = []   # keys created inside kernel scopes, innermost last
        self._depth = 0

    def _add(self, t: torch.Tensor, counted: bool) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._refs:
            return
        n = s.nbytes()

        def freed(_, key=key):
            _, nb, was_counted = self._refs.pop(key)
            if was_counted:
                self.live -= nb
        self._refs[key] = (weakref.ref(s, freed), n, counted)
        if counted:
            self.live += n
            self.peak = max(self.peak, self.live)
        else:
            self._deferred.append(key)

    def track(self, tree) -> int:
        """Count the tensors of ``tree`` as live; returns the bytes added."""
        before = self.live
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t, True)
        return self.live - before

    @contextlib.contextmanager
    def kernel(self):
        mark = len(self._deferred)
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            keys, self._deferred = self._deferred[mark:], self._deferred[:mark]
            # a key freed inside may name a later storage at the same address
            for key in dict.fromkeys(keys):
                entry = self._refs.get(key)
                if entry is None or entry[2]:
                    continue
                if self._depth:
                    self._deferred.append(key)
                else:
                    self._refs[key] = (entry[0], entry[1], True)
                    self.live += entry[1]
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t, self._depth == 0)
        return out


def _signature(args, kwargs):
    """A call's key: each tensor's shape, strides, dtype and whether it needs
    a gradient; every other argument as it is."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return ("T", tuple(x.shape), x.stride(), x.dtype, x.requires_grad)
        if isinstance(x, (list, tuple)):
            return tuple(one(v) for v in x)
        return x
    return one(args), tuple(sorted((k, one(v)) for k, v in kwargs.items()))


def _layout(out):
    """``out`` with each tensor as a ``torch.empty_strided`` recipe."""
    if isinstance(out, (list, tuple)):
        return type(out)(_layout(v) for v in out)
    if isinstance(out, torch.Tensor):
        return SimpleNamespace(shape=tuple(out.shape), stride=out.stride(), dtype=out.dtype)
    return out


def _meta_like(layout):
    """Fresh meta tensors of a ``_layout``."""
    if isinstance(layout, (list, tuple)):
        return type(layout)(_meta_like(v) for v in layout)
    if isinstance(layout, SimpleNamespace):
        return torch.empty_strided(layout.shape, layout.stride, dtype=layout.dtype,
                                   device="meta")
    return layout


class KernelCalls:
    """The kernel entries of ``ops`` during a dry-run step: each call runs in
    ``live.kernel()``, so it counts the outputs it leaves and not its plain
    version's intermediates.  A call outside autograd repeats a signature
    seen before (the same layer's attention at every period, its recompute
    under remat) with fresh meta outputs and the FLOPs its first run
    counted, in ``flops``: on meta the plain versions' many small blocks
    take most of a cell's time, and their count depends on shapes only."""

    def __init__(self, live: LiveBytes, counter: FlopCounterMode):
        self.live, self.counter = live, counter
        self.flops = 0
        self._seen = {}

    def _wrap(self, name, fn):
        def call(*a, **kw):
            grad = torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves((a, kw)))
            with self.live.kernel():
                if grad:  # an autograd function: its forward and backward entries repeat
                    return fn(*a, **kw)
                key = (name, _signature(a, kw))
                if key in self._seen:
                    flops, layout = self._seen[key]
                    self.flops += flops
                    return _meta_like(layout)
                before = self.counter.get_total_flops()
                out = fn(*a, **kw)
                self._seen[key] = (self.counter.get_total_flops() - before, _layout(out))
                return out
        return call

    @contextlib.contextmanager
    def installed(self):
        saved = {name: getattr(ops, name) for name in KERNEL_ENTRIES}
        try:
            for name, fn in saved.items():
                setattr(ops, name, self._wrap(name, fn))
            yield self
        finally:
            for name, fn in saved.items():
                setattr(ops, name, fn)


@contextlib.contextmanager
def fake_mesh(axes: dict):
    """A fake process group of the mesh's world size (this process rank 0)
    and its ``DeviceMesh``; the group is destroyed on the way out, after an
    error too.  Refuses to start where a process group exists."""
    if dist.is_initialized():
        raise RuntimeError("a process group exists already: the dry-run forms its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(), rank=0,
                            world_size=math.prod(axes.values()))
    try:
        yield init_device_mesh("cpu", tuple(axes.values()), mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch(cfg, shape: ShapeConfig, targets: bool) -> dict:
    """The global batch on meta: tokens (and targets), a VLM's patches or an
    encoder-decoder's frames."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((b, s), torch.int32)}
    if targets:
        out["targets"] = _meta((b, s), torch.int32)
    extra = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
    if extra:
        out[extra] = _meta((b, cfg.frontend.n_tokens, cfg.frontend.d_embed), torch.float32)
    return out


def _rows(tree, n: int) -> int:
    """Bytes of this rank's 1/n of a batch-major tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) // n


def _shape(shape) -> ShapeConfig:
    return shape if isinstance(shape, ShapeConfig) else SHAPES[shape]


def _cell_cfg(arch: str, shape: ShapeConfig):
    """The configuration a cell runs: training under remat "full", as the
    JAX package's dry-run trains."""
    cfg = get_config(arch)
    return cfg.replace(remat="full") if shape.kind == "train" else cfg


def build_cell(arch: str, shape, mesh, fabric: str = "photonic"):
    """(run, track, fabric, model): ``run()`` calls rank 0's step of the
    cell once; ``track(live)`` registers the parameters, optimizer state and
    caches with a ``LiveBytes`` and returns the bytes of the step's inputs
    on this rank; ``fabric`` and ``model`` are the step's ``Fabric`` and
    ``ModelAxis`` (None where the mesh has no active one)."""
    shape = _shape(shape)
    cfg = _cell_cfg(arch, shape)
    tpl = tf.init_lm(cfg, device="meta")  # shapes and dtypes only, no initialisation
    n_dp = math.prod(st.mesh_axes(mesh)[a] for a in st.dp_axes_of(mesh))

    if shape.kind == "train":
        setup = st.TrainSetup(cfg=cfg, fabric=fabric)
        step = st.make_train_step(setup, mesh, tpl)
        params = st.shard_tree(tpl, step.fd_tree, step.td_tree, step.fabric.axis_index(),
                               step.fabric.n_shards, step.model)
        opt = adamw_init(params)  # f32 moments
        batch = _batch(cfg, shape, targets=True)

        def track(live):
            return live.track((params, opt)) + _rows(batch, n_dp)
        return (lambda: step(params, opt, {}, batch)), track, step.fabric, step.model

    if shape.kind == "prefill":
        setup = ServeSetup(cfg=cfg, fabric=fabric)
        step = make_prefill_step(setup, mesh, tpl)
        params = st.init_sharded_params(cfg, mesh, step.fabric, device="meta")
        batch = _batch(cfg, shape, targets=False)

        def track(live):
            return live.track(params) + _rows(batch, n_dp)
        return (lambda: step(params, batch)), track, step.fabric, step.model

    # decode: context-sharded where the batch is smaller than the rails (long_500k)
    ctx_shard = shape.global_batch < n_dp
    setup = ServeSetup(cfg=cfg, fabric=fabric, context_shard=ctx_shard)
    cap = shape.seq_len
    step = make_decode_step(setup, mesh, tpl, batch=shape.global_batch, capacity=cap)
    params = st.init_sharded_params(cfg, mesh, step.fabric, device="meta")
    state = init_serve_state(setup, mesh, params, shape.global_batch, cap)
    token = _meta((shape.global_batch, 1), torch.int32)
    cross, cross_share = None, 1
    if cfg.encoder is not None:
        # the encoder-decoder's cross K/V, cached at prefill over the whole
        # batch and every head; a batch-sharded rank keeps its rows
        enc = _meta((shape.global_batch, cfg.encoder.n_frontend_tokens, cfg.d_model),
                    getattr(torch, cfg.dtype))
        cross = tf.init_cross_state(tpl, enc, cfg)
        cross_share = 1 if ctx_shard else n_dp

    def track(live):
        return live.track((params, state)) + _rows(cross or {}, cross_share) + \
            _rows(token, 1 if ctx_shard else n_dp)
    return (lambda: step(params, state, token, cap - 1, cross)), track, step.fabric, step.model


def measure(run, track) -> dict:
    """Rank 0's step once under the FLOP counter and the live-bytes tracker:
    {"flops", "peak_bytes", "argument_bytes"}."""
    live = LiveBytes()
    with FlopCounterMode(display=False) as counter, live:
        with KernelCalls(live, counter).installed() as calls:
            args = track(live)
            shares = args - live.live  # inputs this rank holds a share of (batch rows, cross)
            run()
    return {"flops": int(counter.get_total_flops()) + calls.flops,
            "peak_bytes": live.peak + shares, "argument_bytes": args}


def collective_bytes(fabric, model) -> dict:
    """{axis: {"_bytes": n}} of what rank 0 sent, and "total", in the JAX
    package's record shape."""
    out = {a: {"_bytes": n} for a, n in fabric.bytes_by_axis.items()}
    if model is not None and model.active:
        out["model"] = {"_bytes": model.bytes_sent}
    out["total"] = {"_bytes": sum(v["_bytes"] for v in out.values())}
    return out


def plane_record(cfg, shape: ShapeConfig, axis_sizes) -> dict:
    """Control-plane profile of this cell's job (training cells), as the JAX
    package records it beside the roofline."""
    from repro_torch.sim.opus_sim import mesh_plane_profile
    if shape.kind != "train":
        return {"skipped": "control plane profiles training cells only"}
    return mesh_plane_profile(cfg, axis_sizes, global_batch=shape.global_batch,
                              seq_len=shape.seq_len)


def model_flops_for(cfg, shape: ShapeConfig) -> float:
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return flopsa.model_flops_train(cfg, tokens)
    if shape.kind == "prefill":
        return flopsa.model_flops_prefill(cfg, tokens)
    return flopsa.model_flops_decode(cfg, shape.global_batch, shape.seq_len)


def cell_record(arch: str, shape, axes: dict, fabric: str = "photonic",
                profile: str = "h100", mesh_name: str = None) -> dict:
    """The dry-run of one cell on the mesh ``axes`` ({axis: size}, major
    first); ``shape`` a name of ``SHAPES`` or a ``ShapeConfig``.  Returns
    its record, status "ok" (an error propagates)."""
    shape = _shape(shape)
    cfg = _cell_cfg(arch, shape)
    mesh_name = mesh_name or "x".join(str(n) for n in axes.values())
    chips = math.prod(axes.values())
    t0 = time.time()
    with fake_mesh(axes) as mesh:
        run, track, fab, model = build_cell(arch, shape, mesh, fabric)
        t_build = time.time() - t0
        fab.reset_bytes()
        m = measure(run, track)
    t_step = time.time() - t0 - t_build
    coll = collective_bytes(fab, model)
    tp = axes.get("model", 1)
    mem_bytes = memmodel.traffic_for(cfg, shape, tp=tp, dp=chips // tp)
    cost = SimpleNamespace(flops=m["flops"], bytes_accessed=mem_bytes, collective_bytes=coll)
    rl = from_corrected(arch, shape.name, mesh_name, chips, cost, model_flops_for(cfg, shape),
                        profile=PROFILES[profile])
    return {
        "cell": f"{arch}__{shape.name}__{mesh_name}__{fabric}", "status": "ok",
        "t_build_s": round(t_build, 1), "t_step_s": round(t_step, 1),
        "memory_analysis": {"argument_size": m["argument_bytes"],
                            "temp_size": m["peak_bytes"] - m["argument_bytes"],
                            "peak_size": m["peak_bytes"]},
        "corrected_flops": m["flops"], "corrected_bytes": mem_bytes,
        "collectives": coll, "roofline": rl.row(), "profile": profile,
        "control_plane": plane_record(cfg, shape, axes), "filled_by": FILLED_BY,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, fabric: str = "photonic",
             out_dir: str = OUT, profile: str = "h100") -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cfg = get_config(arch)
    cell_id = f"{arch}__{shape_name}__{mesh_name}__{fabric}"
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{cell_id}.json"
    ok, why = shape_applicable(cfg, SHAPES[shape_name])
    if not ok:
        rec = {"cell": cell_id, "status": "skipped", "reason": why}
        path.write_text(json.dumps(rec, indent=1))
        print(f"[skip] {cell_id}: {why}")
        return rec
    try:
        rec = cell_record(arch, shape_name, MESHES[mesh_name], fabric, profile, mesh_name)
    except Exception as e:  # recorded and counted: the run exits 1
        rec = {"cell": cell_id, "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    path.write_text(json.dumps(rec, indent=1))
    if rec["status"] == "ok":
        r = rec["roofline"]
        extra = (f" bottleneck={r['bottleneck']} frac={r['roofline_fraction']:.3f} "
                 f"peak={rec['memory_analysis']['peak_size'] / 2**30:.2f}GiB "
                 f"build={rec['t_build_s']}s step={rec['t_step_s']}s")
    else:
        extra = " " + rec["error"][:160]
    print(f"[{rec['status']}] {cell_id}{extra}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fabric", default="photonic", choices=["photonic", "eps"])
    ap.add_argument("--profile", default="h100", choices=["h100", "tpu_v5e"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    failures = 0
    for arch, shape in cells:
        path = Path(args.out) / f"{arch}__{shape}__{mesh_name}__{args.fabric}.json"
        if args.skip_existing and path.exists():
            rec = json.loads(path.read_text())
            if rec.get("status") in ("ok", "skipped"):
                print(f"[cached] {rec['cell']} {rec['status']}")
                continue
        rec = run_cell(arch, shape, multi_pod=args.multi_pod, fabric=args.fabric,
                       out_dir=args.out, profile=args.profile)
        failures += rec["status"] == "error"
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
