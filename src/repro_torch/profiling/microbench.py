"""Time the kernels and the step phases (port of
``repro.profiling.microbench``).

Every sample pairs a trimmed-mean time (warmup discarded) with the FLOPs
that ``analysis.cost`` counts over the plain versions on the "meta" device,
so the fit in ``analysis.calibrate`` regresses measured seconds against the
same work whichever implementation ran.  On the card each call is timed with
CUDA events (synchronised after each call); on the CPU with ``perf_counter``.

Three case families:

* **kernel cases**: ``ops.mha`` / ``ops.decode_attention`` / ``ops.ssd``
  over the attention and SSD shape classes of the configs' catalog, swept
  over the sequence length, f32 inputs as in the JAX package, timed by
  CUDA events around each call (a call of a few microseconds' work is
  mostly launch latency).  Bytes are the inputs' and outputs'
  (``cost.io_bytes``).  On the card each case must launch its CUDA kernel
  once a call (``ops.launch_counts``), and its last output must agree with
  the plain version's on the same inputs (``ref.tolerance_ratio`` or
  ``ref.ssd_tolerance_ratio`` at most 1), or it raises;
* **phase cases**: ``lm_loss`` forward, its gradient, last-only prefill
  and one-token decode on catalog configs, measured at 2 and 4 periods deep
  and depth-differenced, so the per-layer cost is clean of embed/unembed;
  bytes from ``analysis.memmodel`` for that phase at tp=1, dp=1,
  depth-differenced the same way.  On the card a phase's time is its
  kernels' time a call as torch.profiler sees it: at B=1 S=1024 the eager
  host launches slower than the card runs, and the wall time, kept in the
  provenance beside it, measures the host;
* **sharded step**: the port's ``make_train_step`` on a one-rank (data,
  model) mesh, llama3-8b smoke, batch 8 x 128, timed as the phases are.
  Its size is the JAX package's: it records that the sharded step runs,
  not a full-width step's cost.

No failure becomes a record: a case that fails raises.  The only skipped
records are the JAX package's by design: a VLM or audio configuration is
not phase-calibrated (it needs patches or frames), and a non-positive depth
difference is recorded as skipped.

``run_suite`` returns a ``TimingArtifact`` in the JAX package's format, with
provenance: torch and CUDA versions, the card's ``nvidia-smi`` name and
power limit, the kernels' launch counts before and after, and a hash of the
kernel sources (CUDA included).
"""
from __future__ import annotations

import gc
import glob
import hashlib
import os
import platform
import subprocess
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import memmodel
from repro_torch.analysis.calibrate import TimingArtifact, TimingRecord
from repro_torch.analysis.cost import counted_flops, io_bytes
from repro_torch.configs.base import ASSIGNED_ARCHS, ShapeConfig, get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tf
from repro_torch.train.step import period_leaves
from repro_torch.tree import leaves

#: catalog names the kernel shape classes are derived from
CATALOG = ASSIGNED_ARCHS + ("llama3_8b", "llama_80b")

#: configs the step phases are measured on (dense / MoE / SSM coverage)
DEFAULT_PHASE_CONFIGS = ("llama3_8b", "deepseek_moe_16b", "mamba2_370m")

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the sources a timing depends on, as globs under the package
_HASHED_GLOBS = ("kernels/**/*.py", "kernels/**/*.cu", "kernels/**/*.cuh", "models/*.py",
                 "train/step.py", "serve/step.py")


def hashed_sources() -> List[str]:
    """Every kernel source (Python and CUDA), the models and the steps,
    relative to the package, sorted."""
    return sorted({os.path.relpath(path, _PACKAGE) for pattern in _HASHED_GLOBS
                   for path in glob.glob(os.path.join(_PACKAGE, pattern), recursive=True)})


def kernel_hash() -> str:
    """sha256 (truncated) over ``hashed_sources()``, names and contents:
    provenance, so a stale table is detectable."""
    h = hashlib.sha256()
    for rel in hashed_sources():
        h.update(rel.encode() + b"\0")
        with open(os.path.join(_PACKAGE, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# measurement core
# ---------------------------------------------------------------------------


def _time(fn, args, device: torch.device, *, repeats: int, warmup: int, trim: int):
    """(trimmed-mean seconds, min seconds, the last call's output).  On the
    card, CUDA events around each call, synchronised after it.  Python's
    garbage collector is off while the calls are timed, as ``timeit`` does:
    an eager call's host time is part of what is measured, a collection of
    other objects' cycles is not."""
    for _ in range(warmup):
        fn(*args)
    ts = []
    collecting = gc.isenabled()
    gc.disable()
    try:
        for _ in range(repeats):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                out = fn(*args)
                ts.append(time.perf_counter() - t0)
    finally:
        if collecting:
            gc.enable()
    ts.sort()
    core = ts[trim:len(ts) - trim] or ts
    return sum(core) / len(core), ts[0], out


def _device_seconds(fn, args, repeats: int) -> float:
    """Kernel time of one call of ``fn`` on the card, as torch.profiler sees
    it over ``repeats`` calls (after ``_time``'s warmup): the gaps where the
    card waits for the host are left out.  A kernel's time is its mean time
    a launch times its launches a call (launches seen / ``repeats``,
    rounded), so a profile that lost a few calls' records still reads one
    call.  Raises where the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn(*args)
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        per_call = round(e.count / repeats)
        total_us += us / e.count * per_call if per_call else us / repeats
    if total_us <= 0:
        raise RuntimeError("torch.profiler saw no kernel time on the card")
    return total_us / 1e6


def _phase_seconds(fn, args, device, *, repeats: int, warmup: int, trim: int):
    """(seconds a call the record takes, wall seconds a call): on the card
    the kernels' time (``_device_seconds``) beside the CUDA events' trimmed
    mean; on the CPU the trimmed mean for both."""
    wall, _, _ = _time(fn, args, device, repeats=repeats, warmup=warmup, trim=trim)
    if device.type != "cuda":
        return wall, wall
    return _device_seconds(fn, args, repeats), wall


@dataclass
class BenchCase:
    """One timeable (kernel, shape) cell; ``make(device)`` builds (fn, args).
    ``key`` is the kernel's name in ``ops.launch_counts``; ``plain(*args)``
    is the plain version's output on the same inputs and ``ratio(out,
    want)`` the tolerance ratio ``out`` is held to (at most 1)."""

    key: str
    shape_class: str
    shape: Dict[str, object]
    make: Callable[[torch.device], Tuple[Callable, tuple]]
    plain: Callable
    ratio: Callable[[object, object], float]


def measure_case(case: BenchCase, device, *, repeats: int = 5, warmup: int = 2,
                 trim: int = 1) -> Tuple[TimingRecord, float]:
    """Measure one case: (its record, its last output's tolerance ratio
    against the plain version).  A failure raises, and so does an output
    that disagrees with the plain version; on the card, so does a case
    whose kernel did not launch once a call."""
    device = torch.device(device)
    fn, args = case.make(device)
    flops = counted_flops(fn, *args)
    before = ops.launch_counts()[case.key]
    t_mean, t_min, out = _time(fn, args, device, repeats=repeats, warmup=warmup, trim=trim)
    launched = ops.launch_counts()[case.key] - before
    if device.type == "cuda" and launched != warmup + repeats:
        raise RuntimeError(f"{case.key} {case.shape}: {launched} kernel launches for "
                           f"{warmup + repeats} calls")
    ratio = case.ratio(out, case.plain(*args))
    if not ratio <= 1.0:
        raise RuntimeError(f"{case.key} {case.shape}: the output disagrees with the plain "
                           f"version (tolerance ratio {ratio:.4g} > 1)")
    return (TimingRecord(case.key, case.shape_class, case.shape, float(flops),
                         float(io_bytes(args, out)), t_mean, t_min, repeats), ratio)


# ---------------------------------------------------------------------------
# kernel cases from the configs' catalog
# ---------------------------------------------------------------------------


def _attn_classes(smoke: bool) -> List[Tuple[int, int, int]]:
    seen = []
    for name in CATALOG:
        cfg = get_config(name, smoke=smoke)
        if not cfg.n_heads:
            continue
        cls = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
        if cls not in seen:
            seen.append(cls)
    return sorted(seen)


def _ssd_classes(smoke: bool) -> List[Tuple[int, int, int, int, int]]:
    seen = []
    for name in CATALOG:
        cfg = get_config(name, smoke=smoke)
        if cfg.ssm is None:
            continue
        d_inner = cfg.ssm.expand * cfg.d_model
        h = d_inner // cfg.ssm.head_dim
        cls = (h, cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.n_groups, cfg.ssm.chunk_size)
        if cls not in seen:
            seen.append(cls)
    return sorted(seen)


def _normal(gen, device, *shape, scale: float = 1.0):
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale


def _ssd_ratio(got, want) -> float:
    return max(ref.ssd_tolerance_ratio(got[0], want[0]),
               ref.ssd_tolerance_ratio(got[1], want[1], head_dim=1))


def kernel_cases(smoke: bool = True) -> List[BenchCase]:
    """Kernel cells over the catalog's attention and SSD shape classes.

    ``smoke=True`` uses the catalog's smoke shapes (a CPU run in seconds);
    ``smoke=False`` the full configurations' classes, for the card."""
    cases: List[BenchCase] = []
    seqs = (128, 256, 512) if smoke else (512, 1024, 2048)
    b = 4 if smoke else 1

    for (h, kv, dh) in _attn_classes(smoke):
        cls = f"h{h}kv{kv}d{dh}"
        for s in seqs:
            def mk(device, s=s, h=h, kv=kv, dh=dh):
                gen = torch.Generator(device=device).manual_seed(0)
                q = _normal(gen, device, b, s, h, dh, scale=0.5)
                k = _normal(gen, device, b, s, kv, dh, scale=0.5)
                v = _normal(gen, device, b, s, kv, dh, scale=0.5)

                def fn(q, k, v):
                    return ops.mha(q, k, v, causal=True)
                return fn, (q, k, v)
            cases.append(BenchCase("flash_attention", cls,
                                   {"b": b, "s": s, "h": h, "kv": kv, "dh": dh}, mk,
                                   lambda q, k, v: ref.mha(q, k, v, causal=True),
                                   ref.tolerance_ratio))
        for c in seqs:
            def mk(device, c=c, h=h, kv=kv, dh=dh):
                gen = torch.Generator(device=device).manual_seed(0)
                q = _normal(gen, device, 2 * b, 1, h, dh, scale=0.5)
                kc = _normal(gen, device, 2 * b, c, kv, dh, scale=0.5)
                vc = _normal(gen, device, 2 * b, c, kv, dh, scale=0.5)
                valid = torch.ones((2 * b, c), dtype=torch.bool, device=device)

                def fn(q, kc, vc, valid):
                    return ops.decode_attention(q, kc, vc, valid)
                return fn, (q, kc, vc, valid)
            cases.append(BenchCase("decode_attention", cls,
                                   {"b": 2 * b, "c": c, "h": h, "kv": kv, "dh": dh}, mk,
                                   ref.decode_attention, ref.tolerance_ratio))

    for (h, p, n, g, chunk) in _ssd_classes(smoke):
        cls = f"h{h}p{p}n{n}g{g}c{chunk}"
        for s in seqs:
            if s % chunk:
                continue

            def mk(device, s=s, h=h, p=p, n=n, g=g, chunk=chunk):
                gen = torch.Generator(device=device).manual_seed(0)
                x = _normal(gen, device, b, s, h, p)
                dt = torch.nn.functional.softplus(_normal(gen, device, b, s, h))
                a = -torch.exp(_normal(gen, device, h, scale=0.5))
                bm = _normal(gen, device, b, s, g, n)
                cm = _normal(gen, device, b, s, g, n)

                def fn(x, dt, a, bm, cm):
                    return ops.ssd(x, dt, a, bm, cm, chunk)
                return fn, (x, dt, a, bm, cm)
            cases.append(BenchCase("ssd_scan", cls,
                                   {"b": b, "s": s, "h": h, "p": p, "n": n, "g": g,
                                    "chunk": chunk}, mk,
                                   lambda x, dt, a, bm, cm, chunk=chunk:
                                       ref.ssd_chunked(x, dt, a, bm, cm, chunk),
                                   _ssd_ratio))
    return cases


# ---------------------------------------------------------------------------
# step phases: depth-differenced per-layer measurements
# ---------------------------------------------------------------------------


def _phase_call(dcfg, params, which: str, batch, device):
    """(fn, args, memmodel shape) of one phase at ``dcfg``'s depth."""
    bsz, seq = batch["tokens"].shape
    if which == "fwd":
        def fn(p_, b_):
            with torch.no_grad():
                return tf.lm_loss(p_, b_, dcfg)[0]
        return fn, (params, batch), ShapeConfig("fwd", seq, bsz, "prefill")
    if which == "step":
        # one leaf a period, as the train step differentiates
        # (``train.step.period_leaves``): no zero gradient of the whole stack
        def fn(p_, b_):
            return torch.autograd.grad(tf.lm_loss(p_, b_, dcfg)[0], leaves(p_))
        return fn, (period_leaves(params), batch), ShapeConfig("step", seq, bsz, "train")
    if which == "prefill":
        def fn(p_, b_):
            with torch.no_grad():
                return tf.lm_forward(p_, b_, dcfg, last_only=True)[0]
        return fn, (params, {"tokens": batch["tokens"]}), ShapeConfig("prefill", seq, bsz,
                                                                      "prefill")
    state = tf.init_decode_state(dcfg, bsz, 256, device=device)
    token = torch.zeros((bsz, 1), dtype=torch.long, device=device)

    def fn(p_, st_, tok_):
        with torch.no_grad():
            return tf.decode_step(p_, st_, tok_, 64, dcfg)[0]
    return fn, (params, state, token), ShapeConfig("decode", 256, bsz, "decode")


_PHASE_OF = {"fwd": "train_fwd", "prefill": "prefill", "decode": "decode"}


def step_phase(cfg, depth: int, *, device="cuda", batch: int = 1, seq: int = 1024):
    """(fn, args) of the gradient-step phase of ``cfg`` cut to ``depth``
    layers, on the phase records' inputs (seed 0)."""
    dcfg = cfg.replace(n_layers=depth)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = {k: torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device)
              for k in ("tokens", "targets")}
    fn, args, _ = _phase_call(dcfg, tf.init_lm(dcfg, seed=0, device=device), "step", tokens,
                              device)
    return fn, args


class OpRecord(TorchDispatchMode):
    """The aten ops a call dispatches (``ops``, a Counter of names such as
    "aten.select_backward") and the bytes of the tensors they return that
    are not views (``allocated``)."""

    def __init__(self):
        super().__init__()
        self.ops, self.allocated = Counter(), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[str(func.overloadpacket)] += 1
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not t._is_view():
                self.allocated += t.numel() * t.element_size()
        return out


def phase_records(configs: Sequence[str] = DEFAULT_PHASE_CONFIGS, *, device="cuda",
                  smoke: bool = True, repeats: int = 5, warmup: int = 2, trim: int = 1,
                  progress: Callable[[str], None] = lambda s: None,
                  per_depth: Optional[Dict[str, List[float]]] = None) -> List[TimingRecord]:
    """Per-layer phase samples for each config, by depth-differencing.

    Each phase is measured at 2 and 4 periods deep; the per-layer slope
    ``(t_deep - t_shallow) / Δlayers`` cancels the embed/unembed/loss work
    that does not scale with depth, and the same difference is taken of the
    FLOPs and the bytes, so time and work stay paired.  ``train_bwd`` is
    (gradient step - forward) per layer.  ``progress`` gets each phase's
    time at each depth, and ``per_depth`` (where given) gets it as
    ``{"<phase> <config> <depth>": [seconds, wall seconds]}``
    (``_phase_seconds``).
    """
    device = torch.device(device)
    out: List[TimingRecord] = []
    for name in configs:
        cfg = get_config(name, smoke=smoke)
        if cfg.family in ("vlm", "audio"):
            continue          # extra modality inputs; not phase-calibrated
        period = len(tf.period_spec(cfg))
        d1, d2 = 2 * period, 4 * period
        bsz, seq = (2, 256) if smoke else (1, 1024)
        gen = torch.Generator(device=device).manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (bsz, seq), generator=gen, device=device)
                 for k in ("tokens", "targets")}
        shape = {"config": name, "batch": bsz, "seq": seq, "depths": [d1, d2]}
        work: Dict[str, Dict[int, Tuple[float, float, float]]] = {}
        for depth in (d1, d2):
            dcfg = cfg.replace(n_layers=depth)
            params = tf.init_lm(dcfg, seed=0, device=device)
            for which in ("fwd", "step", "prefill", "decode"):
                fn, args, sc = _phase_call(dcfg, params, which, batch, device)
                flops = counted_flops(fn, *args)
                t_mean, wall = _phase_seconds(fn, args, device, repeats=repeats,
                                              warmup=warmup, trim=trim)
                progress(f"phase {which} {name} at {depth} layers: {t_mean * 1e3:.4f} ms "
                         f"(wall {wall * 1e3:.4f})")
                if per_depth is not None:
                    per_depth[f"{which} {name} {depth}"] = [t_mean, wall]
                nbytes = memmodel.traffic_for(dcfg, sc, tp=1, dp=1)
                work.setdefault(which, {})[depth] = (t_mean, flops, nbytes)
            del params
        dl = d2 - d1
        per_layer = {w: tuple((v[d2][i] - v[d1][i]) / dl for i in range(3))
                     for w, v in work.items()}
        for which in ("fwd", "prefill", "decode"):
            t_l, f_l, b_l = per_layer[which]
            out.append(_per_layer_record(_PHASE_OF[which], name, shape, t_l, f_l, b_l,
                                         repeats, "non-positive depth difference"))
        tb, fb, bb = (s - f for s, f in zip(per_layer["step"], per_layer["fwd"]))
        out.append(_per_layer_record("train_bwd", name, shape, tb, fb, bb, repeats,
                                     "non-positive step-minus-fwd"))
    return out


def _per_layer_record(key, name, shape, t_l, f_l, b_l, repeats, reason) -> TimingRecord:
    if t_l <= 0.0 or f_l <= 0.0:
        return TimingRecord(key, name, shape, 0.0, 0.0, 0.0, 0.0, repeats, skipped=True,
                            skip_reason=reason)
    return TimingRecord(key, name, shape, f_l, max(b_l, 0.0), t_l, t_l, repeats)


def sharded_step_records(device="cuda", *, repeats: int = 3, warmup: int = 1,
                         trim: int = 0,
                         per_depth: Optional[Dict[str, List[float]]] = None
                         ) -> List[TimingRecord]:
    """The port's train step (FSDP over the rails, the model axis) on a
    one-rank (data, model) mesh: llama3-8b smoke at batch 8 x 128, timed as
    the phases are (``per_depth`` gets ``"sharded step"``).  It forms a
    process group of one where there is none, and destroys it."""
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train
    from repro_torch.train.step import TrainSetup, init_sharded_state, make_train_step

    device = torch.device(device)
    formed = not dist.is_initialized()
    launch_train.init_distributed(device)
    try:
        mesh = launch_train.make_mesh({"data": 1, "model": 1}, device)
        cfg = get_config("llama3_8b", smoke=True)
        setup = TrainSetup(cfg)
        state = init_sharded_state(setup, mesh, seed=0, device=device)
        step = make_train_step(setup, mesh, tf.init_lm(cfg, device="meta"))
        gen = torch.Generator(device=device).manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (8, 128), generator=gen, device=device)
                 for k in ("tokens", "targets")}

        def fn(params, batch):
            return step.grads_fn(params, batch)[0]
        flops = counted_flops(fn, state[0], batch)

        def run(batch):
            return step(*state, batch)
        t_mean, wall = _phase_seconds(run, (batch,), device, repeats=repeats, warmup=warmup,
                                      trim=trim)
        if per_depth is not None:
            per_depth["sharded step"] = [t_mean, wall]
        nbytes = memmodel.traffic_for(cfg, ShapeConfig("sharded", 128, 8, "train"), tp=1, dp=1)
    finally:
        if formed:
            dist.destroy_process_group()
    return [TimingRecord("train_step_sharded", "llama3_8b_smoke",
                         {"mesh": [1, 1], "batch": 8, "seq": 128}, float(flops),
                         float(nbytes), t_mean, t_mean, repeats)]


# ---------------------------------------------------------------------------
# suite
# ---------------------------------------------------------------------------


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "" without one."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except FileNotFoundError:
        return ""
    return res.stdout.strip()


def run_suite(*, device="cuda", smoke: bool = True, repeats: int = 5, warmup: int = 2,
              trim: int = 1, target_gpu: str = "h100",
              phase_configs: Sequence[str] = DEFAULT_PHASE_CONFIGS,
              include_sharded: bool = True,
              progress: Callable[[str], None] = lambda s: None) -> TimingArtifact:
    """Measure everything on ``device`` and return the provenance-stamped
    artifact."""
    device = torch.device(device)
    before = ops.launch_counts()
    records: List[TimingRecord] = []
    ratios: Dict[str, float] = {}
    for case in kernel_cases(smoke):
        progress(f"{case.key} {case.shape_class} {case.shape}")
        rec, ratio = measure_case(case, device, repeats=repeats, warmup=warmup, trim=trim)
        records.append(rec)
        ratios[case.key] = max(ratios.get(case.key, 0.0), ratio)
    per_depth: Dict[str, List[float]] = {}
    records += phase_records(phase_configs, device=device, smoke=smoke, repeats=repeats,
                             warmup=warmup, trim=trim, progress=progress, per_depth=per_depth)
    if include_sharded:
        progress("sharded train step")
        records += sharded_step_records(device, per_depth=per_depth)
    cuda = device.type == "cuda"
    provenance = {
        "host": platform.node(),
        "machine": platform.machine(),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "card": card_line() if cuda else "",
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "launch_counts_before": before,
        "launch_counts_after": ops.launch_counts(),
        "timing": ("kernel cases: CUDA events around each call, trimmed mean (a call of "
                   "microseconds' work is mostly launch latency); phases and the sharded "
                   "step: the kernels' time a call (torch.profiler), the wall time beside "
                   "it in phase_seconds" if cuda else "perf_counter, trimmed mean"),
        "phase_seconds": per_depth,
        "sharded_step": "llama3_8b smoke at 8 x 128: the sharded step runs; not a "
                        "full-width step's cost",
        "max_tolerance_ratio": ratios,
        "kernel_hash": kernel_hash(),
        "target_gpu": target_gpu,
        "smoke": smoke,
        "repeats": repeats,
    }
    return TimingArtifact(provenance=provenance, records=records)
