"""Timed workloads for the fabric simulator.

Turns a JobConfig into a sequence of (CommOp, compute_before) with compute
segments from a roofline estimate over the chosen GPU generation, and
collective durations from ring/EPS bandwidth models.  Hardware presets
follow the paper's evaluation platforms (§5).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.phases import (CommOp, JobConfig, build_phase_table,
                               iteration_schedule, phase_index_of)
from repro_torch.hardware import PROFILES


@dataclass(frozen=True)
class GPUSpec:
    name: str
    flops: float            # peak dense bf16 FLOP/s
    mfu: float              # achieved fraction on compute segments
    scale_out_gbps: float   # per-GPU NIC bandwidth (one direction)
    scale_up_gbps: float    # per-GPU intra-domain bandwidth
    domain: int             # GPUs per scale-up domain
    tdp_w: float = 700.0    # board power (context for the fleet req/s-per-W)


# Derived from the shared per-chip description (repro_torch.hardware.PROFILES,
# DESIGN.md §15) so the simulator and the roofline can never disagree on
# what a chip is; the float values are bit-identical to the seed table.
GPUS: Dict[str, GPUSpec] = {
    name: GPUSpec(p.name, p.flops, p.mfu, p.scale_out_gbps,
                  p.scale_up_gbps, p.domain, tdp_w=p.tdp_w)
    for name, p in PROFILES.items()
}


def layer_flops(model: ModelConfig, tokens: int) -> float:
    """Approximate fwd FLOPs of one layer over ``tokens`` tokens (6ND/L
    style dense estimate; MoE counts active experts only).  SSM/hybrid
    patterns average the mixer cost over one period: a "mamba" entry
    counts the in/out projections, the short conv, and the dominant SSD
    chunk terms — before this the SSD mixer priced at ZERO FLOPs, so a
    pure-SSM config (mamba2_370m) got a zero-second compute denominator
    (defect exposed by the §15 calibration probe)."""
    d, f = model.d_model, model.d_ff
    pattern = model.pattern
    mixer = 0
    for kind in pattern:
        if kind == "mamba" and model.ssm is not None:
            s = model.ssm
            d_in = s.expand * d
            n_h = d_in // s.head_dim
            g, n = s.n_groups, s.state_dim
            # zxBCdt in-projection + out-projection
            mixer += 2 * tokens * d * (2 * d_in + 2 * g * n + n_h) \
                + 2 * tokens * d_in * d
            # depthwise causal conv over (x, B, C) channels
            mixer += 2 * tokens * (d_in + 2 * g * n) * s.conv_width
            # SSD: intra-chunk [L,L] mix + state read/write against N
            mixer += 2 * tokens * s.chunk_size * (g * n + d_in) \
                + 4 * tokens * d_in * n
        else:
            dh = model.resolved_head_dim if model.n_heads else 0
            mixer += 2 * tokens * d * dh * (model.n_heads
                                            + 2 * model.n_kv_heads) \
                + 2 * tokens * model.n_heads * dh * d
    if model.moe:
        de = model.moe.d_expert or f
        act = model.moe.top_k + model.moe.n_shared_experts
        ffn = 2 * tokens * 3 * d * de * act
    else:
        ffn = 2 * tokens * 3 * d * f
    if len(pattern) == 1:
        # single-kind patterns keep the exact integer-sum-then-convert of
        # the original estimate (bit-identity with every committed BENCH)
        return float(mixer + ffn)
    return float(mixer) / len(pattern) + float(ffn)


@dataclass(frozen=True)
class TimedWorkload:
    job: JobConfig
    gpu: GPUSpec
    ops: List[CommOp]
    t_fwd_layer: float
    t_bwd_layer: float
    # build provenance: enough to re-derive this workload under a different
    # compute calibration (repro_torch.analysis.calibrate, DESIGN.md §15)
    kind: str = "train"                  # train | prefill | decode
    batch_slots: int = 1
    prompt_tokens: Optional[int] = None
    calibration: Optional[object] = None  # CalibrationTable or None

    def comm_time(self, op: CommOp, *, bandwidth_gbps: float,
                  base_latency: float = 5e-6) -> float:
        """Collective duration at ``bandwidth_gbps`` per-GPU bandwidth.

        bytes_per_gpu already contains the (n-1)/n ring factor where
        applicable; both ring (photonic) and free-form (EPS) execution are
        bandwidth-bound at the same per-GPU byte count for AG/RS/AR, so the
        fabric difference shows up through *which* bandwidth each phase
        gets (full NIC for the active phase under Opus; shared under static
        port partitioning).
        """
        return base_latency + op.bytes_per_gpu * 8.0 / (bandwidth_gbps * 1e9)

    # -- per-instance derived tables (built once, shared by every engine) --
    #
    # ``build``/``build_serving`` are lru-cached by config identity, so
    # every tenant of a shared (job, gpu) shape receives the SAME
    # TimedWorkload instance; caching the phase table on the instance
    # dedupes phase-table construction across an entire ClusterSim.  The
    # dataclass is frozen but not slotted, so lazily stashing in __dict__
    # (cached_property style) is safe and costs one dict probe thereafter.

    def scheduled_ops(self, scheduler: str = "phase_boundary", *,
                      circuit: bool = False) -> List[CommOp]:
        """The op stream the control plane actually drives: ``ops``
        rewritten by the named :mod:`repro_torch.core.scheduler` for this
        fabric (DESIGN.md §13).  The default scheduler on a non-circuit
        fabric returns ``self.ops`` ITSELF (bit-identity by construction);
        rewritten streams are cached per (scheduler, circuit) so every
        engine and every tenant of a shared workload sees one list."""
        from repro_torch.core.scheduler import get_scheduler
        key = (scheduler, circuit)
        cache = self.__dict__.setdefault("_sched_ops", {})
        try:
            return cache[key]
        except KeyError:
            ops = get_scheduler(scheduler).schedule(self.ops, self.job,
                                                    circuit=circuit)
            cache[key] = ops
            return ops

    def phase_info(self, scheduler: str = "phase_boundary", *,
                   circuit: bool = False):
        """(phase table, uid -> phase-index numpy vector) of the
        scheduled op stream."""
        ops = self.scheduled_ops(scheduler, circuit=circuit)
        if ops is self.ops:
            # unrewritten stream: keep the single legacy slot so no-arg
            # callers (and every default path) share one table
            try:
                return self.__dict__["_phase_info"]
            except KeyError:
                table = build_phase_table(self.ops)
                info = (table, phase_index_of(self.ops, table))
                self.__dict__["_phase_info"] = info
                return info
        cache = self.__dict__.setdefault("_phase_info_by_sched", {})
        key = (scheduler, circuit)
        try:
            return cache[key]
        except KeyError:
            table = build_phase_table(ops)
            info = (table, phase_index_of(ops, table))
            cache[key] = info
            return info

    def shim_table(self, scheduler: str = "phase_boundary", *,
                   circuit: bool = False):
        """Shim-format phase table (core.shim.table_from_ops) of the
        scheduled op stream, shared so a ControlPlane profiling this
        workload skips the rebuild."""
        from repro_torch.core.shim import table_from_ops
        ops = self.scheduled_ops(scheduler, circuit=circuit)
        if ops is self.ops:
            try:
                return self.__dict__["_shim_table"]
            except KeyError:
                table = table_from_ops(self.ops)
                self.__dict__["_shim_table"] = table
                return table
        cache = self.__dict__.setdefault("_shim_table_by_sched", {})
        key = (scheduler, circuit)
        try:
            return cache[key]
        except KeyError:
            table = table_from_ops(ops)
            cache[key] = table
            return table


@lru_cache(maxsize=256)
def build(job: JobConfig, gpu_name: str,
          calibration=None) -> TimedWorkload:
    gpu = GPUS[gpu_name]
    mb_tokens = job.global_batch // job.fsdp // job.microbatches * job.seq_len
    lf = layer_flops(job.model, mb_tokens) / job.tp
    t_fwd = lf / (gpu.flops * gpu.mfu)
    t_bwd = 2.0 * t_fwd
    if calibration is not None:
        # measured per-(phase, shape-class) effective throughput replaces
        # the flat gpu.mfu denominator (DESIGN.md §15); the analytic value
        # stays the fallback for phases the artifact never measured
        from repro_torch.configs.base import canonical
        sc = canonical(job.model.name)
        t_fwd = calibration.compute_time("train_fwd", lf, default=t_fwd,
                                         shape_class=sc)
        t_bwd = calibration.compute_time("train_bwd", 2.0 * lf,
                                         default=t_bwd, shape_class=sc)
    ops = iteration_schedule(job, t_fwd_layer=t_fwd, t_bwd_layer=t_bwd)
    return TimedWorkload(job, gpu, ops, t_fwd, t_bwd,
                         calibration=calibration)


def build_serving(job: JobConfig, gpu_name: str, kind: str, *,
                  batch_slots: int = 1,
                  prompt_tokens: Optional[int] = None,
                  calibration=None) -> TimedWorkload:
    """Timed workload of ONE serving step (DESIGN.md §11).

    ``kind`` selects the serve/step.py shape: ``"prefill"`` processes one
    request's prompt (``prompt_tokens``, default ``job.seq_len``) through
    the forward with per-layer FSDP parameter AllGathers; ``"decode"``
    advances ``batch_slots`` resident sequences one token with per-layer
    activation AllReduces.  The returned workload is what the event
    engine replays to measure a replica's step time — the serving fleet
    is a strict superset of ``simulate(engine="event")``, never a fork.
    """
    from repro_torch.core.phases import serving_schedule
    gpu = GPUS[gpu_name]
    if kind == "prefill":
        tokens = prompt_tokens if prompt_tokens is not None else job.seq_len
    else:
        tokens = batch_slots          # one token per resident slot
    lf = layer_flops(job.model, tokens) / job.tp
    t_layer = lf / (gpu.flops * gpu.mfu)
    if calibration is not None:
        from repro_torch.configs.base import canonical
        t_layer = calibration.compute_time(kind, lf, default=t_layer,
                                           shape_class=canonical(
                                               job.model.name))
    ops = serving_schedule(job, kind, batch_slots=batch_slots,
                           t_layer=t_layer)
    return TimedWorkload(job, gpu, ops, t_layer, 0.0, kind=kind,
                         batch_slots=batch_slots,
                         prompt_tokens=prompt_tokens,
                         calibration=calibration)


def recalibrate(wl: TimedWorkload, calibration) -> TimedWorkload:
    """``wl`` re-derived under ``calibration`` (identity when it already
    carries the same table — the default path rebuilds nothing)."""
    if wl.calibration is calibration:
        return wl
    if wl.kind == "train":
        return build(wl.job, wl.gpu.name, calibration)
    return build_serving(wl.job, wl.gpu.name, wl.kind,
                         batch_slots=wl.batch_slots,
                         prompt_tokens=wl.prompt_tokens,
                         calibration=calibration)
