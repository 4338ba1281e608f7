"""Datacenter-scale capacity planner (DESIGN.md §12).

The question every preceding layer exists to answer: *which fabric do I
buy?*  :func:`plan` sweeps a grid of :class:`~repro_torch.core.fabric.
FabricSpec` cells — switch technology x sub-switch radix x shared ports
per rail x allocator policy x rail count, optionally crossed with OCS
reconfiguration latency and circuit-scheduling granularity
(``PlannerConfig.ocs_latencies`` / ``schedulers``, DESIGN.md §13) — and
prices every cell three ways, all through the REAL control plane:

    train    one representative training job on the cell's backend
             (``simulate(engine="event")``): step-time overhead vs the
             electrical-packet native baseline
    cluster  a small multi-tenant mix on the cell's shared port space
             (:mod:`repro_torch.sim.cluster`): queueing delay, utilization,
             switch contention
    serving  a disaggregated prefill/decode fleet on the same rails
             (:mod:`repro_torch.sim.serving`): p99 TTFT, req/s per network-kW
             — skipped on a patch panel (a fleet that cannot repatch
             ports cannot autoscale)

plus the Fig-14 bill (``costmodel.rail_fabric``) at a reference fleet
size, from the SAME spec the simulators timed.  Cells whose radix cannot
physically hold the probe job (an OCSArray circuit would span sub-switch
boundaries) are recorded as infeasible rows, not dropped — the planner's
output is the design space, holes included.

The cells are then reduced to a Pareto frontier over the five objectives
(cost/GPU, power/GPU, training overhead, cluster queueing delay, serving
p99 TTFT — all minimized) with one vectorized numpy dominance pass.  An
objective a cell legitimately lacks (packet clusters never queue on
circuits they don't have; patch panels serve no fleet) is neutral in the
dominance test: it neither saves nor condemns the cell.

Everything is deterministic — the grid is a perf-gated BENCH record
(``benchmarks/run.py --planner``) whose integer counters must match
exactly across machines.  The two headline points the vectorized engine
makes affordable (:func:`headline_points`) ride along: a 100k-GPU
single-job step and a 256-job week-long cluster trace, each in seconds.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import phases as ph
from repro_torch.core.fabric import (CROSSBAR_OCS, OCS_ARRAY, PACKET,
                                   PATCH_PANEL, CrossSubSwitchError)
from repro_torch.core.scheduler import PHASE_BOUNDARY
from repro_torch.sim.costmodel import rail_fabric
from repro_torch.sim.opus_sim import SimParams, simulate
from repro_torch.sim.workload import GPUS, build

# the training mode native to each switch technology: packet rails run
# STATIC shims (nothing to program), a patch panel is the paper's
# one-shot baseline, reconfigurable OCSes run the provisioning shim
TRAIN_MODE = {PACKET: "native", PATCH_PANEL: "oneshot",
              CROSSBAR_OCS: "opus_prov", OCS_ARRAY: "opus_prov"}
# cluster tenants on static fabrics patch once at admission (oneshot);
# native is not a mode a shared circuit cluster admits
CLUSTER_MODE = {PACKET: "oneshot", PATCH_PANEL: "oneshot",
                CROSSBAR_OCS: "opus_prov", OCS_ARRAY: "opus_prov"}

#: objective keys, all minimized, in frontier column order
OBJECTIVES = ("cost_per_gpu", "power_per_gpu", "train_overhead",
              "queueing_delay_s", "p99_ttft_s")


@dataclass(frozen=True)
class PlannerCell:
    """One grid point: the fabric shape a datacenter could buy."""

    backend: str
    radix: Optional[int]
    n_ports: int
    policy: str
    n_rails: int = 1
    ocs_latency: float = 0.01
    scheduler: str = PHASE_BOUNDARY

    @property
    def label(self) -> str:
        r = "" if self.radix is None else f"_r{self.radix}"
        rails = "" if self.n_rails == 1 else f"_{self.n_rails}rails"
        lat = ("" if self.ocs_latency == 0.01
               else f"_{self.ocs_latency * 1e3:g}ms")
        sched = "" if self.scheduler == PHASE_BOUNDARY else "_percoll"
        return (f"{self.backend}{r}_{self.n_ports}p_{self.policy}"
                f"{rails}{lat}{sched}")


@dataclass(frozen=True)
class PlannerConfig:
    """Sweep axes plus the per-cell probe shapes.

    The probes are deliberately small — the planner's job is RELATIVE
    ranking across fabric cells, and every cell sees the identical
    probe, so the frontier is invariant to probe scale (the headline
    points carry the absolute-scale story)."""

    backends: Tuple[Tuple[str, Optional[int]], ...] = (
        (PACKET, None),
        (PATCH_PANEL, None),
        (CROSSBAR_OCS, None),
        (OCS_ARRAY, 16),      # too small for the probe job: infeasible
        (OCS_ARRAY, 64),
    )
    ports_per_rail: Tuple[int, ...] = (64, 96)
    policies: Tuple[str, ...] = ("contiguous", "fragmented")
    rails: Tuple[int, ...] = (1,)
    gpu: str = "h200"
    ocs_latency: float = 0.01
    #: OCS reconfiguration latencies to grid over; empty = just
    #: ``ocs_latency`` (the committed baseline grid)
    ocs_latencies: Tuple[float, ...] = ()
    #: circuit-scheduling granularities (DESIGN.md §13); per_collective
    #: cells are generated for reconfigurable backends only — a static
    #: fabric has no per-round circuits to schedule
    schedulers: Tuple[str, ...] = (PHASE_BOUNDARY,)
    #: reference fleet the Fig-14 bill prices each cell at
    bill_gpus: int = 16384
    #: measured compute calibration (DESIGN.md §15) applied to every
    #: probe's workloads; None keeps the analytic mfu denominator
    calibration: object = None

    # -- train probe: the paper's 512-GPU fabric-sweep job (64 scale-out
    # ranks) — large enough that per-op shim control amortizes and the
    # provisioning OCS beats the one-shot patch panel (Fig 12-13)
    train_model: str = "llama_80b"
    train_tp: int = 8
    train_fsdp: int = 32
    train_pp: int = 2

    # -- cluster probe: a contended catalog mix on the cell's port space
    # (8 x 16-rank tenants on 64-96 shared ports: arrivals queue)
    cluster_jobs: int = 8
    cluster_ranks: int = 16
    cluster_gap: float = 1.0

    # -- serving probe: a short diurnal trace on a small fleet
    serve_duration_s: float = 15.0
    serve_rate: float = 6.0

    def train_job(self) -> ph.JobConfig:
        from repro_torch.configs.base import get_config
        return ph.JobConfig(model=get_config(self.train_model),
                            tp=self.train_tp, fsdp=self.train_fsdp,
                            pp=self.train_pp,
                            global_batch=16 * self.train_fsdp,
                            seq_len=4096, n_microbatch=self.train_pp)

    def cells(self) -> List[PlannerCell]:
        lats = self.ocs_latencies or (self.ocs_latency,)
        return [PlannerCell(backend, radix, n_ports, policy, n_rails,
                            lat, sched)
                for backend, radix in self.backends
                for n_ports in self.ports_per_rail
                for policy in self.policies
                for n_rails in self.rails
                for lat in lats
                for sched in self.schedulers
                if sched == PHASE_BOUNDARY
                or backend in (CROSSBAR_OCS, OCS_ARRAY)]


@dataclass
class PlanResult:
    """The evaluated grid: one row per cell plus the frontier mask."""

    config: PlannerConfig
    rows: List[Dict[str, object]]
    wall_s: float = 0.0
    headline: Dict[str, object] = field(default_factory=dict)

    def frontier_rows(self) -> List[Dict[str, object]]:
        return [r for r in self.rows if r["on_frontier"]]

    def record(self) -> Dict[str, object]:
        """The BENCH-shaped dict (json-safe: no numpy, no inf/nan)."""
        return _json_safe({
            "bench": "opus_planner_fabric_grid",
            "wall_s": round(self.wall_s, 4),
            "n_cells": len(self.rows),
            "n_feasible": sum(1 for r in self.rows if r["feasible"]),
            "n_frontier": sum(1 for r in self.rows if r["on_frontier"]),
            "objectives": list(OBJECTIVES),
            "cells": self.rows,
            "headline": self.headline,
        })


def _json_safe(x):
    """Recursively coerce numpy scalars and non-finite floats for the
    perf-gated JSON record (np.int64 is not JSON-serializable; inf/nan
    are not strict JSON)."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        f = float(x)
        return f if math.isfinite(f) else None
    return x


def pareto_mask(objectives: np.ndarray) -> np.ndarray:
    """Non-dominated mask over ``objectives`` (rows = cells, columns =
    minimized metrics; nan = metric not applicable to that cell).

    One broadcasted dominance pass: cell j dominates cell i when, over
    the columns BOTH cells report, j is <= everywhere and < somewhere.
    A nan column is neutral — it can neither dominate nor be dominated
    on that axis — so packet cells (no circuit queueing) and patch
    panels (no serving fleet) compete on the axes they do have.
    """
    obj = np.asarray(objectives, dtype=np.float64)
    if obj.ndim != 2:
        raise ValueError(f"objectives must be 2-D, got {obj.shape}")
    if obj.size == 0:
        return np.ones(obj.shape[0], dtype=bool)
    a = obj[:, None, :]                    # the candidate being dominated
    b = obj[None, :, :]                    # the potential dominator
    valid = ~(np.isnan(a) | np.isnan(b))
    with np.errstate(invalid="ignore"):
        le = np.where(valid, b <= a, True)
        lt = np.where(valid, b < a, False)
    dominates = le.all(axis=2) & lt.any(axis=2)   # [i, j]: j dominates i
    np.fill_diagonal(dominates, False)
    return ~dominates.any(axis=1)


def _train_point(cell: PlannerCell, cfg: PlannerConfig,
                 cache: Dict[Tuple, object]) -> Dict[str, object]:
    """Step-time overhead of the probe job on this cell's backend.

    Keyed by (backend, radix, n_rails, ocs_latency, scheduler) — the
    train probe owns its whole fabric, so port space and allocator
    policy cannot affect it and the grid shares one simulation per
    distinct hardware shape."""
    key = (cell.backend, cell.radix, cell.n_rails, cell.ocs_latency,
           cell.scheduler)
    if key not in cache:
        wl = build(cfg.train_job(), cfg.gpu, cfg.calibration)
        if "native" not in cache:
            cache["native"] = simulate(wl, SimParams(mode="native"))
        nat = cache["native"].step_time
        mode = TRAIN_MODE[cell.backend]
        params = SimParams(mode=mode, ocs_latency=cell.ocs_latency,
                           n_rails=cell.n_rails, backend=cell.backend,
                           radix=cell.radix,
                           scheduler=(cell.scheduler
                                      if mode in ("opus", "opus_prov")
                                      else None))
        try:
            r = simulate(wl, params)
        except CrossSubSwitchError as e:
            cache[key] = ("infeasible", str(e))
        else:
            cache[key] = ("ok", {
                "mode": mode,
                "modeled_step_s": round(r.step_time, 6),
                "overhead_vs_native": round(r.step_time / nat - 1, 6),
                "n_reconfigs": r.n_reconfigs,
            })
    status, payload = cache[key]
    if status == "infeasible":
        raise CrossSubSwitchError(payload)
    return dict(payload)


def _bill_point(cell: PlannerCell, cfg: PlannerConfig) -> Dict[str, object]:
    spec = SimParams(mode=TRAIN_MODE[cell.backend],
                     ocs_latency=cell.ocs_latency, n_rails=cell.n_rails,
                     backend=cell.backend, radix=cell.radix).fabric_spec()
    bill = rail_fabric(cfg.bill_gpus, GPUS[cfg.gpu].domain, spec)
    return {
        "part": spec.part_name,
        "n_switches": bill.n_switches,
        "cost_per_gpu": round(bill.cost_per_gpu, 4),
        "power_per_gpu": round(bill.power_per_gpu, 4),
    }


def _cluster_point(cell: PlannerCell,
                   cfg: PlannerConfig) -> Optional[Dict[str, object]]:
    from repro_torch.sim.cluster import (ClusterParams, catalog_jobs,
                                   simulate_cluster)
    mode = CLUSTER_MODE[cell.backend]
    specs = catalog_jobs(cfg.cluster_jobs, cfg.cluster_ranks,
                         mean_gap=cfg.cluster_gap, mode=mode)
    res = simulate_cluster(specs, ClusterParams(
        n_ports=cell.n_ports, policy=cell.policy,
        ocs_latency=cell.ocs_latency, gpu=cfg.gpu, n_rails=cell.n_rails,
        backend=cell.backend, radix=cell.radix,
        scheduler=cell.scheduler, calibration=cfg.calibration))
    s = res.summary()
    return {
        "mode": mode,
        "n_done": s["n_done"],
        "n_rejected": s["n_rejected"],
        "mean_queueing_delay": round(s["mean_queueing_delay"], 6),
        "max_queueing_delay": round(s["max_queueing_delay"], 6),
        "peak_utilization": round(s["peak_utilization"], 6),
        "mean_overhead_vs_native": round(s["mean_overhead_vs_native"], 6),
        "n_queued_programs": s["rails"]["n_queued_programs"],
        "queue_wait_s": round(s["rails"]["queue_wait_s"], 6),
    }


def _serving_point(cell: PlannerCell,
                   cfg: PlannerConfig) -> Optional[Dict[str, object]]:
    if cell.backend == PATCH_PANEL:
        return None               # a fleet that cannot repatch ports
    from repro_torch.configs.base import get_config
    from repro_torch.sim.serving import FleetParams, PoolSpec, simulate_fleet
    from repro_torch.sim.traces import TraceParams
    job = ph.JobConfig(model=get_config("llama3_8b"), tp=4, fsdp=4, pp=1,
                       global_batch=16, seq_len=2048, n_microbatch=1)
    prefill = PoolSpec(job, min_replicas=2, max_replicas=4,
                       ref_prompt_tokens=1024)
    decode = PoolSpec(job, min_replicas=1, max_replicas=3, batch_slots=16)
    trace = TraceParams(duration_s=cfg.serve_duration_s,
                        base_rate=cfg.serve_rate, diurnal_amp=0.4,
                        diurnal_period_s=cfg.serve_duration_s,
                        mean_prompt_tokens=1024, max_prompt_tokens=2048,
                        seed=5)
    params = FleetParams(n_ports=cell.n_ports, policy=cell.policy,
                         ocs_latency=cell.ocs_latency, gpu=cfg.gpu,
                         n_rails=cell.n_rails, backend=cell.backend,
                         radix=cell.radix, scheduler=cell.scheduler,
                         calibration=cfg.calibration)
    s = simulate_fleet(params, prefill, decode, trace).summary()
    return {
        "throughput_rps": s["throughput_rps"],
        "p99_ttft_s": s["p99_ttft_s"],
        "peak_gpus": s["peak_gpus"],
        "n_failed_scale_ups": s["n_failed_scale_ups"],
        "rps_per_net_kw": s.get("rps_per_net_kw", 0.0),
    }


def plan(cfg: PlannerConfig = PlannerConfig(), *,
         headline: bool = False) -> PlanResult:
    """Evaluate the grid, mark the Pareto frontier, optionally run the
    two headline scale points."""
    t0 = time.perf_counter()
    rows: List[Dict[str, object]] = []
    train_cache: Dict[Tuple, object] = {}
    for cell in cfg.cells():
        row: Dict[str, object] = {
            "cell": cell.label, "backend": cell.backend,
            "radix": cell.radix, "n_ports": cell.n_ports,
            "policy": cell.policy, "n_rails": cell.n_rails,
            "bill": _bill_point(cell, cfg),
        }
        # non-default grid axes annotate their rows; the committed
        # baseline grid (one latency, phase_boundary) stays byte-stable
        if cell.ocs_latency != cfg.ocs_latency:
            row["ocs_latency"] = cell.ocs_latency
        if cell.scheduler != PHASE_BOUNDARY:
            row["scheduler"] = cell.scheduler
        try:
            row["train"] = _train_point(cell, cfg, train_cache)
        except CrossSubSwitchError as e:
            # the probe job physically cannot be wired on this radix:
            # an honest hole in the design space, kept as a row
            row.update(feasible=False, reason=str(e).split(";")[0],
                       train=None, cluster=None, serving=None,
                       objectives=None, on_frontier=False)
            rows.append(row)
            continue
        row["feasible"] = True
        row["reason"] = None
        row["cluster"] = _cluster_point(cell, cfg)
        row["serving"] = _serving_point(cell, cfg)
        cl, sv = row["cluster"], row["serving"]
        # packet rails hold no circuits: tenants still queue on port
        # space, but the circuit-queueing objective compares switch
        # programming contention, which a packet fabric cannot have
        queueing = (cl["mean_queueing_delay"]
                    if cl is not None and cell.backend != PACKET
                    else math.nan)
        row["objectives"] = {
            "cost_per_gpu": row["bill"]["cost_per_gpu"],
            "power_per_gpu": row["bill"]["power_per_gpu"],
            "train_overhead": row["train"]["overhead_vs_native"],
            "queueing_delay_s": queueing,
            "p99_ttft_s": (sv["p99_ttft_s"] if sv is not None
                           else math.nan),
        }
        rows.append(row)

    feas = [i for i, r in enumerate(rows) if r["feasible"]]
    if feas:
        obj = np.array([[rows[i]["objectives"][k] for k in OBJECTIVES]
                        for i in feas], dtype=np.float64)
        mask = pareto_mask(obj)
        for i, on in zip(feas, mask):
            rows[i]["on_frontier"] = bool(on)
    result = PlanResult(cfg, rows)
    if headline:
        result.headline = headline_points(gpu=cfg.gpu,
                                          ocs_latency=cfg.ocs_latency)
    result.wall_s = time.perf_counter() - t0
    return result


# ---------------------------------------------------------------------------
# the two scale points the vectorized engine buys (DESIGN.md §12)
# ---------------------------------------------------------------------------


def single_job_100k(gpu: str = "h200",
                    ocs_latency: float = 0.01) -> Dict[str, object]:
    """One 100,000-GPU training job (llama_80b, tp=8 x fsdp=6250 x pp=2)
    through the vectorized engine — the paper's §7 scale extrapolated,
    in well under a second of wall clock."""
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    job = ph.JobConfig(model=get_config("llama_80b"), tp=8, fsdp=6250,
                       pp=2, global_batch=16 * 6250, seq_len=4096,
                       n_microbatch=2)
    wl = build(job, gpu)
    nat = simulate(wl, SimParams(mode="native")).step_time
    r = simulate(wl, SimParams(mode="opus_prov", ocs_latency=ocs_latency))
    m = r.telemetry["measured"]
    return {
        "n_gpus": job.n_gpus,
        "engine": r.engine,
        "wall_s": round(time.perf_counter() - t0, 4),
        "modeled_step_s": round(r.step_time, 6),
        "overhead_vs_native": round(r.step_time / nat - 1, 6),
        "n_reconfigs": r.n_reconfigs,
        "n_ports_programmed": m["n_ports_programmed"],
    }


def week_trace_256(gpu: str = "h200",
                   ocs_latency: float = 0.01) -> Dict[str, object]:
    """256 tenants arriving across one week, each holding its ports for
    four simulated hours — the merged numpy timeline fast-forwards every
    steady iteration, so ~300 simulated days of tenancy cost seconds."""
    from repro_torch.sim.cluster import (ClusterParams, catalog_jobs,
                                   simulate_cluster)
    t0 = time.perf_counter()
    week = 7 * 86400.0
    specs = catalog_jobs(256, 16, mean_gap=week / 256, seed=7,
                         runtime_s=4 * 3600.0)
    res = simulate_cluster(specs, ClusterParams(
        n_ports=128, policy="contiguous", ocs_latency=ocs_latency,
        gpu=gpu))
    s = res.summary()
    return {
        "n_jobs": s["n_jobs"],
        "n_done": s["n_done"],
        "n_rejected": s["n_rejected"],
        "wall_s": round(time.perf_counter() - t0, 4),
        "makespan_days": round(s["makespan"] / 86400.0, 4),
        "mean_queueing_delay_s": round(s["mean_queueing_delay"], 4),
        "max_queueing_delay_s": round(s["max_queueing_delay"], 4),
        "peak_utilization": round(s["peak_utilization"], 6),
        "mean_overhead_vs_native":
            round(s["mean_overhead_vs_native"], 6),
        "n_reconfig_events": s["rails"]["n_reconfig_events"],
        "n_queued_programs": s["rails"]["n_queued_programs"],
    }


def headline_points(gpu: str = "h200",
                    ocs_latency: float = 0.01) -> Dict[str, object]:
    return {"single_job_100k": single_job_100k(gpu, ocs_latency),
            "week_trace_256": week_trace_256(gpu, ocs_latency)}
