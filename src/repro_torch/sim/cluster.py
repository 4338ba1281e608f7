"""Multi-job photonic-rail cluster simulator (DESIGN.md §9).

The single-job engine answers "what does reconfiguration cost one
tenant?"; real rail fabrics multiplex MANY concurrent training jobs over
shared rail switches, which makes port allocation and reconfiguration
contention the central systems question (cf. ACOS's arrays of small
OCSes, PCCL's per-collective circuit scheduling).  This module grows the
event engine to that setting:

* every job runs its own REAL ``ControlPlane(collapse=True)`` — shims,
  controller, weighted barriers, schedule-replay cache, exactly the §8
  machinery — registered on SHARED per-rail ``RailOrchestrator``s;
* a :class:`~repro_torch.core.orchestrator.PortAllocator` carves the per-rail
  OCS port space across tenants (contiguous or fragmented policy), with
  utilization/fragmentation telemetry sampled at every admission and
  departure;
* arrivals follow a deterministic Poisson-ish trace (:func:`exp_trace`);
  a job that does not fit queues FIFO and is re-tried at departures
  (head-of-line: admission order is preserved, never reordered);
* all jobs advance on ONE merged event timeline: the scheduler always
  steps the job with the smallest engine clock, so cross-job OCS
  serialization (``SwitchBackend.busy_until``; per sub-switch on an
  ``ocs_array`` rail) resolves in causal order and reconfiguration
  contention shows up as queued programs on the shared switches.

Isolation invariant: one job's ``program()`` never touches another
job's ports — enforced by the orchestrator's port-ownership assertions
on every dispatch path including mid-barrier giant-ring fault demotion,
and asserted end to end in tests/test_cluster.py.  A cluster holding
exactly one job is bit-exact with the single-job engine (same floats,
same telemetry): the cluster is a strict generalization, not a second
simulator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import phases as ph
from repro_torch.core.fabric import FabricSpec, OCSArray
from repro_torch.core.orchestrator import PortAllocator, RailOrchestrator
from repro_torch.core.plane import ControlPlane
from repro_torch.sim.opus_sim import (SHIM_MODE, EventEngine, SimParams, SimResult,
                                VectorEngine, simulate)
from repro_torch.sim.workload import GPUS, build, build_serving


def exp_trace(n: int, mean_gap: float, seed: int = 1) -> List[float]:
    """Deterministic Poisson-ish arrival times: exponential inter-arrival
    gaps by inverted CDF over a fixed LCG stream.  No global RNG and no
    platform dependence — the cluster benchmark commits numbers derived
    from these, so the trace must reproduce bit-exactly everywhere."""
    assert n >= 0 and mean_gap >= 0.0
    x = (seed or 1) & 0x7FFFFFFF
    out: List[float] = []
    t = 0.0
    for _ in range(n):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        u = (x + 1) / 2147483649.0          # strictly inside (0, 1)
        t += -mean_gap * math.log(1.0 - u)
        out.append(t)
    return out


@dataclass(frozen=True)
class ClusterParams:
    """Shared-fabric shape: one switch port space replicated per rail.

    ``backend``/``radix`` select the shared rails' SwitchBackend
    (DESIGN.md §10): the default crossbar, or an ACOS-style ``ocs_array``
    whose radix-limited sub-switches constrain admission (a tenant's
    circuits must fit inside one sub-switch) but reconfigure in parallel.
    ``fabric_spec()`` is the declarative spec — the same object the
    Fig-14 bill in :meth:`ClusterResult.summary` is derived from."""

    n_ports: int                  # per-rail switch port space (all tenants)
    n_rails: int = 1
    policy: str = "contiguous"    # PortAllocator policy
    ocs_latency: float = 0.01
    nic_linkup: float = 0.0
    gpu: str = "h200"
    backend: str = "crossbar_ocs"
    radix: Optional[int] = None   # ocs_array sub-switch radix
    # circuit-scheduling granularity (DESIGN.md §13) for the reconfiguring
    # tenants; oneshot tenants patch circuits once and always run
    # phase_boundary (a static fabric has no rounds to schedule)
    scheduler: str = "phase_boundary"
    # measured compute calibration (DESIGN.md §15); None = analytic mfu
    calibration: object = None

    def fabric_spec(self) -> FabricSpec:
        return FabricSpec(technology=self.backend, n_rails=self.n_rails,
                          reconfig_latency=self.ocs_latency,
                          nic_linkup=self.nic_linkup, radix=self.radix,
                          scheduler=self.scheduler)


@dataclass(frozen=True)
class ClusterJobSpec:
    """One tenant: a paper-style JobConfig plus its arrival."""

    name: str
    job: ph.JobConfig
    arrival: float = 0.0
    mode: str = "opus_prov"       # opus | opus_prov | oneshot
    iterations: int = 2           # warmup + measured, like the engine
    # what the tenant RUNS on its ports: a training iteration (default)
    # or a serving replica's step (DESIGN.md §11) — training and serving
    # share the same rails, so the cluster mix is a spec field, not a
    # separate simulator
    workload: str = "train"       # train | serve_prefill | serve_decode
    batch_slots: int = 16         # resident slots (serve_decode only)
    # minimum SIMULATED runtime: the tenant departs at the first
    # iteration boundary at or past admitted + runtime_s (week-long
    # traces).  The vectorized engine fast-forwards the steady cycles, so
    # a week-long tenant costs the same wall time as a two-iteration one
    # (DESIGN.md §12).  None (default) keeps the fixed iteration count —
    # byte-identical to the pre-runtime cluster.
    runtime_s: Optional[float] = None

    def __post_init__(self):
        assert self.runtime_s is None or self.runtime_s > 0.0, self.runtime_s
        # every tenant drives the real control plane on the shared rails.
        # oneshot tenants run STATIC shims (circuits set once at
        # admission, never reconfigured — zero contention contributed);
        # native is excluded because its always-connected packet fabric
        # is not a circuit switch a photonic rail cluster could share.
        assert self.mode in ("opus", "opus_prov", "oneshot"), self.mode
        assert self.arrival >= 0.0, self.arrival
        assert self.workload in ("train", "serve_prefill", "serve_decode"), \
            self.workload
        if self.workload != "train":
            assert self.job.pp == 1 and self.job.cp == 1 \
                and self.job.ep == 1, \
                "serving tenants are TP x FSDP meshes (serve/step.py)"

    @property
    def n_ranks(self) -> int:
        """Scale-out ranks = ports needed on every rail."""
        return self.job.pp * self.job.fsdp * self.job.cp * self.job.ep


@dataclass
class JobRecord:
    """Lifecycle + outcome of one submitted job."""

    spec: ClusterJobSpec
    ocs_fail: Optional[Callable[[int], bool]] = None
    status: str = "queued"        # queued | running | done | rejected
    admitted: Optional[float] = None
    finished: Optional[float] = None
    ports: Optional[Tuple[int, ...]] = None
    plane: Optional[ControlPlane] = None
    result: Optional[SimResult] = None
    # operations-scenario lifecycle (DESIGN.md §14) — all dormant (and
    # the timeline byte-identical) unless a ScenarioEngine acts:
    first_admitted: Optional[float] = None  # first admission (re-admits
    #                                         overwrite ``admitted``)
    n_drains: int = 0             # checkpoint-restart evictions suffered
    n_migrations: int = 0         # live migrations suffered
    iters_done: int = 0           # iterations completed before preemption
    restart_delay_s: float = 0.0  # checkpoint reload stall on re-admit
    resume_iterations: Optional[int] = None   # remainder after preemption

    @property
    def queueing_delay(self) -> Optional[float]:
        first = self.first_admitted \
            if self.first_admitted is not None else self.admitted
        if first is None:
            return None
        return first - self.spec.arrival


class ClusterSim:
    """N concurrent jobs through shared per-rail OCS port space."""

    #: engine class each tenant runs on — the vectorized array-backed
    #: core by default (bit-identical on fixed-iteration tenants; fast-
    #: forwards ``runtime_s`` tenants).  Parity tests override this with
    #: ``EventEngine`` to prove the cluster numbers are engine-invariant.
    ENGINE_CLS = VectorEngine

    def __init__(self, params: ClusterParams, *,
                 ops: Optional[object] = None, twin: bool = False):
        self.params = params
        self.allocator = PortAllocator(params.n_ports, params.policy)
        self.spec = params.fabric_spec()
        self.rails = [RailOrchestrator(r, self.spec.make_backend(
                          params.n_ports))
                      for r in range(params.n_rails)]
        self.records: List[JobRecord] = []
        self.events: List[Dict[str, object]] = []
        self._ran = False
        # operations-scenario driver (duck-typed — repro_torch.sim.ops supplies
        # the ScenarioEngine; the cluster deliberately does not import it):
        # bind(sim) at run start, then pending()/next_time()/fire(t) merge
        # its events into the timeline and on_event() observes departures.
        # With ops None and twin False every code path below is untouched
        # and the event timeline is byte-identical to the pre-ops cluster.
        self.ops = ops
        self.twin_enabled = twin
        self._twin_rows: List[Dict[str, object]] = []
        # merged-timeline state, instance-held so a scenario engine can
        # preempt/re-queue tenants mid-run (drains, defrag migrations)
        self._pending: List[JobRecord] = []
        self._waiting: List[JobRecord] = []
        self._active: List[Tuple[JobRecord, EventEngine, object, int]] = []
        self._clocks = np.empty(0, dtype=np.float64)
        self._seq = 0

    # -- submission ----------------------------------------------------------
    def submit(self, spec: ClusterJobSpec,
               ocs_fail: Optional[Callable[[int], bool]] = None
               ) -> JobRecord:
        assert not self._ran, "submit before run()"
        assert all(r.spec.name != spec.name for r in self.records), \
            f"duplicate job name {spec.name!r}"
        rec = JobRecord(spec, ocs_fail=ocs_fail)
        self.records.append(rec)
        return rec

    # -- the merged event timeline -------------------------------------------
    def run(self) -> "ClusterResult":
        assert not self._ran, "a ClusterSim runs once"
        self._ran = True
        self._pending = sorted(self.records, key=lambda r: r.spec.arrival)
        # self._active holds (record, engine, op generator, admission seq),
        # appended in seq order and removed in place — so the parallel
        # numpy clock array stays position-aligned and ties resolve to the
        # LOWEST index, which is the earliest admission seq: argmin over
        # the array is exactly the old min(key=(t, seq)) scan, evaluated
        # as one vectorized reduction instead of a Python loop per event
        ops = self.ops
        if ops is not None:
            ops.bind(self)

        while self._pending or self._waiting or self._active or \
                (ops is not None and ops.pending()):
            arrival = self._pending[0].spec.arrival \
                if self._pending else math.inf
            if self._active:
                idx = int(np.argmin(self._clocks))
                clock = float(self._clocks[idx])
            else:
                idx = -1
                clock = math.inf
            if ops is not None and ops.pending():
                # ops events (drain windows opening/closing) fire once the
                # merged timeline reaches them — ops-first on ties, so a
                # window opening at t preempts before an arrival at t is
                # admitted onto ports about to go dark.  Every active
                # engine clock is >= the argmin, so victims stop at a
                # clock at or past the window start (causal preemption).
                op_t = ops.next_time()
                if op_t <= min(arrival, clock):
                    ops.fire(op_t)
                    continue
            if self._pending and arrival <= clock:
                rec = self._pending.pop(0)
                # on an ocs_array rail a tenant's circuits must fit one
                # sub-switch (DESIGN.md §10), so the hard capacity is the
                # radix, not the rail
                cap = self.params.n_ports
                if self.params.backend == "ocs_array" and self.params.radix:
                    cap = min(cap, self.params.radix)
                if rec.spec.n_ranks > cap:
                    rec.status = "rejected"     # can NEVER fit
                    self._sample(rec.spec.arrival, "reject", rec)
                elif self._waiting or not self._admit(rec,
                                                      rec.spec.arrival):
                    # FIFO: an arrival never jumps an earlier queued job
                    self._waiting.append(rec)
                    self._sample(rec.spec.arrival, "queue", rec)
                else:
                    self._activate(rec)
                continue
            if not self._active:
                # the queue head does not fit an otherwise IDLE cluster:
                # on a crossbar that is impossible (a feasible job queues
                # only while others hold its ports), but an ocs_array
                # grant can straddle a sub-switch boundary under the
                # fragmented policy with no tenant left to depart —
                # reject it visibly rather than deadlock, then re-try
                # the rest of the queue on the empty rail.  (Ops events
                # are exhausted here — the ops-first branch above fires
                # them all when no engine clock bounds them — so a drain
                # window can never park ports and strand the queue.)
                now = max((r.finished for r in self.records
                           if r.finished is not None), default=0.0)
                rec = self._waiting.pop(0)
                rec.status = "rejected"
                self._sample(max(now, rec.spec.arrival), "reject", rec)
                while self._waiting and self._admit(
                        self._waiting[0],
                        max(now, self._waiting[0].spec.arrival)):
                    self._activate(self._waiting.pop(0))
                continue
            rec, engine, gen, _ = self._active[idx]
            try:
                next(gen)             # one event of the nearest job (one
                self._clocks[idx] = engine.t  # op, or a fast-forward jump)
            except StopIteration:
                del self._active[idx]   # in-place removal preserves seq
                self._clocks = np.delete(self._clocks, idx)  # argmin order
                self._depart(rec, engine)
                # departures free ports: re-try the FIFO queue head(s)
                self._drain_queue(rec.finished)
        return ClusterResult(self.params, self.records, self.events,
                             self.rails, self.allocator)

    def _activate(self, rec: JobRecord) -> None:
        entry = self._start(rec, self._seq)
        self._active.append(entry)
        self._clocks = np.append(self._clocks, entry[1].t)
        self._seq += 1

    def _drain_queue(self, now: float) -> None:
        """Admit FIFO queue head(s) after ports freed at ``now``."""
        while self._waiting and self._admit(self._waiting[0], now):
            self._activate(self._waiting.pop(0))

    # -- admission / departure ----------------------------------------------
    def _admit(self, rec: JobRecord, now: float) -> bool:
        grant = self.allocator.allocate(rec.spec.name, rec.spec.n_ranks)
        if grant is None:
            return False
        ocs = self.rails[0].ocs
        if isinstance(ocs, OCSArray) and not ocs.fits(grant):
            # ACOS admission effect (DESIGN.md §10): the grant straddles
            # a sub-switch boundary, so the tenant's circuits cannot be
            # wired — hand the ports back and let the job wait for an
            # aligned slot (the fragmentation the big crossbar hides)
            self.allocator.release(rec.spec.name)
            return False
        plane = ControlPlane(rec.spec.job, mode=SHIM_MODE[rec.spec.mode],
                             job_id=rec.spec.name, spec=self.spec,
                             ocs_fail=rec.ocs_fail, collapse=True,
                             orchestrators=self.rails, ports=grant, now=now)
        rec.ports = grant
        rec.admitted = now
        if rec.first_admitted is None:
            rec.first_admitted = now
        rec.status = "running"
        rec.plane = plane           # handed to _start right after
        self._sample(now, "admit", rec)
        return True

    def _build_engine(self, rec: JobRecord, *, start: float,
                      iterations: int) -> EventEngine:
        if rec.spec.workload == "train":
            wl = build(rec.spec.job, self.params.gpu,
                       self.params.calibration)
        else:
            wl = build_serving(rec.spec.job, self.params.gpu,
                               rec.spec.workload.split("_", 1)[1],
                               batch_slots=rec.spec.batch_slots,
                               calibration=self.params.calibration)
        kw = {}
        if rec.spec.runtime_s is not None and rec.resume_iterations is None:
            # runtime-sized tenants need the vectorized engine's fast-
            # forward; the fixed-iteration path works on any engine class.
            # A checkpoint-restarted tenant resumes by ITERATION remainder
            # (the scenario engine sized it), never by re-running runtime.
            kw["min_runtime_s"] = rec.spec.runtime_s
        return self.ENGINE_CLS(
            wl, SimParams(mode=rec.spec.mode,
                          ocs_latency=self.params.ocs_latency,
                          nic_linkup=self.params.nic_linkup,
                          n_rails=self.params.n_rails,
                          backend=self.params.backend,
                          radix=self.params.radix,
                          # static (oneshot) tenants have no rounds to
                          # schedule: they stay on phase_boundary even in
                          # a per_collective cluster
                          scheduler=(self.params.scheduler
                                     if rec.spec.mode in ("opus",
                                                          "opus_prov")
                                     else None)),
            plane=rec.plane, start=start, iterations=iterations, **kw)

    def _start(self, rec: JobRecord,
               seq: int) -> Tuple[JobRecord, EventEngine, object, int]:
        # restart_delay_s/resume_iterations are 0.0/None outside ops
        # scenarios, so this is the pre-ops engine construction verbatim
        # (x + 0.0 is bit-exact for the non-negative admission clock)
        iterations = rec.spec.iterations if rec.resume_iterations is None \
            else rec.resume_iterations
        engine = self._build_engine(
            rec, start=rec.admitted + rec.restart_delay_s,
            iterations=iterations)
        return (rec, engine, engine.events(), seq)

    def _depart(self, rec: JobRecord, engine: EventEngine) -> None:
        rec.finished = engine.t
        rec.result = engine.result
        rec.status = "done"
        rec.plane.release(now=rec.finished)
        self.allocator.release(rec.spec.name)
        self._sample(rec.finished, "depart", rec)
        if self.ops is not None:
            self.ops.on_event(rec.finished, "depart", rec)

    def _sample(self, t: float, event: str, rec: JobRecord) -> None:
        self._note(t, event, rec.spec.name)

    def _note(self, t: float, event: str, job: str) -> None:
        """Append one timeline event row (allocator stats snapshot) — and
        a digital-twin inventory row when twin export is on."""
        self.events.append({"t": t, "event": event, "job": job,
                            **self.allocator.stats()})
        if self.twin_enabled:
            self._twin_tick(t, event, job)

    # -- digital-twin export (DESIGN.md §14) ---------------------------------
    def _twin_tick(self, t: float, event: str, job: str) -> None:
        """One JSONL-able inventory row per event tick: switches, ports,
        circuits, owners — the Turbobulk-style regenerate-and-diff unit."""
        alloc = self.allocator
        self._twin_rows.append({
            "t": t,
            "event": event,
            "job": job,
            "owners": {name: list(g)
                       for name, g in sorted(alloc.grants.items())},
            "reserved": sorted(alloc.reserved),
            "running": sorted(rec.spec.name
                              for rec, _, _, _ in self._active),
            "queued": [r.spec.name for r in self._waiting],
            "switches": [{
                "rail": o.rail_id,
                "technology": self.spec.technology,
                "n_circuits": len(o.ocs.circuits),
                "n_program_calls": o.ocs.n_program_calls,
                "n_ports_programmed": o.ocs.n_ports_programmed,
                "busy_until": o.ocs.busy_until,
            } for o in self.rails],
            "circuits": {str(o.rail_id): o.ocs.circuit_snapshot()
                         for o in self.rails},
        })

    def twin(self) -> List[Dict[str, object]]:
        """The digital-twin inventory rows (``ClusterSim(twin=True)``)."""
        assert self.twin_enabled, "construct ClusterSim(..., twin=True)"
        return self._twin_rows


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


@dataclass
class ClusterResult:
    params: ClusterParams
    jobs: List[JobRecord]
    events: List[Dict[str, object]]
    rails: List[RailOrchestrator]
    allocator: PortAllocator
    _native_cache: Dict[Tuple, float] = field(default_factory=dict)

    def _native_step(self, spec: ClusterJobSpec) -> float:
        key = (spec.job, self.params.gpu)
        if key not in self._native_cache:
            wl = build(spec.job, self.params.gpu,
                       self.params.calibration)
            self._native_cache[key] = simulate(
                wl, SimParams(mode="native")).step_time
        return self._native_cache[key]

    def job_rows(self) -> List[Dict[str, object]]:
        """Per-job outcome: overhead vs native plus lifecycle times."""
        rows = []
        for rec in self.jobs:
            row: Dict[str, object] = {
                "job": rec.spec.name,
                "model": rec.spec.job.model.name,
                "n_gpus": rec.spec.job.n_gpus,
                "n_ranks": rec.spec.n_ranks,
                "status": rec.status,
                "arrival": rec.spec.arrival,
                "queueing_delay": rec.queueing_delay,
            }
            if rec.result is not None:
                m = rec.result.telemetry["measured"]
                nat = self._native_step(rec.spec)
                row.update({
                    "step_time": rec.result.step_time,
                    "overhead_vs_native":
                        rec.result.step_time / nat - 1 if nat > 0 else None,
                    "n_reconfigs": rec.result.n_reconfigs,
                    "n_barriers": m["n_barriers"],
                    "n_ports_programmed": m["n_ports_programmed"],
                })
            rows.append(row)
        return rows

    def peak_concurrent_gpus(self) -> int:
        """Peak GPUs admitted at once (sizes the fabric bill)."""
        deltas: List[Tuple[float, int]] = []
        for rec in self.jobs:
            if rec.admitted is None:
                continue
            deltas.append((rec.admitted, rec.spec.job.n_gpus))
            if rec.finished is not None:
                deltas.append((rec.finished, -rec.spec.job.n_gpus))
        peak = cur = 0
        # departures at time t free ports before an admission at t
        for _, d in sorted(deltas, key=lambda x: (x[0], x[1])):
            cur += d
            peak = max(peak, cur)
        return peak

    def summary(self) -> Dict[str, object]:
        """Cluster-level metrics: every int is deterministic (the perf
        gate exact-matches them); floats are model outputs, equally
        deterministic but gated with a tolerance."""
        done = [r for r in self.jobs if r.status == "done"]
        delays = [r.queueing_delay for r in self.jobs
                  if r.queueing_delay is not None]
        utils = [e["utilization"] for e in self.events]
        frags = [e["fragmentation"] for e in self.events]
        gpu = GPUS[self.params.gpu]
        peak_gpus = self.peak_concurrent_gpus()
        out: Dict[str, object] = {
            "n_jobs": len(self.jobs),
            "n_done": len(done),
            "n_rejected": sum(r.status == "rejected" for r in self.jobs),
            "total_gpus": sum(r.spec.job.n_gpus for r in self.jobs),
            "peak_concurrent_gpus": peak_gpus,
            "makespan": max((r.finished for r in done), default=0.0),
            "mean_queueing_delay": (sum(delays) / len(delays)
                                    if delays else 0.0),
            "max_queueing_delay": max(delays, default=0.0),
            "peak_utilization": max(utils, default=0.0),
            "mean_utilization": (sum(utils) / len(utils)
                                 if utils else 0.0),
            "peak_fragmentation": max(frags, default=0.0),
            "allocator": self.allocator.stats(),
            "rails": {
                "n_reconfig_events": sum(o.n_reconfig_events
                                         for o in self.rails),
                "n_program_calls": sum(o.ocs.n_program_calls
                                       for o in self.rails),
                "n_ports_programmed": sum(o.ocs.n_ports_programmed
                                          for o in self.rails),
                "n_queued_programs": sum(o.ocs.n_queued_programs
                                         for o in self.rails),
                "queue_wait_s": sum(o.ocs.queue_wait_s
                                    for o in self.rails),
            },
        }
        overheads = [row["overhead_vs_native"] for row in self.job_rows()
                     if row.get("overhead_vs_native") is not None]
        out["mean_overhead_vs_native"] = (sum(overheads) / len(overheads)
                                          if overheads else 0.0)
        out["max_overhead_vs_native"] = max(overheads, default=0.0)
        # aggregate network bill at the cluster's peak occupancy (Fig 14
        # model): the photonic side is billed from the SAME FabricSpec
        # the shared rails were simulated on (DESIGN.md §10)
        if peak_gpus > 0:
            from repro_torch.sim.costmodel import OCS_PORTS_PER_LINK, compare
            part = "eps_800g_cpo" if self.params.gpu == "gb200" \
                else "eps_400g"
            spec = replace(self.params.fabric_spec(),
                           ports_per_link=OCS_PORTS_PER_LINK.get(part, 1))
            c = compare(peak_gpus, gpu.domain, part, ocs=spec)
            out["network_bill"] = {
                "eps_part": part,
                "backend": spec.technology,
                "cost_ratio": c["cost_ratio"],
                "power_ratio": c["power_ratio"],
            }
        return out


# ---------------------------------------------------------------------------
# the configs/ catalog as a deterministic tenant mix
# ---------------------------------------------------------------------------

# (model, tp, pp) templates cycled per arriving tenant; fsdp is derived
# from the requested ranks-per-job so every template fits the same grant
CATALOG: Tuple[Tuple[str, int, int], ...] = (
    ("llama3_8b", 8, 2),
    ("gemma_7b", 4, 2),
    ("yi_9b", 8, 4),
    ("llama_80b", 8, 2),
)


def catalog_jobs(n_jobs: int, ranks_per_job: int, *, mean_gap: float = 5.0,
                 seed: int = 1, seq_len: int = 4096,
                 mode: str = "opus_prov",
                 workload: str = "train",
                 runtime_s: Optional[float] = None) -> List[ClusterJobSpec]:
    """The i-th cluster tenant, deterministically: cycle the CATALOG
    templates over a :func:`exp_trace` arrival trace (first arrival
    pinned to t=0 so the cluster never idles at the front).

    ``workload`` stamps every tenant (``train`` default; the serving
    kinds collapse the mesh to TP x FSDP — pipeline stages make no sense
    for a serving replica, the ranks all become scale-out ways)."""
    from repro_torch.configs.base import get_config
    arrivals = [0.0] + exp_trace(max(n_jobs - 1, 0), mean_gap, seed)
    specs = []
    for i in range(n_jobs):
        model_name, tp, pp = CATALOG[i % len(CATALOG)]
        if workload != "train":
            pp = 1
        assert ranks_per_job % pp == 0, (ranks_per_job, pp)
        fsdp = ranks_per_job // pp
        job = ph.JobConfig(model=get_config(model_name), tp=tp, fsdp=fsdp,
                           pp=pp, global_batch=16 * fsdp, seq_len=seq_len,
                           n_microbatch=pp)
        specs.append(ClusterJobSpec(f"job{i}", job, arrival=arrivals[i],
                                    mode=mode, workload=workload,
                                    runtime_s=runtime_s))
    return specs


def simulate_cluster(specs: List[ClusterJobSpec], params: ClusterParams,
                     ocs_fail_by_job: Optional[Dict[str, Callable[[int],
                                                                  bool]]]
                     = None) -> ClusterResult:
    """Convenience driver: submit ``specs`` and run the merged timeline."""
    sim = ClusterSim(params)
    for spec in specs:
        sim.submit(spec, (ocs_fail_by_job or {}).get(spec.name))
    return sim.run()
