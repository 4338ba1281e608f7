"""End-to-end iteration simulation: Native EPS vs Opus vs Opus+Provisioning
vs Ideal one-shot (paper §5.2-5.3, Figs 10-14).

Single-timeline model: the rail schedule of one iteration is serialized by
the model's data dependencies (paper §3: phases never overlap on a rail),
so step time = sum of compute segments, collective times at the bandwidth
each mode gives the active phase, and exposed reconfiguration/control time.

Modes — each runs through the real ControlPlane on its natural
SwitchBackend (DESIGN.md §10; override via SimParams.backend/fabric):
  native    electrical PacketSwitch: every link always up, full NIC
            bandwidth per collective, zero reconfig/control cost
            (STATIC shims: classify + route, never write).
  oneshot   circuits patched once at job registration (PatchPanel): NIC
            bandwidth statically split across scale-out dims (optimal
            sqrt-allocation), no reconfigs.  [paper baseline (2),
            following ACTINA]
  opus      in-job reconfiguration at phase boundaries, on-demand: the OCS
            latency + controller barrier are exposed on the critical path
            at every reconfiguration (Alg 1).  CrossbarOCS by default;
            OCSArray for ACOS-style arrays of small sub-switches.
  opus_prov speculative provisioning (Alg 2): reconfiguration starts right
            after the previous phase's last op; exposed delay is
            max(0, T_reconfig - T_window) (§4.2) plus the small async
            control residue.

Engines
  event     DEFAULT: the vectorized array-backed engine (DESIGN.md §12).
            Live iterations replay the timed workload through the REAL
            control plane exactly like the collapsed engine below — the
            same floating-point expressions, read from precomputed per-op
            duration/phase tables — and once the plane's replay cache
            holds a complete steady cycle, every REMAINING iteration is
            applied as one vectorized walk: clock += k * step,
            counters += k * per-iteration-delta (numpy snapshot math in
            ``ControlPlane.bulk_advance``).  Runs that measure the paper's
            two-iteration convention never fast-forward, so every
            committed BENCH counter is byte-identical to the collapsed
            engine; longer runs (``iterations > 2``, ``min_runtime_s``)
            are where the array path pays off.
  event_collapsed  The collapsed per-op engine (PR 2): one representative
            Shim per pipeline way, weighted barriers, one batched plane
            call per op, every op walked live.  Kept as the vectorized
            engine's ground truth (three-way parity tests).
  event_full  The same event engine on an UNCOLLAPSED plane (one Shim and
            one weighted-1 barrier write per rank).  O(ops x ranks)
            Python dispatch; kept as the ground truth the collapsed plane
            is tested bit-identical against (tests/test_plane_collapse).
  analytic  The original closed-form model (digit-diff reconfig counting,
            inlined exposure formulas), kept as a cross-check; the parity
            contract with the event engines is tested in
            tests/test_plane.py and documented in DESIGN.md §4.

Reconfiguration counting matches core.phases.count_reconfigs (digit-diff
at the controller); per-op PP topo_writes cost control time even when no
digits change (paper Fig 11 right).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import phases as ph
from repro_torch.core.fabric import FabricSpec
from repro_torch.core.plane import ControlPlane, build_placement
from repro_torch.core.shim import DEFAULT, PROVISIONING, STATIC
from repro_torch.core.windows import TimedOp, Window, windows_of
from repro_torch.sim.workload import TimedWorkload

MGMT_GBPS = 10.0          # CPU frontend network
MGMT_LAT = 50e-6
# a topo_write with NO phase shift (per-op PP write, suppressed sym write)
# never takes the topology lock: it pipelines with the data plane and costs
# only the shim/controller round trip (paper Fig 11 right: Config 3's
# 6.46% comes purely from these)
PP_OP_CTRL = 0.4e-3


@dataclass(frozen=True)
class SimParams:
    """Simulation knobs.  ``mode`` is now a thin back-compat constructor
    over :class:`~repro_torch.core.fabric.FabricSpec`: the mode string plus
    the legacy latency knobs resolve (via :meth:`fabric_spec`) to the
    declarative switch-hardware spec every layer consumes — the same
    object ``sim.costmodel.rail_fabric`` bills (one spec, both numbers).
    ``backend``/``radix`` override the mode's natural technology;
    ``fabric`` supplies a complete spec directly."""

    mode: str                     # native | oneshot | opus | opus_prov
    ocs_latency: float = 0.0      # seconds per OCS reconfiguration
    # blocking topo_write barrier (default mode).  None -> scale-dependent:
    # flat fan-in (1 ms + 0.8 ms/rank) up to rack scale, hierarchical
    # (8.6 ms x log2 n) beyond — calibrated to Fig 11's 6.13% at 64 ranks
    # while keeping the 512-2048 GPU overheads in Fig 12-14's range.
    ctrl_sync: Optional[float] = None
    ctrl_async: Optional[float] = None  # provisioning residue (~sync/8)
    nic_linkup: float = 0.0       # §5.1 firmware link-up penalty knob
    n_rails: int = 1              # rails (switch instances) the job spans
    backend: Optional[str] = None  # SwitchBackend technology override
    radix: Optional[int] = None   # OCSArray sub-switch radix
    scheduler: Optional[str] = None  # circuit-scheduling granularity (§13)
    fabric: Optional[FabricSpec] = None   # full spec override
    # measured compute calibration (repro_torch.analysis.calibrate, §15): the
    # workload is re-derived under this table before any engine runs;
    # None keeps the analytic gpu.mfu denominator bit-identical to seed
    calibration: Optional[object] = None

    def fabric_spec(self) -> FabricSpec:
        """The declarative fabric behind these params (validated against
        the mode x backend matrix)."""
        if self.fabric is not None:
            spec = self.fabric
            if self.scheduler is not None and \
                    self.scheduler != spec.scheduler:
                from dataclasses import replace
                spec = replace(spec, scheduler=self.scheduler)
            return spec.validate_mode(self.mode)
        return FabricSpec.for_mode(
            self.mode, ocs_latency=self.ocs_latency,
            nic_linkup=self.nic_linkup, n_rails=self.n_rails,
            technology=self.backend, radix=self.radix,
            scheduler=self.scheduler)

    @property
    def static_fabric(self) -> bool:
        """Modes whose circuits never change during the job."""
        return self.mode in ("native", "oneshot")

    def resolved(self, n_ranks: int) -> Tuple[float, float]:
        import math
        if self.ctrl_sync is not None:
            cs = self.ctrl_sync
        else:
            flat = 1e-3 + 0.8e-3 * n_ranks
            tree = 8.6e-3 * math.log2(max(n_ranks, 2))
            cs = min(flat, tree)
        ca = self.ctrl_async if self.ctrl_async is not None else cs / 8.0
        return cs, ca


@dataclass
class SimResult:
    step_time: float
    n_reconfigs: int
    n_topo_writes: int
    exposed_reconfig: float       # reconfig seconds on the critical path
    exposed_control: float
    timeline: List[TimedOp] = field(default_factory=list)
    engine: str = "analytic"
    telemetry: Optional[Dict[str, object]] = None  # ControlPlane.telemetry()

    def windows(self) -> List[Window]:
        return windows_of(self.timeline)


def _static_split(job: ph.JobConfig) -> Dict[str, float]:
    """Ideal one-shot bandwidth shares: optimal for serialized phases is
    proportional to sqrt(total bytes) per dim (Cauchy-Schwarz)."""
    totals: Dict[str, float] = {}
    for op in ph.iteration_schedule(job):
        if op.scale == "scale_out":
            totals[op.dim] = totals.get(op.dim, 0.0) + op.bytes_per_gpu
    if not totals:
        return {}
    import math
    roots = {d: math.sqrt(v) for d, v in totals.items()}
    z = sum(roots.values())
    return {d: r / z for d, r in roots.items()}


def _giant_ring_dilation(job: ph.JobConfig) -> Dict[str, float]:
    """Per-dim effective-bandwidth factor on the §4.2 fallback ring.

    The fallback is ONE static cycle over all N scale-out ports.  A ring
    collective over a k-rank subgroup must forward its traffic through the
    N-k non-members sitting on the cycle, inflating per-link bytes by
    ~N/k — so each dim sees ~k/N of the NIC, strictly worse than both the
    healthy reconfigured fabric and the per-dim one-shot split.
    """
    n = max(job.fsdp * job.cp * job.ep * job.pp, 1)
    ring = {"fsdp": job.fsdp, "dp": job.fsdp, "cp": job.cp, "ep": job.ep,
            "pp": 2}
    return {d: max(min(k, n) / n, 1e-3) for d, k in ring.items()}


def simulate(wl: TimedWorkload, params: SimParams, *,
             engine: Optional[str] = None,
             ocs_fail: Optional[Callable[[int], bool]] = None) -> SimResult:
    """Simulate one steady-state iteration.

    ``engine`` selects the implementation: ``"event"`` (default, EVERY
    mode) is the vectorized array-backed engine on the collapsed control
    plane (DESIGN.md §12), ``"event_collapsed"`` the per-op collapsed
    engine it is tested bit-identical against, ``"event_full"`` the same
    plane uncollapsed (per-rank, O(ranks) dispatch — the parity ground
    truth), ``"analytic"`` the closed-form cross-check.  ``ocs_fail`` is
    the event engines' fault injector (``attempt -> bool``; persistent
    True triggers the §4.2 giant-ring fallback).
    """
    if params.static_fabric:
        assert ocs_fail is None, \
            f"mode={params.mode!r} never reconfigures: nothing to fail"
    if params.calibration is not None:
        from repro_torch.sim.workload import recalibrate
        wl = recalibrate(wl, params.calibration)
    eng = engine if engine is not None else "event"
    if eng == "analytic":
        assert ocs_fail is None, "fault injection needs the event engine"
        assert params.fabric_spec().scheduler == "phase_boundary", \
            "the closed-form model only covers phase-boundary " \
            "scheduling; per-collective rounds need an event engine"
        return _simulate_analytic(wl, params)
    if eng == "event":
        return VectorEngine(wl, params, ocs_fail=ocs_fail).run()
    if eng not in ("event_collapsed", "event_full"):
        raise ValueError(f"unknown engine {eng!r}")
    return _simulate_event(wl, params, ocs_fail,
                           collapse=(eng == "event_collapsed"))


# ---------------------------------------------------------------------------
# event engine: the real control plane under a serialized rail timeline
# ---------------------------------------------------------------------------


# mode string -> shim algorithm: static fabrics route without writing
SHIM_MODE = {"native": STATIC, "oneshot": STATIC,
             "opus": DEFAULT, "opus_prov": PROVISIONING}


def build_plane(job: ph.JobConfig, params: SimParams,
                ocs_fail: Optional[Callable[[int], bool]] = None,
                listeners=(), collapse: bool = False) -> ControlPlane:
    """The simulator's ControlPlane for (job, params) — exposed so callers
    (benchmarks, launchers, scenario drivers) wire the exact same plane."""
    return ControlPlane(job, spec=params.fabric_spec(),
                        mode=SHIM_MODE[params.mode],
                        ocs_fail=ocs_fail, listeners=listeners,
                        collapse=collapse)


def _phase_info(wl: TimedWorkload, scheduler: str = "phase_boundary",
                circuit: bool = False):
    """(phase table, uid -> phase-index vector) for a workload — now keyed
    by CONFIG IDENTITY instead of re-hashing the op tuple: ``workload.
    build``/``build_serving`` are lru-cached per (job, gpu), so every
    tenant of a shared shape holds the same TimedWorkload instance and
    this delegates to its per-instance cache (one phase table per config
    across a whole ClusterSim, zero tuple hashing)."""
    return wl.phase_info(scheduler, circuit=circuit)


def _op_meta(wl: TimedWorkload, params: SimParams,
             scheduler: str = "phase_boundary",
             circuit: bool = False) -> List[tuple]:
    """Precomputed per-op table for the vectorized engine: one entry per
    SCHEDULED op (DESIGN.md §13), ``(kind, op, compute_before,
    dur_healthy, dur_fallback, phase_index)`` with kind 0=mgmt,
    1=scale_up, 2=scale_out.

    Durations are evaluated with EXACTLY the expressions the per-op
    collapsed engine uses (same operand order, same literals), so reading
    them back preserves bit-identical floats.  Cached per (workload
    instance, mode, scheduler): the tables depend only on the job/gpu
    shape, the mode's bandwidth split and the scheduled stream, so a
    256-job cluster sharing one config builds them once."""
    cache = wl.__dict__.setdefault("_op_meta", {})
    key = (params.mode, scheduler, circuit)
    meta = cache.get(key)
    if meta is not None:
        return meta
    job, gpu = wl.job, wl.gpu
    shares = _static_split(job) if params.mode == "oneshot" else {}
    dilation = _giant_ring_dilation(job)
    _, phase_of = wl.phase_info(scheduler, circuit=circuit)
    meta = []
    for op in wl.scheduled_ops(scheduler, circuit=circuit):
        if op.scale == "mgmt":
            dur = MGMT_LAT + op.bytes_per_gpu * 8 / (MGMT_GBPS * 1e9)
            meta.append((0, op, op.compute_before, dur, dur, -1))
        elif op.scale == "scale_up":
            meta.append((1, op, op.compute_before, 0.0, 0.0, -1))
        else:
            bw = gpu.scale_out_gbps
            if shares:
                bw = gpu.scale_out_gbps * max(shares.get(op.dim, 1.0), 1e-3)
            dur_h = wl.comm_time(op, bandwidth_gbps=bw)
            dur_f = wl.comm_time(
                op, bandwidth_gbps=bw * dilation.get(op.dim, 1.0))
            meta.append((2, op, op.compute_before, dur_h, dur_f,
                         int(phase_of[op.uid])))
    cache[key] = meta
    return meta


def _mgmt_op(op, t: float, t0: float, timeline: List[TimedOp]) -> float:
    start = t
    dur = MGMT_LAT + op.bytes_per_gpu * 8 / (MGMT_GBPS * 1e9)
    timeline.append(TimedOp(op, start - t0, start + dur - t0))
    return start + dur


class EventEngine:
    """One job's event-engine run, resumable op by op.

    The former ``_simulate_event`` loop restructured as a generator so the
    cluster scheduler (``repro_torch.sim.cluster``) can interleave many jobs on
    one merged timeline: each ``next()`` on :meth:`events` processes
    exactly one workload op and yields the engine clock.  ``simulate()``
    drains the generator in one go, so a single-job cluster executes the
    IDENTICAL floating-point sequence as the single-job engine (asserted
    bit-exact in tests/test_cluster.py).

    ``plane`` injects a pre-built ControlPlane (cluster mode: shared-rail
    planes with PortAllocator grants); by default the engine builds its
    own private-rail plane, exactly as before.  ``start`` offsets the
    engine clock (a cluster job begins at its admission time); per-
    iteration quantities are all relative to the iteration start, so
    SimResult is offset-invariant in every field except the timeline's
    absolute clock base.
    """

    def __init__(self, wl: TimedWorkload, params: SimParams, *,
                 ocs_fail: Optional[Callable[[int], bool]] = None,
                 collapse: bool = True,
                 plane: Optional[ControlPlane] = None,
                 start: float = 0.0, iterations: Optional[int] = None):
        if iterations is None:
            # static fabrics have no topology state to warm into a cyclic
            # steady state — one iteration IS the steady state (and starts
            # at the engine clock base, so a zero-start run is float-
            # identical to the closed-form model)
            iterations = 1 if params.static_fabric else 2
        assert iterations >= (1 if params.static_fabric else 2), \
            "warmup + at least one measured iteration"
        self.wl = wl
        self.params = params
        # the §13 scheduler axis: the stream the plane drives is the
        # fabric's scheduler applied to the workload's op stream (the
        # default scheduler on this path returns wl.ops ITSELF unless an
        # all-to-all needs the circuit execution tax).  With an injected
        # plane (cluster/fleet mode) the fabric is the plane's — the
        # tenant's mode is never re-validated against it, exactly as
        # before the scheduler axis existed.
        if plane is not None:
            self.circuit = plane.spec.circuit_switched
            self.scheduler = params.scheduler \
                if params.scheduler is not None else "phase_boundary"
        else:
            spec = params.fabric_spec()
            self.circuit = spec.circuit_switched
            self.scheduler = spec.scheduler
        self.ops = wl.scheduled_ops(self.scheduler, circuit=self.circuit)
        self.plane = plane if plane is not None else build_plane(
            wl.job, params, ocs_fail, collapse=collapse)
        self.plane.profile(self.ops, table=wl.shim_table(
            self.scheduler, circuit=self.circuit))
        self.iterations = iterations
        self.t = start
        self.result: Optional[SimResult] = None
        self._started = False
        # completed iterations so far (resumable engines can be preempted
        # mid-run by a maintenance drain; the scenario engine reads this
        # to size the checkpoint-restart remainder — DESIGN.md §14)
        self.iterations_done = 0

    def events(self):
        """Generator: one workload op per step, yielding the clock after
        each; ``self.result`` is populated when it is exhausted."""
        assert not self._started, "events() is single-shot per engine"
        self._started = True
        wl, params, plane = self.wl, self.params, self.plane
        job, gpu = wl.job, wl.gpu
        ctrl_sync, ctrl_async = params.resolved(job.n_gpus)
        _, phase_of = _phase_info(wl, self.scheduler, self.circuit)
        dilation = _giant_ring_dilation(job)  # fault fallback bw factors
        # oneshot: the patched-once fabric splits NIC bandwidth statically
        # across the scale-out dims (same sqrt-allocation, and the same
        # floating-point expression, as the closed-form model)
        shares = _static_split(job) if params.mode == "oneshot" else {}

        t = self.t
        pending_ready: Optional[float] = None   # provisioned reconfig's ACK
        step_time = 0.0
        timeline: List[TimedOp] = []
        n_reconfigs = n_writes = 0
        exposed_r = exposed_c = 0.0
        tel0: Dict[str, object] = {}
        for iteration in range(self.iterations):  # warmup + measured
            # degrade-and-recover (DESIGN.md §14): a demoted job whose
            # rails are clear of outage windows restores the requested
            # topology at the iteration boundary.  Legacy injectors leave
            # plane.fault_model None, so this is a no-op exactly as today.
            if plane.fallback_giant_ring and plane.can_recover(t):
                t = plane.recover(t)
            plane.start_iteration()
            if iteration == self.iterations - 1:
                tel0 = plane.telemetry()  # measured-iteration deltas base
            t0 = t
            timeline = []
            n_reconfigs = n_writes = 0
            exposed_r = exposed_c = 0.0
            prev_phase = -1
            for op in self.ops:
                t += op.compute_before
                if op.scale == "mgmt":
                    t = _mgmt_op(op, t, t0, timeline)
                    self.t = t
                    yield t
                    continue
                if op.scale == "scale_up":
                    self.t = t
                    yield t
                    continue  # TP never touches the rails

                pi = phase_of[op.uid]
                new_phase = pi != prev_phase
                if new_phase and pending_ready is not None:
                    # §4.2: a provisioned reconfiguration is exposed only
                    # past the window; split residue between control and
                    # OCS time
                    exp = max(0.0, pending_ready - t)
                    exposed_c += min(exp, ctrl_async)
                    exposed_r += max(0.0, exp - ctrl_async)
                    t = max(t, pending_ready)
                    pending_ready = None

                # Algorithm 1 on every rank (one batched plane call; the
                # barrier completes at the last class write)
                ev = plane.pre_comm_all(op, now=t)
                write = ev.write if (ev.write is not None
                                     and ev.write.complete) else None
                if write is not None:
                    n_writes += 1
                    if write.reconfigured:
                        # on-demand: barrier + OCS latency fully exposed
                        n_reconfigs += 1
                        exposed_c += ctrl_sync
                        exposed_r += write.ack_time - t
                        t = write.ack_time + ctrl_sync
                    else:
                        # lock-free write (suppressed / per-op PP)
                        exposed_c += PP_OP_CTRL
                        t += PP_OP_CTRL

                # the collective itself, at the mode's bandwidth
                bw = gpu.scale_out_gbps
                if shares:
                    bw = gpu.scale_out_gbps * max(shares.get(op.dim, 1.0),
                                                  1e-3)
                if plane.fallback_giant_ring:
                    # reduced-bandwidth static ring: a k-rank subgroup
                    # ring embedded in the N-port cycle dilutes every link
                    # by the forwarding hops, ~k/N effective bandwidth
                    # (DESIGN.md §5)
                    bw *= dilation.get(op.dim, 1.0)
                start = t
                t = start + wl.comm_time(op, bandwidth_gbps=bw)
                timeline.append(TimedOp(op, start - t0, t - t0))
                prev_phase = pi

                # Algorithm 2 on every rank (provisioning writes ride
                # here, dispatched after the async control residue)
                ev = plane.post_comm_all(op, now=t + ctrl_async)
                write = ev.write if (ev.write is not None
                                     and ev.write.complete) else None
                if write is not None:
                    n_writes += 1
                    if write.reconfigured:
                        n_reconfigs += 1
                        pending_ready = write.ack_time
                    else:
                        exposed_c += PP_OP_CTRL
                        t += PP_OP_CTRL
                self.t = t
                yield t
            step_time = t - t0
            self.iterations_done = iteration + 1
        # plane telemetry counts the WHOLE plane lifetime (job
        # registration + warmup + measured iteration); the "measured"
        # sub-dict is the steady-state per-iteration delta
        tel = plane.telemetry()
        tel["measured"] = {k: tel[k] - tel0[k] for k in tel
                           if isinstance(tel[k], int)
                           and not isinstance(tel[k], bool)}
        tel["calls"] = plane.call_stats()   # perf tracking (BENCH json)
        self.result = SimResult(
            step_time, n_reconfigs, n_writes, exposed_r, exposed_c,
            timeline, engine="event" if plane.collapse else "event_full",
            telemetry=tel)

    def run(self) -> SimResult:
        for _ in self.events():
            pass
        assert self.result is not None
        return self.result


def _simulate_event(wl: TimedWorkload, params: SimParams,
                    ocs_fail: Optional[Callable[[int], bool]],
                    collapse: bool = True) -> SimResult:
    return EventEngine(wl, params, ocs_fail=ocs_fail,
                       collapse=collapse).run()


class VectorEngine(EventEngine):
    """Array-backed engine (DESIGN.md §12): the default behind
    ``engine="event"``.

    Live iterations read precomputed per-op (duration, phase) tables
    (:func:`_op_meta`) instead of re-deriving bandwidth splits per op, but
    advance the clock with the SAME floating-point expressions in the same
    order as :class:`EventEngine` — a two-iteration run is bit-identical
    to the collapsed engine in every float and every counter (the BENCH
    byte-identity contract, tests/test_vector_engine.py).

    Once one full steady iteration has replayed from the plane's schedule
    cache, its effect is captured as (clock delta, numpy counter-delta
    snapshot) and every remaining iteration is applied as ONE vectorized
    walk: ``t += k * step`` and ``ControlPlane.bulk_advance(k)`` — no
    per-op ``next()``, no plane calls.  Integer telemetry of a steady
    iteration is exactly cyclic, so the fast-forwarded counters equal a
    live walk's; the measured-iteration floats are the captured
    iteration's (iteration-relative, hence reusable verbatim).

    ``min_runtime_s`` sizes the run by SIMULATED time instead of a fixed
    iteration count: the engine walks warmup + one captured iteration
    live, then fast-forwards however many cycles reach the target — a
    week-long tenant costs the same wall time as a two-iteration one.
    Fault injection (``ocs_fail``/giant-ring fallback) disables
    fast-forwarding: faulted runs walk every op live, identical to the
    collapsed engine.
    """

    def __init__(self, wl: TimedWorkload, params: SimParams, *,
                 ocs_fail: Optional[Callable[[int], bool]] = None,
                 collapse: bool = True,
                 plane: Optional[ControlPlane] = None,
                 start: float = 0.0, iterations: Optional[int] = None,
                 min_runtime_s: Optional[float] = None):
        if min_runtime_s is not None and iterations is None:
            # runtime-sized runs need warmup + one captured steady
            # iteration even on static fabrics (whose default is 1)
            iterations = 2
        super().__init__(wl, params, ocs_fail=ocs_fail, collapse=collapse,
                         plane=plane, start=start, iterations=iterations)
        assert min_runtime_s is None or min_runtime_s > 0.0, min_runtime_s
        self.min_runtime_s = min_runtime_s
        self.fastforwarded_iterations = 0

    def events(self):
        assert not self._started, "events() is single-shot per engine"
        self._started = True
        wl, params, plane = self.wl, self.params, self.plane
        ctrl_sync, ctrl_async = params.resolved(wl.job.n_gpus)
        meta = _op_meta(wl, params, self.scheduler, self.circuit)
        # fast-forward precondition: a fault injector can fire on any
        # future dispatch, so a faultable plane is never fast-forwarded —
        # EXCEPT a recovering FaultModel, whose flap schedule has a known
        # horizon: past it nothing can perturb the cycle, so after one
        # fully-steady live iteration fast-forward RE-ARMS (DESIGN.md
        # §14).  Legacy callables keep ff permanently off, as before.
        faultable = plane.ocs_fail is not None
        ff_fault = plane.fault_model
        target = None if self.min_runtime_s is None \
            else self.t + self.min_runtime_s

        t = self.t
        pending_ready: Optional[float] = None
        step_time = 0.0
        timeline: List[TimedOp] = []
        n_reconfigs = n_writes = 0
        exposed_r = exposed_c = 0.0
        tel0: Dict[str, object] = {}
        captured = False
        measured: Optional[Dict[str, int]] = None
        snap0 = snap1 = None
        iteration = 0
        steady = 0      # consecutive fully-steady iterations walked
        while True:
            remaining = self.iterations - iteration
            if remaining <= 0 and (target is None or t >= target):
                break
            ff_ok = (not faultable) or (
                ff_fault is not None and ff_fault.recovery
                and not plane.fallback_giant_ring
                and t >= ff_fault.horizon and steady >= 1)
            if captured and ff_ok and plane.replay_ready:
                # the vectorized walk: every remaining iteration replays
                # the captured steady cycle in one array-op advance
                k = max(remaining, 0)
                if target is not None and t < target:
                    k = max(k, math.ceil((target - t) / step_time))
                if k > 0:
                    plane.bulk_advance(snap0, snap1, k)
                    t = t + k * step_time
                    iteration += k
                    self.fastforwarded_iterations += k
                    self.iterations_done = iteration
                    self.t = t
                    yield t
                continue
            # ---- live iteration (bit-identical to EventEngine) ----
            recovered = False
            if plane.fallback_giant_ring and plane.can_recover(t):
                t = plane.recover(t)
                recovered = True
            plane.start_iteration()
            if not captured:
                tel0 = plane.telemetry()
            will_capture = ff_ok and not captured and plane.replay_ready
            if will_capture:
                snap0 = plane.counter_snapshot()
            t0 = t
            timeline = []
            n_reconfigs = n_writes = 0
            exposed_r = exposed_c = 0.0
            prev_phase = -1
            for kind, op, compute, dur_h, dur_f, pi in meta:
                t += compute
                if kind == 0:                       # mgmt
                    timeline.append(TimedOp(op, t - t0, t + dur_h - t0))
                    t += dur_h
                    self.t = t
                    yield t
                    continue
                if kind == 1:                       # scale_up: off-rail
                    self.t = t
                    yield t
                    continue
                new_phase = pi != prev_phase
                if new_phase and pending_ready is not None:
                    exp = max(0.0, pending_ready - t)
                    exposed_c += min(exp, ctrl_async)
                    exposed_r += max(0.0, exp - ctrl_async)
                    t = max(t, pending_ready)
                    pending_ready = None
                ev = plane.pre_comm_all(op, now=t)
                write = ev.write if (ev.write is not None
                                     and ev.write.complete) else None
                if write is not None:
                    n_writes += 1
                    if write.reconfigured:
                        n_reconfigs += 1
                        exposed_c += ctrl_sync
                        exposed_r += write.ack_time - t
                        t = write.ack_time + ctrl_sync
                    else:
                        exposed_c += PP_OP_CTRL
                        t += PP_OP_CTRL
                start = t
                t = start + (dur_f if plane.fallback_giant_ring else dur_h)
                timeline.append(TimedOp(op, start - t0, t - t0))
                prev_phase = pi
                ev = plane.post_comm_all(op, now=t + ctrl_async)
                write = ev.write if (ev.write is not None
                                     and ev.write.complete) else None
                if write is not None:
                    n_writes += 1
                    if write.reconfigured:
                        n_reconfigs += 1
                        pending_ready = write.ack_time
                    else:
                        exposed_c += PP_OP_CTRL
                        t += PP_OP_CTRL
                self.t = t
                yield t
            step_time = t - t0
            iteration += 1
            self.iterations_done = iteration
            # steady = no demotion in force, no recovery this iteration
            # (the first post-repair iteration is transitional: no
            # provisioned reconfig was pending when it started), and the
            # whole iteration ran past the flap horizon
            clean = (not faultable) or (
                ff_fault is not None and not recovered
                and t0 >= ff_fault.horizon
                and not plane.fallback_giant_ring)
            steady = steady + 1 if clean else 0
            if will_capture:
                snap1 = plane.counter_snapshot()
                telc = plane.telemetry()
                measured = {k: telc[k] - tel0[k] for k in telc
                            if isinstance(telc[k], int)
                            and not isinstance(telc[k], bool)}
                captured = True
            if target is not None and step_time <= 0.0:
                raise ValueError(
                    "min_runtime_s on a zero-duration iteration "
                    f"(step_time={step_time!r}) would never terminate")
        tel = plane.telemetry()
        if measured is None:       # no captured steady cycle (fault path)
            measured = {k: tel[k] - tel0[k] for k in tel
                        if isinstance(tel[k], int)
                        and not isinstance(tel[k], bool)}
        tel["measured"] = measured
        tel["calls"] = plane.call_stats()
        self.result = SimResult(
            step_time, n_reconfigs, n_writes, exposed_r, exposed_c,
            timeline, engine="event" if plane.collapse else "event_full",
            telemetry=tel)


# ---------------------------------------------------------------------------
# analytic engine: closed-form cross-check (pre-ControlPlane formulation)
# ---------------------------------------------------------------------------


def _simulate_analytic(wl: TimedWorkload, params: SimParams) -> SimResult:
    job, gpu = wl.job, wl.gpu
    n_ways = job.pp
    circuit = params.fabric_spec().circuit_switched
    ops = wl.scheduled_ops("phase_boundary", circuit=circuit)
    table, phase_of = _phase_info(wl, "phase_boundary", circuit)

    shares = _static_split(job) if params.mode == "oneshot" else {}
    reconf_total = params.ocs_latency + params.nic_linkup
    ctrl_sync, ctrl_async = params.resolved(job.n_gpus)

    t = 0.0
    timeline: List[TimedOp] = []
    # steady state: the topology left by the previous iteration is the
    # last phase's requirement (cyclic, matching count_reconfigs)
    digits: Optional[List[int]] = None
    if table:
        d = [1] * n_ways
        for p in table:
            d = ph.phase_digits(p, d, n_ways)
        digits = d
    n_reconfigs = 0
    n_writes = 0
    exposed_r = 0.0
    exposed_c = 0.0
    prev_phase = -1
    prev_phase_end = 0.0

    for op in ops:
        t += op.compute_before
        if op.scale == "mgmt":
            t = _mgmt_op(op, t, 0.0, timeline)
            continue
        if op.scale == "scale_up":
            continue  # TP never touches the rails

        pi = phase_of[op.uid]
        new_phase = pi != prev_phase
        phase = table[pi]

        if params.mode in ("opus", "opus_prov"):
            # required topology for this phase
            nd = ph.phase_digits(
                phase, digits if digits is not None
                else ph.phase_digits(phase, [1] * n_ways, n_ways), n_ways)
            needs_reconfig = digits is not None and nd != digits
            is_asym_write = op.dim == "pp"
            issues_write = (new_phase or is_asym_write)
            if issues_write:
                n_writes += 1
            if needs_reconfig and new_phase:
                n_reconfigs += 1
                if params.mode == "opus":
                    # on-demand: barrier + OCS latency fully exposed
                    delay = ctrl_sync + reconf_total
                    exposed_c += ctrl_sync
                    exposed_r += reconf_total
                    t += delay
                else:
                    # provisioning: reconfig started right after the
                    # previous phase ended; window hides it
                    ready = prev_phase_end + ctrl_async + reconf_total
                    hidden_start = max(t, ready)
                    exp = max(0.0, ready - t)
                    # split exposure between control residue and OCS
                    exposed_c += min(exp, ctrl_async)
                    exposed_r += max(0.0, exp - ctrl_async)
                    t = hidden_start
            elif issues_write:
                # lock-free write (suppressed / per-op PP, digits unchanged)
                exposed_c += PP_OP_CTRL
                t += PP_OP_CTRL
            digits = nd

        # collective duration at the mode's bandwidth
        bw = gpu.scale_out_gbps
        if params.mode == "oneshot":
            bw = gpu.scale_out_gbps * max(shares.get(op.dim, 1.0), 1e-3)
        dur = wl.comm_time(op, bandwidth_gbps=bw)
        start = t
        t = start + dur
        timeline.append(TimedOp(op, start, t))
        if pi != prev_phase:
            prev_phase = pi
        prev_phase_end = t

    return SimResult(t, n_reconfigs, n_writes, exposed_r, exposed_c,
                     timeline, engine="analytic")


# modes whose step time does not depend on the OCS reconfiguration
# latency: they are simulated ONCE per sweep and replicated across points
LATENCY_INVARIANT_MODES = ("native", "oneshot")


def sweep_latency(wl: TimedWorkload, latencies: List[float],
                  modes: Tuple[str, ...] = ("native", "opus", "opus_prov"),
                  engine: Optional[str] = None,
                  **kw) -> Dict[str, List[Tuple[float, float]]]:
    out: Dict[str, List[Tuple[float, float]]] = {m: [] for m in modes}
    for m in modes:
        if m in LATENCY_INVARIANT_MODES:
            r = simulate(wl, SimParams(mode=m, **kw), engine=engine)
            out[m] = [(lat, r.step_time) for lat in latencies]
            continue
        for lat in latencies:
            r = simulate(wl, SimParams(mode=m, ocs_latency=lat, **kw),
                         engine=engine)
            out[m].append((lat, r.step_time))
    return out


def mesh_plane_profile(model_cfg, axis_sizes: Dict[str, int], *,
                       global_batch: int, seq_len: int, gpu: str = "h200",
                       ocs_latency: float = 0.01) -> Dict[str, object]:
    """Control-plane profile of a mesh-shaped training job — THE shared
    mesh-axes -> JobConfig mapping used by ``launch/train.py
    --plane-report`` and ``launch/dryrun.py`` cell records.

    TP = the ``model`` axis; FSDP = ``data`` x ``pod``; one simulated
    steady-state iteration through the real control plane (event engine).
    Returns a JSON-safe summary dict.
    """
    from repro_torch.sim.workload import build as build_wl
    tp = axis_sizes.get("model", 1)
    dp = axis_sizes.get("data", 1) * axis_sizes.get("pod", 1)
    job = ph.JobConfig(model=model_cfg, tp=tp, fsdp=dp,
                       global_batch=max(global_batch, dp), seq_len=seq_len)
    wl = build_wl(job, gpu)
    nat = simulate(wl, SimParams(mode="native")).step_time
    r = simulate(wl, SimParams(mode="opus_prov", ocs_latency=ocs_latency))
    m = r.telemetry["measured"]   # steady-state per-iteration counters
    # the job's ACTUAL rail mapping, from the same placement the
    # orchestrators program: a TP-only mesh (fsdp == 1) still owns one
    # port per rail but never drives it — report that honestly instead
    # of an all-zero table with no rail information at all
    placement = build_placement(job)
    ports = sorted(placement.all_ports)
    return {
        "tp": tp, "fsdp": dp, "gpu": gpu,
        "rail_mapping": {
            "scale_up_axis": "model", "scale_up_ways": tp,
            "scale_out_ranks": len(ports),   # ports owned on EVERY rail
            "ports_per_rail": ports,
            "rail_silent": dp == 1,          # no scale-out collectives
        },
        "ocs_latency_s": ocs_latency,
        "modeled_step_s": round(r.step_time, 6),
        # TP-only job (fsdp == 1): no scale-out traffic, nothing to compare
        "overhead_vs_native": (round(r.step_time / nat - 1, 6)
                               if nat > 0 else None),
        "n_reconfigs": r.n_reconfigs,
        "n_topo_writes": r.n_topo_writes,
        "n_barriers": m["n_barriers"],
        "n_dispatches": m["n_dispatches"],
        "n_ports_programmed": m["n_ports_programmed"],
    }


def analytical_estimate(wl: TimedWorkload, ocs_latency: float) -> float:
    """Paper §5.2's naive estimate: T_native + T_reconfig * N_reconfig."""
    native = simulate(wl, SimParams(mode="native")).step_time
    n = ph.count_reconfigs(wl.ops, wl.job.pp)
    return native + ocs_latency * n
