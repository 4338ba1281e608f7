"""Unified control-plane façade (paper §4.1 Fig 7, end to end).

``ControlPlane`` wires the REAL control-plane state machines — one
:class:`~repro_torch.core.shim.Shim` per scale-out rank, the per-job
:class:`~repro_torch.core.controller.Controller`, one
:class:`~repro_torch.core.orchestrator.RailOrchestrator` driving a
:class:`~repro_torch.core.fabric.SwitchBackend` per rail (which backend —
crossbar OCS, ACOS-style OCS array, patch panel, packet switch — comes
from the job's :class:`~repro_torch.core.fabric.FabricSpec`, DESIGN.md
§10) — from a single :class:`~repro_torch.core.phases.JobConfig`, and exposes
the narrow event API the simulator (and any future scenario driver)
programs against:

    plane = ControlPlane(job, n_rails=1, ocs_latency=0.1)
    plane.profile(ops)                       # §4.2 profiling iterations
    ev = plane.pre_comm(rank, op, now=t)     # Algorithm 1
    ev = plane.post_comm(rank, op, now=t)    # Algorithm 2
    ev = plane.pre_comm_all(op, now=t)       # Algorithm 1, every rank
    ev = plane.post_comm_all(op, now=t)      # Algorithm 2, every rank
    plane.telemetry()                        # barriers/dispatches/ports/...

Every simulated number — reconfiguration counts, barrier counts, ports
programmed, giant-ring fallback — is an EMERGENT property of these
machines, never re-derived analytically (DESIGN.md §3).

Rank-equivalence classes (DESIGN.md §8): the op stream is SPMD — ranks
sharing a (way, group-role) coordinate execute byte-identical Action
streams — so ``ControlPlane(job, collapse=True)`` instantiates ONE
representative Shim per pipeline way and issues class-cardinality-weighted
barrier writes instead of per-rank ones.  Telemetry is bit-identical to
the uncollapsed plane (weighted sums over identical per-shim counters);
Python-level dispatch drops from O(ops x ranks) to O(ops x ways).  The
batched ``pre_comm_all``/``post_comm_all`` entry points drive one call per
op on either plane flavour, and after the first (warmup) iteration they
replay the recorded steady-state action schedule instead of re-walking the
unchanged shim state machines.

Placement model: the job's scale-out ranks are laid out way-major,
``rank = way * per_way + ((c * ep) + e) * fsdp + f`` for FSDP coordinate
``f``, CP ``c``, EP ``e`` — so each symmetric dimension forms contiguous
rings on every rail, and every rank owns port ``rank`` on each rail (one
NIC per rail, paper Fig 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.controller import Controller, GroupState, WriteResult
from repro_torch.core.fabric import CrossSubSwitchError, FabricSpec, OCSArray
from repro_torch.core.faults import FaultModel
from repro_torch.core.orchestrator import RailOrchestrator
from repro_torch.core.phases import SYM_DIGITS, CommOp, JobConfig
from repro_torch.core.shim import DEFAULT, STATIC, Action, Shim
from repro_torch.core.topo import PP_DIGIT, JobPlacement, TopoId


@dataclass(frozen=True)
class PlaneEvent:
    """What one shim did for one op at one timestamp."""

    rank: int
    uid: int
    actions: Tuple[Action, ...]
    network: str = ""                 # selected data plane, if any
    waited: bool = False              # hit the topology lock (G1)
    write: Optional[WriteResult] = None   # completed/pending barrier state


def build_placement(job: JobConfig, job_id: str = "job0",
                    ports: Optional[Sequence[int]] = None) -> JobPlacement:
    """One rail's port map for ``job`` (identical on every rail).

    ``ports`` maps the job's way-major rank index to a physical OCS port
    — a ``PortAllocator`` grant in cluster mode (contiguous or scattered;
    the ring structure only needs the index mapping).  Default: identity,
    i.e. the job owns ports ``0..n_ranks-1``.
    """
    fsdp, cp, ep = job.fsdp, job.cp, job.ep
    per_way = fsdp * cp * ep
    n_ranks = job.pp * per_way
    pmap = tuple(range(n_ranks)) if ports is None else tuple(ports)
    assert len(pmap) == n_ranks, \
        f"grant of {len(pmap)} ports for a {n_ranks}-rank job"
    assert len(set(pmap)) == n_ranks, "duplicate ports in grant"
    ports_by_way = tuple(
        pmap[w * per_way:(w + 1) * per_way] for w in range(job.pp))

    def port(w: int, f: int, c: int, e: int) -> int:
        return pmap[w * per_way + (c * ep + e) * fsdp + f]

    sym: Dict[int, Dict[int, List[Tuple[int, ...]]]] = {}
    # digit 1: FSDP/DP rings (one per (cp, ep) coordinate and way)
    sym[1] = {w: [tuple(port(w, f, c, e) for f in range(fsdp))
                  for c in range(cp) for e in range(ep)]
              for w in range(job.pp)}
    # digit 2: CP rings (one per (fsdp, ep) coordinate and way)
    sym[2] = {w: [tuple(port(w, f, c, e) for c in range(cp))
                  for f in range(fsdp) for e in range(ep)]
              for w in range(job.pp)}
    # digit 3: EP rings (one per (fsdp, cp) coordinate and way)
    sym[3] = {w: [tuple(port(w, f, c, e) for e in range(ep))
                  for f in range(fsdp) for c in range(cp)]
              for w in range(job.pp)}
    return JobPlacement(job_id, ports_by_way, sym)


class ControlPlane:
    """The whole paper-§4 control plane behind one constructor.

    Scenario knobs (multi-job sharing, fault injection, OCS-latency
    sweeps) are constructor parameters, not new code paths:

      spec          FabricSpec (DESIGN.md §10): switch technology +
                    radix + latency model behind every rail.  Default:
                    a CrossbarOCS spec built from the legacy knobs
                    below (bit-identical to the pre-spec plane).
      n_rails       rails (switch + orchestrator pairs) the job spans
                    (ignored when ``spec`` is given — the spec carries it)
      ocs_latency   per-reconfiguration OCS switching time (seconds;
                    ignored when ``spec`` is given)
      nic_linkup    additive NIC firmware link-up penalty (§5.1;
                    ignored when ``spec`` is given)
      mode          shim mode: ``DEFAULT`` (on-demand, Alg 1),
                    ``PROVISIONING`` (speculative, Alg 2 / O2) or
                    ``STATIC`` (static fabric: shims classify and route
                    but never write — native/oneshot through the plane)
      ocs_fail      fault injector ``(attempt) -> bool``; persistent
                    failure triggers the §4.2 giant-ring fallback
      collapse      rank-equivalence-class mode (DESIGN.md §8): one
                    representative Shim per pipeline way, weighted
                    barrier writes; telemetry identical, O(ways) instead
                    of O(ranks) Python dispatch per op
      orchestrators shared per-rail orchestrators (cluster mode, §9):
                    the plane registers the job on THESE rails instead
                    of creating private ones, so concurrent jobs'
                    reconfigs contend on the same OCSes; ``ocs_latency``
                    / ``nic_linkup`` are then properties of the shared
                    rails, not this constructor
      ports         PortAllocator grant mapping rank index -> physical
                    OCS port (cluster mode; default identity)
    """

    def __init__(self, job: JobConfig, *, n_rails: int = 1,
                 ocs_latency: float = 0.0, nic_linkup: float = 0.0,
                 mode: str = DEFAULT, timeout: float = 1.0,
                 max_retries: int = 3,
                 ocs_fail: Optional[Callable[[int], bool]] = None,
                 job_id: str = "job0",
                 listeners: Sequence[Callable] = (),
                 collapse: bool = False,
                 orchestrators: Optional[Sequence[RailOrchestrator]] = None,
                 ports: Optional[Sequence[int]] = None,
                 now: float = 0.0,
                 spec: Optional[FabricSpec] = None):
        self.job = job
        self.job_id = job_id
        self.placement = build_placement(job, job_id, ports=ports)
        self.n_ranks = job.pp * job.fsdp * job.cp * job.ep
        self.n_ways = job.pp
        self.ocs_fail = ocs_fail
        # flap-aware injector (DESIGN.md §14): a FaultModel rides the same
        # ocs_fail channel but carries outage windows + a recovery policy;
        # legacy callables leave this None and behave exactly as before
        self.fault_model = ocs_fail if isinstance(ocs_fail, FaultModel) \
            else None
        self.listeners = list(listeners)
        self.collapse = collapse
        self.shared_rails = orchestrators is not None
        if spec is None:
            # legacy knobs: a private-rail crossbar, exactly as before
            spec = FabricSpec(n_rails=n_rails, reconfig_latency=ocs_latency,
                              nic_linkup=nic_linkup)
        self.spec = spec
        self.static = mode == STATIC
        # non-static shims WILL dispatch reconfigurations eventually —
        # the fabric must be able to honour them (DESIGN.md §10 matrix)
        assert spec.reconfigurable or self.static, \
            f"shim mode {mode!r} needs a reconfigurable fabric, " \
            f"not {spec.technology}"

        initial = TopoId.uniform(self.n_ways, 1)
        if orchestrators is not None:
            self.orchestrators = list(orchestrators)
            assert self.orchestrators, "a job spans at least one rail"
            for orch in self.orchestrators:
                self._check_subswitch_fit(orch.ocs)
                orch.register_job(self.placement, initial, now)
        else:
            assert ports is None, \
                "port grants only make sense on shared rails"
            self.orchestrators = []
            for r in range(spec.n_rails):
                backend = spec.make_backend(self.n_ranks)
                self._check_subswitch_fit(backend)
                orch = RailOrchestrator(r, backend)
                orch.register_job(self.placement, initial)
                self.orchestrators.append(orch)
        self.controller = Controller(job_id, self.n_ways,
                                     self.orchestrators, timeout=timeout,
                                     max_retries=max_retries,
                                     static=self.static)
        # rank-equivalence classes: (representative rank, cardinality).
        # Derivation rule (DESIGN.md §8): ranks sharing a pipeline way
        # occupy the same group-role in every CTR group the SPMD stream
        # writes, so their Action streams are byte-identical and one
        # representative per way suffices.  The uncollapsed plane is the
        # degenerate partition — one singleton class per rank.
        per_way = job.fsdp * job.cp * job.ep
        if collapse:
            self.classes: List[Tuple[int, int]] = [
                (w * per_way, per_way) for w in range(self.n_ways)]
        else:
            self.classes = [(r, 1) for r in range(self.n_ranks)]
        self.shims = [Shim(rep, mode=mode) for rep, _ in self.classes]
        # class-cardinality vector: telemetry's weighted shim sums are one
        # dot product over this instead of a Python loop (DESIGN.md §12)
        self._class_weights = np.array([w for _, w in self.classes],
                                       dtype=np.int64)
        # per-(group, class) write counters: class c's k-th write to group
        # g carries barrier index k — every shim replays the same SPMD op
        # stream, so the counters stay aligned with the controller's
        # per-group in-flight index across iterations.  Uncollapsed,
        # class index == rank.
        self._wseq: Dict[str, List[int]] = {}
        # batched-entry-point accounting (call_stats) + schedule cache
        self.n_plane_calls = 0        # pre/post entry-point invocations
        self.n_class_execs = 0        # per-class action executions
        self.n_shim_walks = 0         # live state-machine walks (no replay)
        self.replayed_iterations = 0
        # schedule entries: (pre|post, op uid, per-class action tuples,
        # per-class post-call topology_busy flags)
        self._cache_enabled = True
        self._recording: Optional[List[Tuple[str, int, tuple,
                                             Tuple[bool, ...]]]] = None
        self._sched: Optional[List[Tuple[str, int, tuple,
                                         Tuple[bool, ...]]]] = None
        self._cursor = 0

    def _check_subswitch_fit(self, backend) -> None:
        """OCSArray placement rule (DESIGN.md §10): a job's circuits are
        only ever wired among its own ports, so requiring the whole port
        set to sit inside ONE sub-switch guarantees every topology the
        plane can dispatch — including the §4.2 giant-ring fallback — is
        physically wireable.  Checked at registration so a spanning
        placement fails immediately, not at the first mid-run dispatch."""
        if not isinstance(backend, OCSArray):
            return
        if not backend.fits(self.placement.all_ports):
            lo = min(self.placement.all_ports)
            hi = max(self.placement.all_ports)
            raise CrossSubSwitchError(
                f"job {self.job_id!r} spans OCSArray sub-switch "
                f"boundaries (ports {lo}-{hi}, radix {backend.radix}); "
                "the placement must fit one sub-switch")

    # -- profiling (§4.2) ----------------------------------------------------
    def profile(self, ops: Sequence[CommOp],
                table: Optional[list] = None) -> None:
        """One traced iteration: fill every shim's phase table and register
        the communication groups in the controller's CTR table.

        The op stream is SPMD — every shim derives the SAME table — so it
        is built once and shared (entries are immutable).  Callers holding
        a prebuilt shim table for these exact ops (``TimedWorkload.
        shim_table()``; many cluster tenants share one workload instance)
        pass it via ``table`` and skip the rebuild entirely."""
        from repro_torch.core.shim import table_from_ops
        if table is None:
            table = table_from_ops(ops)
        for s in self.shims:
            s.phase_table = table
            s.restart()
        dims = {op.dim for op in ops if op.scale == "scale_out"}
        ways = tuple(range(self.n_ways))
        rails = tuple(o.rail_id for o in self.orchestrators)
        for dim in sorted(dims):
            if dim in self.controller.groups:
                continue
            digit = PP_DIGIT if dim == "pp" else SYM_DIGITS.get(dim, 1)
            self.controller.register_group(GroupState(
                dim, dim, digit, size=self.n_ranks, rails=rails, ways=ways))
            self._wseq.setdefault(dim, [0] * len(self.classes))
        self._recording = None
        self._sched = None
        self._cursor = 0

    def start_iteration(self) -> None:
        """Rewind the shims' phase-table walk for the next iteration.

        Iteration boundaries also drive the schedule cache: the first
        iteration after ``profile`` records the per-op action schedule the
        batched entry points produce; from the second on, the cycle is
        replayed without re-walking the shim state machines (the stream is
        SPMD-cyclic, so it is identical every iteration — asserted during
        replay)."""
        promote = False
        if self._cache_enabled and self._recording:
            # only a COMPLETE warmup iteration may become the replay
            # schedule: a full walk leaves every shim past its table with
            # the topology lock released.  A mid-phase bail (judged BEFORE
            # restart() rewinds the walk) must fall back to live walking —
            # a consistently-truncated drive would otherwise replay a
            # stream whose wait/lock pattern differs from a live walk's.
            promote = all(s.comm_stage == len(s.phase_table)
                          and not s.topology_busy for s in self.shims)
            if not promote:
                self._cache_enabled = False
                self._recording = None
        for s in self.shims:
            s.restart()
        if not self._cache_enabled:
            return
        if self._sched is not None and self._cursor != 0:
            # a partially-replayed iteration breaks the cyclic-stream
            # premise (the driver bailed mid-schedule): drop the cache and
            # walk live from here — the shims just restarted, so a live
            # walk from the iteration top is exactly right
            self._cache_enabled = False
            self._sched = None
            self._recording = None
            return
        if promote:
            self._sched = self._recording
            self._recording = None
        elif self._sched is None:
            self._recording = []
        self._cursor = 0

    # -- event API (Algorithms 1-2) -----------------------------------------
    def pre_comm(self, rank: int, op: CommOp, now: float = 0.0) -> PlaneEvent:
        self._per_rank_mode()
        return self._exec(rank, rank, op, self.shims[rank].pre_comm(op), now)

    def post_comm(self, rank: int, op: CommOp,
                  now: float = 0.0) -> PlaneEvent:
        self._per_rank_mode()
        return self._exec(rank, rank, op, self.shims[rank].post_comm(op),
                          now)

    def _per_rank_mode(self):
        """Per-rank calls interleave arbitrarily with iteration boundaries
        (tests drive partial iterations, fault probes break early), so the
        cyclic-schedule cache cannot assume one *_all stream — disable it
        for this plane's lifetime."""
        assert not self.collapse, \
            "per-rank event API on a collapsed plane; use pre_comm_all/" \
            "post_comm_all or construct ControlPlane(collapse=False)"
        # mid-replay the shim state machines are NOT walked (absorb only),
        # so a per-rank call here would resume them from stale state and
        # silently diverge from the per-rank ground truth — reject loudly.
        # At a cursor-0 boundary the shims sit in their restarted
        # (iteration-top) state and live walking is consistent.
        assert self._sched is None or self._cursor == 0, \
            "per-rank event API mid-replay; finish the batched iteration " \
            "or call start_iteration() first"
        self.n_plane_calls += 1
        self.n_shim_walks += 1
        self.n_class_execs += 1
        self._cache_enabled = False
        self._recording = None
        self._sched = None

    # -- batched event API: one call per op for the WHOLE plane -------------
    def pre_comm_all(self, op: CommOp, now: float = 0.0) -> PlaneEvent:
        """Algorithm 1 on every rank (one representative per class).

        Returns the completing rank's PlaneEvent when a barrier completed
        during this op, else the last class's event."""
        return self._all("pre", op, now)

    def post_comm_all(self, op: CommOp, now: float = 0.0) -> PlaneEvent:
        """Algorithm 2 on every rank (one representative per class)."""
        return self._all("post", op, now)

    def _all(self, kind: str, op: CommOp, now: float) -> PlaneEvent:
        self.n_plane_calls += 1
        if self._sched is not None:
            k, uid, acts_per_class, busy_per_class = self._sched[self._cursor]
            assert k == kind and uid == op.uid, \
                f"replay stream diverged: cached ({k}, {uid}), " \
                f"got ({kind}, {op.uid})"
            self._cursor += 1
            if self._cursor == len(self._sched):
                self._cursor = 0
                self.replayed_iterations += 1
            for ci, acts in enumerate(acts_per_class):
                self.shims[ci].absorb(acts)
                # keep the topology-lock flag live-walk-exact too, so the
                # shims are in the true mid-iteration state even if the
                # driver bails and the cache is dropped (the lock is the
                # one piece of walk state restart() preserves)
                self.shims[ci].topology_busy = busy_per_class[ci]
        else:
            if kind == "pre":
                acts_per_class = tuple(s.pre_comm(op) for s in self.shims)
            else:
                acts_per_class = tuple(s.post_comm(op) for s in self.shims)
            self.n_shim_walks += len(self.shims)
            if self._recording is not None:
                self._recording.append(
                    (kind, op.uid, acts_per_class,
                     tuple(s.topology_busy for s in self.shims)))
        self.n_class_execs += len(self.classes)
        out: Optional[PlaneEvent] = None
        for ci, ((rep, weight), acts) in enumerate(
                zip(self.classes, acts_per_class)):
            ev = self._exec(ci, rep, op, acts, now, weight)
            if out is None or out.write is None or not out.write.complete:
                out = ev           # completing event wins, else the last
        return out

    def _exec(self, ci: int, rank: int, op: CommOp, acts: Sequence[Action],
              now: float, weight: int = 1) -> PlaneEvent:
        network = ""
        waited = False
        write: Optional[WriteResult] = None
        for a in acts:
            if a.kind == "select_network":
                network = a.network
            elif a.kind == "wait_topology":
                waited = True
            elif a.kind == "topo_write":
                seq = self._wseq[a.group_id][ci]
                self._wseq[a.group_id][ci] = seq + 1
                write = self.controller.topo_write(
                    rank, a.group_id, seq, asym_way=a.asym_way, now=now,
                    ocs_fail=self.ocs_fail, ways=a.ways, weight=weight,
                    variant=a.variant)
                if write.complete:
                    for fn in self.listeners:
                        fn(self, a.group_id, write, now)
        return PlaneEvent(rank, op.uid, tuple(acts), network, waited, write)

    # -- cluster lifecycle ---------------------------------------------------
    def release(self, now: float = 0.0) -> None:
        """Departure (cluster mode): deregister this job from every rail,
        freeing its ports and disconnecting its circuits.  The plane is
        dead afterwards — snapshot ``telemetry()`` first."""
        for o in self.orchestrators:
            o.deregister_job(self.job_id, now)

    # -- steady-state bulk advance (vectorized engine, DESIGN.md §12) -------
    @property
    def replay_ready(self) -> bool:
        """True at an iteration boundary where the promoted schedule cache
        will replay the NEXT iteration verbatim — the precondition for the
        vectorized engine's fast-forward (a full steady iteration's effect
        is then exactly reproducible without walking it)."""
        return (self._cache_enabled and self._sched is not None
                and self._cursor == 0
                and not self.controller.fallback_giant_ring)

    def counter_snapshot(self) -> Dict[str, object]:
        """Integer-counter state of every component this plane mutates, as
        numpy vectors — two snapshots bracketing one steady iteration give
        the per-iteration delta that ``bulk_advance`` replays k times in
        one array op (the vectorized walk)."""
        c = self.controller
        job = np.array(
            [[o.jobs[self.job_id].n_reconfig_events,
              o.jobs[self.job_id].n_program_calls,
              o.jobs[self.job_id].n_ports_programmed]
             for o in self.orchestrators], dtype=np.int64)
        n = len(self.shims)
        return {
            "shim": np.stack([
                np.fromiter((s.n_topo_writes for s in self.shims),
                            dtype=np.int64, count=n),
                np.fromiter((s.n_waits for s in self.shims),
                            dtype=np.int64, count=n)]),
            "ctrl": np.array([c.n_barriers, c.n_dispatches], dtype=np.int64),
            "job": job,
        }

    def bulk_advance(self, before: Dict[str, object],
                     after: Dict[str, object], k: int) -> None:
        """Apply k steady-state iterations' worth of counter deltas in one
        vectorized step (``delta = after - before`` per component).

        Integer telemetry of a steady (replayed) iteration is exactly
        cyclic — every live-walked iteration produces the identical delta —
        so ``counter += k * delta`` lands on precisely the numbers a
        per-op walk of k more iterations would have produced.  Switch-level
        totals advance in lockstep with this job's per-job counters so
        shared-rail summaries stay consistent; switch BUSY clocks are left
        untouched (frozen-contention model: a fast-forwarded job's future
        reconfigurations do not occupy the switch against later tenants —
        DESIGN.md §12 documents the trade)."""
        assert k >= 0, k
        if k == 0:
            return
        dshim = (after["shim"] - before["shim"]) * k
        for i, s in enumerate(self.shims):
            s.n_topo_writes += int(dshim[0, i])
            s.n_waits += int(dshim[1, i])
        dctrl = (after["ctrl"] - before["ctrl"]) * k
        self.controller.n_barriers += int(dctrl[0])
        self.controller.n_dispatches += int(dctrl[1])
        djob = (after["job"] - before["job"]) * k
        for i, o in enumerate(self.orchestrators):
            st = o.jobs[self.job_id]
            dre, dpc, dpp = (int(x) for x in djob[i])
            st.n_reconfig_events += dre
            st.n_program_calls += dpc
            st.n_ports_programmed += dpp
            o.n_reconfig_events += dre
            o.ocs.n_program_calls += dpc
            o.ocs.n_ports_programmed += dpp

    # -- degrade-and-recover (DESIGN.md §14) --------------------------------
    def can_recover(self, now: float) -> bool:
        """True when a demoted job's rails are all clear of outage windows
        and the fault model allows recovery — the engines poll this at
        iteration boundaries and call :meth:`recover`."""
        fm = self.fault_model
        if fm is None or not fm.recovery \
                or not self.controller.fallback_giant_ring:
            return False
        return all(not fm.down(o.rail_id, now)
                   for o in self.orchestrators)

    def recover(self, now: float = 0.0) -> float:
        """Restore the requested topology on every rail and clear the
        giant-ring demotion (``Controller.recover``).  Returns the repair
        program's completion time.  ``replay_ready`` keys off the
        fallback flag, so the replay cache re-promotes by itself."""
        return self.controller.recover(now)

    def fault_stats(self) -> Dict[str, object]:
        """Degrade-and-recover counters (DESIGN.md §14).  Deliberately
        NOT part of ``telemetry()``: the committed BENCH records match
        integer keys exactly, and these counters are zero everywhere
        faults are off."""
        c = self.controller
        return {
            "n_retries": c.n_retries,
            "n_flaps_survived": c.n_flaps_survived,
            "n_demotions": c.n_demotions,
            "n_recoveries": c.n_recoveries,
            "fallback_active": c.fallback_giant_ring,
        }

    # -- observability -------------------------------------------------------
    @property
    def fallback_giant_ring(self) -> bool:
        return self.controller.fallback_giant_ring

    def telemetry(self) -> Dict[str, object]:
        """Aggregate counters from every component — the simulator's ONLY
        source for reconfig/overhead accounting.

        Shim counters are class-cardinality-weighted sums: every rank of a
        class would have produced the representative's exact counter, so
        the dict is bit-identical between collapsed and uncollapsed planes
        (tested in tests/test_plane_collapse.py).  Call-volume accounting
        (which DOES differ — that is the point of collapsing) lives in
        ``call_stats`` instead.  Orchestrator/OCS quantities are the
        per-job counters (identical to the switch totals on private
        rails; the job's own slice of them on shared cluster rails)."""
        c = self.controller
        js = [o.job_stats(self.job_id) for o in self.orchestrators]
        n = len(self.shims)
        writes = np.fromiter((s.n_topo_writes for s in self.shims),
                             dtype=np.int64, count=n)
        waits = np.fromiter((s.n_waits for s in self.shims),
                            dtype=np.int64, count=n)
        return {
            "n_barriers": c.n_barriers,
            "n_dispatches": c.n_dispatches,
            "n_topo_writes": int(self._class_weights @ writes),
            "n_waits": int(self._class_weights @ waits),
            "n_reconfig_events": sum(s["n_reconfig_events"] for s in js),
            "n_program_calls": sum(s["n_program_calls"] for s in js),
            "n_ports_programmed": sum(s["n_ports_programmed"] for s in js),
            "storage_entries": sum(o.storage_entries(self.job_id)
                                   for o in self.orchestrators),
            "fallback_giant_ring": c.fallback_giant_ring,
            "failure_log": list(c.failure_log),
            "topo": {o.rail_id: c.topo[o.rail_id].digits
                     for o in self.orchestrators},
        }

    def call_stats(self) -> Dict[str, int]:
        """Python-dispatch volume of this plane — the quantity the
        equivalence-class collapse reduces (perf tracking; NOT part of
        ``telemetry()``, which must stay collapse-invariant)."""
        return {
            "n_ranks": self.n_ranks,
            "n_classes": len(self.classes),
            "collapsed": int(self.collapse),
            "n_plane_calls": self.n_plane_calls,
            "n_class_execs": self.n_class_execs,
            "n_shim_walks": self.n_shim_walks,
            "replayed_iterations": self.replayed_iterations,
        }
