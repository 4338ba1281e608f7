"""Opus network orchestrator: one per rail (paper §4.1).

Translates topology requests (topo_id updates) into OCS port-programming
commands through a vendor-neutral switch-driver interface.  Stores one
sub-mapping per (job, way) — O(N_parallel * N_rank) total — and on a
topo_id update reprograms only the affected ways' ports (digit-diff
dispatch, Fig 8).  Multi-job composition: sub-mappings of other jobs are
never disturbed (non-blocking OCS semantics, §7); the orchestrator
enforces this as a hard port-ownership invariant — every programmed port
must belong to the dispatching job (DESIGN.md §9) — and keeps per-job
programming counters so a shared rail still yields per-job telemetry.

``PortAllocator`` is the cluster-level port-space manager: concurrent
jobs carve their NIC ports out of one shared per-rail OCS port space
(every rank owns the same port index on every rail, paper Fig 1, so one
allocator instance governs all rails of a cluster).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.fabric import SwitchBackend
from repro_torch.core.faults import MigrationContractError, PortOwnershipError
from repro_torch.core.topo import (JobPlacement, SubMapping, TopoId, affected_ways,
                             build_submapping, ring_pairs)


def __getattr__(name: str):
    # Deprecated name: the in-memory OCS driver grew into the
    # SwitchBackend family (DESIGN.md §10) and its crossbar incarnation
    # lives in repro_torch.core.fabric as CrossbarOCS — bit-identical
    # behaviour, same constructor.
    if name == "OCSDriver":
        import warnings

        from repro_torch.core.fabric import CrossbarOCS
        warnings.warn(
            "orchestrator.OCSDriver is deprecated; import CrossbarOCS "
            "from repro_torch.core.fabric",
            DeprecationWarning, stacklevel=2)
        return CrossbarOCS
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclass
class JobTopoState:
    placement: JobPlacement
    topo: TopoId
    submaps: Dict[int, SubMapping] = field(default_factory=dict)
    # per-job programming counters: on a shared rail the OCS-level totals
    # mix tenants, so per-job telemetry reads these instead (DESIGN.md §9)
    n_reconfig_events: int = 0
    n_program_calls: int = 0
    n_ports_programmed: int = 0


@dataclass(frozen=True)
class MigrationTicket:
    """Outcome of one batched cross-tenant migration program."""

    done: float          # switch completion time (circuits ready)
    n_circuits: int      # handoff pairs wired as direct circuits
    n_relayed: int       # pairs with no circuit (cross-sub-switch on an
    #                      OCSArray, or a circuit-free packet fabric):
    #                      traffic is relayed/routed at reduced bandwidth


class RailOrchestrator:
    """One per rail: owns the rail's OCS and all jobs' sub-mappings."""

    def __init__(self, rail_id: int, ocs: SwitchBackend):
        self.rail_id = rail_id
        self.ocs = ocs
        self.jobs: Dict[str, JobTopoState] = {}
        self.port_owner: Dict[int, str] = {}     # port -> job_id
        self.n_reconfig_events = 0

    # -- the §9 isolation invariant -----------------------------------------
    def _assert_owned(self, job_id: str, ports: Iterable[int]) -> None:
        """No program on behalf of ``job_id`` may ever name a port that
        belongs to another tenant — checked on EVERY dispatch path
        (reconfigs, registration, deregistration, giant-ring fallback).
        Raises :class:`PortOwnershipError` (an :class:`AssertionError`
        subclass, so it survives ``python -O`` and scenario code can
        catch-and-degrade on the precise type)."""
        foreign = sorted(p for p in ports
                         if self.port_owner.get(p) != job_id)
        if foreign:
            raise PortOwnershipError(
                f"job {job_id!r} would program foreign/unowned ports "
                f"{foreign}")

    def _programmed(self, st: JobTopoState, n_ports: int) -> None:
        st.n_program_calls += 1
        st.n_ports_programmed += n_ports

    # -- job management ----------------------------------------------------
    def register_job(self, placement: JobPlacement, initial: TopoId,
                     now: float = 0.0) -> float:
        taken = sorted(p for p in placement.all_ports
                       if p in self.port_owner)
        if taken:
            raise PortOwnershipError(
                f"job {placement.job_id!r} claims already-owned ports "
                f"{taken}")
        st = JobTopoState(placement, initial)
        for w in range(initial.n_ways):
            st.submaps[w] = build_submapping(placement, initial, w)
        self.jobs[placement.job_id] = st
        for p in placement.all_ports:
            self.port_owner[p] = placement.job_id
        if not self.ocs.programmable:
            # always-connected fabric (PacketSwitch): port ownership is
            # still tracked (admission/isolation are real on shared
            # rails) but there are no circuits to program, and telemetry
            # honestly reports zero programming
            return now
        pairs = [p for sm in st.submaps.values() for p in sm.pairs]
        self._programmed(st, len(pairs))
        return self.ocs.program([], pairs, now)

    def deregister_job(self, job_id: str, now: float = 0.0):
        st = self.jobs.pop(job_id)
        ports = sorted(st.placement.all_ports)
        self._assert_owned(job_id, ports)
        for p in ports:
            del self.port_owner[p]
        if self.ocs.programmable:
            self.ocs.program(ports, [], now)

    # -- reconfiguration dispatch (paper Fig 8) -----------------------------
    def apply(self, job_id: str, new_topo: TopoId, now: float = 0.0) -> float:
        """Reprogram only the sub-mappings of changed/affected ways.

        Returns the OCS completion time (ACK time).  A no-op topo write
        (identical digits) programs nothing and completes immediately —
        this is the O1 suppression observable at the orchestrator.
        """
        st = self.jobs[job_id]
        assert self.ocs.programmable, \
            "reconfiguration dispatch on a circuit-free fabric"
        ways = affected_ways(st.topo, new_topo)
        if not ways:
            return now
        # PP pairs may duplicate across adjacent ways (a way shares its src
        # ports with the stage it feeds); dedupe BOTH sides so
        # n_ports_programmed counts each port once, and assert the dropped
        # duplicates are consistent (same src never wired to two dsts).
        disco: set = set()
        for w in ways:
            disco.update(a for a, _ in st.submaps[w].pairs)
        dst_of: Dict[int, int] = {}
        conn: List[Tuple[int, int]] = []
        for w in ways:
            new_sm = build_submapping(st.placement, new_topo, w)
            st.submaps[w] = new_sm
            for a, b in new_sm.pairs:
                if a in dst_of:
                    assert dst_of[a] == b, \
                        f"way overlap wires port {a} to both {dst_of[a]} " \
                        f"and {b}"
                    continue
                dst_of[a] = b
                conn.append((a, b))
        # every re-wired src must have been disconnected first or be free:
        # a connect of a port that stays live in an untouched way is a
        # G-invariant violation the OCS would reject mid-flight.
        live = {a for w, sm in st.submaps.items() if w not in ways
                for a, _ in sm.pairs}
        assert not (set(dst_of) & live), sorted(set(dst_of) & live)
        self._assert_owned(job_id, disco | {p for ab in conn for p in ab})
        st.topo = new_topo
        self.n_reconfig_events += 1
        st.n_reconfig_events += 1
        self._programmed(st, len(disco) + len(conn))
        done = self.ocs.program(sorted(disco), conn, now)
        return done

    def apply_giant_ring(self, job_id: str, now: float = 0.0) -> float:
        """§4.2 fallback: one static cycle over ALL of the job's ports
        (reduced bandwidth).  Routed through the orchestrator — not the
        raw OCS — so the isolation invariant and per-job accounting hold
        on the fault path too: the ring is built strictly from the job's
        own ports and never touches another tenant's circuits."""
        st = self.jobs[job_id]
        assert self.ocs.programmable, \
            "giant-ring fallback on a circuit-free fabric"
        ports = sorted(st.placement.all_ports)
        self._assert_owned(job_id, ports)
        pairs = list(ring_pairs(ports))
        self.n_reconfig_events += 1
        st.n_reconfig_events += 1
        self._programmed(st, len(ports) + len(pairs))
        # return program()'s own completion time: on an OCSArray,
        # ocs.busy_until is the max over ALL sub-switches and would leak
        # another tenant's busy clock into this job's ack time
        return self.ocs.program(ports, pairs, now)

    def repair(self, job_id: str, new_topo: TopoId,
               now: float = 0.0) -> float:
        """Full re-wire to ``new_topo`` after a fault repair (DESIGN.md
        §14).  The giant-ring fallback superseded the job's circuits
        WITHOUT updating its topo/sub-mapping records, so the digit-diff
        of :meth:`apply` would under-program: every way is rebuilt and
        every connected job port re-wired in one program, landing the
        rail exactly where a never-faulted run would be."""
        st = self.jobs[job_id]
        assert self.ocs.programmable, "repair on a circuit-free fabric"
        ports = sorted(st.placement.all_ports)
        self._assert_owned(job_id, ports)
        dst_of: Dict[int, int] = {}
        conn: List[Tuple[int, int]] = []
        for w in range(new_topo.n_ways):
            sm = build_submapping(st.placement, new_topo, w)
            st.submaps[w] = sm
            for a, b in sm.pairs:
                if a in dst_of:
                    assert dst_of[a] == b, \
                        f"way overlap wires port {a} to both {dst_of[a]} " \
                        f"and {b}"
                    continue
                dst_of[a] = b
                conn.append((a, b))
        st.topo = new_topo
        disco = [p for p in ports if self.ocs.connected(p) is not None]
        self.n_reconfig_events += 1
        st.n_reconfig_events += 1
        self._programmed(st, len(disco) + len(conn))
        return self.ocs.program(disco, conn, now)

    def evacuate(self, job_id: str, dst_ports: Tuple[int, ...],
                 now: float = 0.0) -> "MigrationTicket":
        """Live-migration copy circuits: wire ``job_id``'s current ports
        point-to-point onto FREE destination ports (a maintenance drain
        or defrag move streaming state to its new home, DESIGN.md §14).

        The destinations must be unowned — this is the one sanctioned
        program naming ports outside the tenant's grant, and it still
        never touches another tenant's.  Circuits are keyed by the OLD
        (source) ports, so the job's subsequent ``release`` tears them
        down; on an :class:`~repro_torch.core.fabric.OCSArray`, pairs spanning
        sub-switches are relayed, and a circuit-free fabric relays
        everything (no program, ``done == now``)."""
        st = self.jobs[job_id]
        src_ports = tuple(sorted(st.placement.all_ports))
        self._assert_owned(job_id, src_ports)
        owned = sorted(p for p in dst_ports if p in self.port_owner)
        if owned:
            raise PortOwnershipError(
                f"evacuation of {job_id!r} targets owned ports {owned}")
        if len(dst_ports) != len(src_ports):
            raise MigrationContractError(
                f"evacuation of {job_id!r} pairs {len(src_ports)} source "
                f"ports with {len(dst_ports)} destination ports")
        pairs = list(zip(src_ports, dst_ports))
        if not pairs:
            return MigrationTicket(now, 0, 0)
        if not self.ocs.programmable:
            return MigrationTicket(now, 0, len(pairs))
        sub = getattr(self.ocs, "sub_switch", None)
        wired = [p for p in pairs if sub is None or sub(p[0]) == sub(p[1])]
        relayed = len(pairs) - len(wired)
        if not wired:
            return MigrationTicket(now, 0, relayed)
        disco = sorted({a for a, _ in wired
                        if self.ocs.connected(a) is not None})
        self.n_reconfig_events += 1
        st.n_reconfig_events += 1
        self._programmed(st, len(disco) + len(wired))
        done = self.ocs.program(disco, wired, now)
        return MigrationTicket(done, len(wired), relayed)

    # -- cross-tenant KV migration (DESIGN.md §11) ---------------------------
    def migrate(self, handoffs: List[Tuple[str, str, Tuple[int, ...],
                                           Tuple[int, ...]]],
                now: float = 0.0) -> "MigrationTicket":
        """Point-to-point KV-handoff circuits between CONSENTING tenants.

        ``handoffs`` is a batch of ``(src_job, dst_job, src_ports,
        dst_ports)`` entries, wired in ONE switch program (the serving
        fleet's handoff phase — batching is what keeps a busy OCS from
        saturating on per-request reconfigurations).  Each side's ports
        are ownership-asserted against ITS OWN tenant — a handoff is the
        one sanctioned cross-tenant operation, and it still never names a
        port owned by a third party.  Source ports are disconnected from
        their current circuits (the src ring is broken until
        :meth:`restore`); on an :class:`~repro_torch.core.fabric.OCSArray`,
        pairs spanning sub-switch boundaries cannot hold a circuit and
        are reported as relayed (routed at reduced bandwidth) instead of
        raising.  A circuit-free fabric (PacketSwitch) relays everything:
        no program, no reconfiguration, ``done == now``.
        """
        pairs: List[Tuple[int, int]] = []
        src_jobs: List[str] = []
        seen_src: set = set()
        for src_job, dst_job, src_ports, dst_ports in handoffs:
            self._assert_owned(src_job, src_ports)
            self._assert_owned(dst_job, dst_ports)
            if src_job == dst_job:
                raise MigrationContractError(
                    f"self-migration for {src_job!r} never touches the "
                    f"rails")
            if len(src_ports) != len(dst_ports):
                raise MigrationContractError(
                    f"handoff {src_job!r}->{dst_job!r} pairs "
                    f"{len(src_ports)} source ports with {len(dst_ports)} "
                    f"destination ports (trim to rank pairs at the call "
                    f"site)")
            # a port holds one circuit: the same source port named by two
            # handoff entries of one program is a caller bug that would
            # otherwise surface as a deep backend conflict mid-program
            dup = sorted(p for p in src_ports if p in seen_src)
            if dup:
                raise MigrationContractError(
                    f"source ports {dup} appear in multiple handoffs of "
                    f"one migration program")
            seen_src.update(src_ports)
            pairs.extend(zip(src_ports, dst_ports))
            src_jobs.append(src_job)
        if not pairs:
            return MigrationTicket(now, 0, 0)
        if not self.ocs.programmable:
            return MigrationTicket(now, 0, len(pairs))
        sub = getattr(self.ocs, "sub_switch", None)
        wired = [p for p in pairs if sub is None or sub(p[0]) == sub(p[1])]
        relayed = len(pairs) - len(wired)
        if not wired:
            return MigrationTicket(now, 0, relayed)
        disco = sorted({a for a, _ in wired
                        if self.ocs.connected(a) is not None})
        self.n_reconfig_events += 1
        for j in src_jobs:
            st = self.jobs[j]
            st.n_reconfig_events += 1
            self._programmed(st, 0)
        # ports are billed once, to the batch (not per tenant): split the
        # count over the participating sources deterministically, the
        # remainder going to the batch's first source
        n_ports = len(disco) + len(wired)
        base, rem = divmod(n_ports, len(src_jobs))
        for i, j in enumerate(src_jobs):
            self.jobs[j].n_ports_programmed += base + (1 if i < rem else 0)
        done = self.ocs.program(disco, wired, now)
        return MigrationTicket(done, len(wired), relayed)

    def restore(self, job_ids: Iterable[str],
                now: float = 0.0) -> float:
        """Reinstate the stored sub-mappings of ``job_ids`` after a
        migration borrowed their source ports — ONE program re-wiring
        every affected ring (the handoff phase's closing reconfiguration).
        No-op (and free) on a circuit-free fabric."""
        job_ids = list(job_ids)
        if not job_ids or not self.ocs.programmable:
            return now
        disco: set = set()
        conn: List[Tuple[int, int]] = []
        for j in job_ids:
            st = self.jobs[j]
            ports = sorted(st.placement.all_ports)
            self._assert_owned(j, ports)
            pairs = [p for sm in st.submaps.values() for p in sm.pairs]
            disco.update(p for p in ports
                         if self.ocs.connected(p) is not None)
            conn.extend(pairs)
            st.n_reconfig_events += 1
            self._programmed(st, len(pairs))
        self.n_reconfig_events += 1
        return self.ocs.program(sorted(disco), conn, now)

    def job_stats(self, job_id: str) -> Dict[str, int]:
        """Per-job programming counters (shared-rail telemetry source)."""
        st = self.jobs[job_id]
        return {
            "n_reconfig_events": st.n_reconfig_events,
            "n_program_calls": st.n_program_calls,
            "n_ports_programmed": st.n_ports_programmed,
        }

    def storage_entries(self, job_id: Optional[str] = None) -> int:
        """Sub-mapping storage actually held (for the O() claims test);
        restricted to one tenant when ``job_id`` is given."""
        jobs = self.jobs.values() if job_id is None else [self.jobs[job_id]]
        return sum(len(sm.pairs) + 1 for st in jobs
                   for sm in st.submaps.values())


# ---------------------------------------------------------------------------
# cluster port-space management (DESIGN.md §9)
# ---------------------------------------------------------------------------


class PortAllocator:
    """Shared per-rail OCS port space carved across concurrent jobs.

    Rail fabrics give every scale-out rank the same port index on every
    rail (paper Fig 1), so ONE allocator instance governs a whole
    cluster's rails: a grant is a tuple of port indices valid on each of
    them.  Two policies:

      contiguous  first-fit contiguous range.  Rings stay physically
                  local, but departures strand free ports between
                  tenants — a later job can be rejected with enough
                  total ports free (external fragmentation).
      fragmented  first-fit over individual free ports.  Always admits
                  when enough ports are free, at the price of scattered
                  rings (an OCS crossbar is distance-free, §7, so this
                  costs nothing in the model — the policy split exists
                  to quantify exactly that trade).

    Rejected requests are counted, never raised: admission control
    (queue vs reject) is the cluster scheduler's decision.
    """

    POLICIES = ("contiguous", "fragmented")

    def __init__(self, n_ports: int, policy: str = "contiguous"):
        assert policy in self.POLICIES, policy
        assert n_ports >= 1, n_ports
        self.n_ports = n_ports
        self.policy = policy
        self.owner: Dict[int, str] = {}          # port -> job_id
        self.grants: Dict[str, Tuple[int, ...]] = {}
        # maintenance-reserved ports (DESIGN.md §14): never granted while
        # reserved; an owned+reserved port is a drain victim not yet
        # evicted.  Empty by default, so every pre-ops code path (and all
        # committed BENCH counters) is untouched.
        self.reserved: set = set()
        self.n_allocations = 0
        # failed allocate() attempts — NOT distinct jobs turned away: a
        # queued job re-tried at every departure counts once per re-try
        # (admission-queue pressure; ClusterSim's "rejected" job status
        # separately tracks jobs that can never fit)
        self.n_failed_allocs = 0

    # -- allocation ---------------------------------------------------------
    def allocate(self, job_id: str, n: int) -> Optional[Tuple[int, ...]]:
        """Grant ``n`` ports to ``job_id`` or return None (no room under
        the policy).  A job holds at most one grant."""
        assert job_id not in self.grants, f"{job_id!r} already holds ports"
        assert n >= 1, n
        if self.policy == "contiguous":
            grant = self._first_fit_run(n)
        else:
            free = [p for p in range(self.n_ports)
                    if p not in self.owner and p not in self.reserved]
            grant = tuple(free[:n]) if len(free) >= n else None
        if grant is None:
            self.n_failed_allocs += 1
            return None
        for p in grant:
            self.owner[p] = job_id
        self.grants[job_id] = grant
        self.n_allocations += 1
        return grant

    def release(self, job_id: str) -> Tuple[int, ...]:
        grant = self.grants.pop(job_id)
        for p in grant:
            assert self.owner.pop(p) == job_id
        return grant

    def _first_fit_run(self, n: int) -> Optional[Tuple[int, ...]]:
        for start, length in self.free_runs():
            if length >= n:
                return tuple(range(start, start + n))
        return None

    # -- maintenance/defrag surface (DESIGN.md §14) --------------------------
    def reserve(self, ports: Iterable[int]) -> None:
        """Take ``ports`` out of the allocatable pool (a maintenance
        window opening).  Owned ports may be reserved — they mark drain
        victims the scenario engine has yet to evict."""
        self.reserved.update(ports)

    def unreserve(self, ports: Iterable[int]) -> None:
        """Return ``ports`` to the allocatable pool (window closing)."""
        self.reserved.difference_update(ports)

    def peek(self, n: int, below: Optional[int] = None
             ) -> Optional[Tuple[int, ...]]:
        """The grant :meth:`allocate` WOULD return, without mutating any
        state or counters.  With ``below``, only grants lying entirely
        under that port index qualify — the defrag policy's 'strictly
        closer to the bottom' compaction test."""
        assert n >= 1, n
        if self.policy == "contiguous":
            for start, length in self.free_runs():
                if below is not None and start + n > below:
                    break
                if length >= n:
                    return tuple(range(start, start + n))
            return None
        free = [p for p in range(self.n_ports)
                if p not in self.owner and p not in self.reserved]
        if below is not None:
            free = [p for p in free if p < below]
        return tuple(free[:n]) if len(free) >= n else None

    def move(self, job_id: str, new_grant: Tuple[int, ...]
             ) -> Tuple[int, ...]:
        """Atomically re-home ``job_id`` onto ``new_grant`` (the commit
        point of a live migration).  Not an admission: allocation
        counters are untouched.  Returns the old grant."""
        old = self.grants[job_id]
        if len(new_grant) != len(old):
            raise MigrationContractError(
                f"move of {job_id!r} pairs {len(old)} held ports with "
                f"{len(new_grant)} destination ports")
        clash = sorted(p for p in new_grant
                       if p in self.owner or p in self.reserved)
        if clash:
            raise PortOwnershipError(
                f"move of {job_id!r} targets owned/reserved ports {clash}")
        for p in old:
            assert self.owner.pop(p) == job_id
        for p in new_grant:
            self.owner[p] = job_id
        self.grants[job_id] = tuple(new_grant)
        return old

    # -- telemetry ----------------------------------------------------------
    def free_runs(self) -> List[Tuple[int, int]]:
        """Maximal allocatable (start, length) runs, ascending by start
        — free means unowned AND unreserved."""
        runs: List[Tuple[int, int]] = []
        start = None
        for p in range(self.n_ports):
            if p not in self.owner and p not in self.reserved:
                if start is None:
                    start = p
            elif start is not None:
                runs.append((start, p - start))
                start = None
        if start is not None:
            runs.append((start, self.n_ports - start))
        return runs

    def utilization(self) -> float:
        return len(self.owner) / self.n_ports

    def fragmentation(self) -> float:
        """1 - largest_free_run / total_free: 0 when the free space is one
        contiguous block (or the rail is full), approaching 1 as free
        ports scatter into slivers no contiguous request can use."""
        runs = self.free_runs()
        free = sum(length for _, length in runs)
        if free == 0:
            return 0.0
        return 1.0 - max(length for _, length in runs) / free

    def stats(self) -> Dict[str, float]:
        return {
            "n_ports": self.n_ports,
            "ports_in_use": len(self.owner),
            "utilization": self.utilization(),
            "fragmentation": self.fragmentation(),
            "n_allocations": self.n_allocations,
            "n_failed_allocs": self.n_failed_allocs,
        }
