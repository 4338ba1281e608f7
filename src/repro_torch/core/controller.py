"""Opus controller: one per job (paper §4.1).

Maintains the CTR table — per communication group: sockets to shims (here:
rank ids), group size, rail ids, in-flight operation index, and a ready
counter.  Acts as the runtime synchronization barrier: a reconfiguration is
forwarded to the rail orchestrators only when EVERY rank of the group has
issued its topo_write for the same (group, idx); ACKs fan back to all
ranks.  Timeout/retry and the giant-ring fallback implement §4.2
"Handling Communication Faults".
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.faults import FaultModel
from repro_torch.core.orchestrator import RailOrchestrator
from repro_torch.core.topo import PP_DIGIT, TopoId


@dataclass
class GroupState:
    group_id: str
    dim: str                     # parallelism dimension name
    digit: int                   # topo digit value (0 = PP)
    size: int                    # participating ranks
    rails: Tuple[int, ...]
    ways: Tuple[int, ...]        # ways this group occupies
    idx: int = 0                 # in-flight op index
    ready: int = 0               # ready counter
    waiting: List[int] = field(default_factory=list)


@dataclass
class WriteResult:
    complete: bool               # barrier reached -> reconfig dispatched
    ack_time: float = 0.0        # when ranks get ACKed (OCS done)
    reconfigured: bool = False   # did any rail actually reprogram
    acked_ranks: Tuple[int, ...] = ()


class Controller:
    """Synchronous state machine; the simulator supplies timestamps."""

    def __init__(self, job_id: str, n_ways: int,
                 orchestrators: Sequence[RailOrchestrator],
                 timeout: float = 1.0, max_retries: int = 3,
                 static: bool = False):
        self.job_id = job_id
        self.n_ways = n_ways
        # static-fabric jobs (native/oneshot through the plane, DESIGN.md
        # §10) run STATIC shims that never write — a topo_write reaching
        # this controller anyway is a control-plane bug, not a request
        # the fabric could ever honour, and is rejected loudly.
        self.static = static
        self.orchestrators = list(orchestrators)
        self.groups: Dict[str, GroupState] = {}
        self.topo: Dict[int, TopoId] = {
            o.rail_id: TopoId.uniform(n_ways, 1) for o in orchestrators}
        self.timeout = timeout
        self.max_retries = max_retries
        self.n_barriers = 0
        self.n_dispatches = 0
        self.fallback_giant_ring = False
        self.failure_log: List[str] = []
        # the topology a healthy run WOULD be on, accumulated while the
        # job rides the giant ring: every suppressed barrier folds its
        # requested way/digit update in here, so recover() restores
        # exactly what the next healthy barrier diffs against and the
        # post-repair dispatch sequence matches a never-faulted run's
        self.pending_topo: Dict[int, TopoId] = {}
        # degrade-and-recover counters (DESIGN.md §14); surfaced via
        # ControlPlane.fault_stats(), NOT telemetry() — the committed
        # BENCH records' integer-key structure stays frozen
        self.n_retries = 0
        self.n_flaps_survived = 0
        self.n_demotions = 0
        self.n_recoveries = 0

    # -- CTR table ----------------------------------------------------------
    def register_group(self, gs: GroupState):
        self.groups[gs.group_id] = gs

    @staticmethod
    def n_groups(p1: int, p2: int, p3: int) -> int:
        """Group-count identity from §4.1: P1P2 + P2P3 + P3P1."""
        return p1 * p2 + p2 * p3 + p3 * p1

    # -- topo_write barrier (paper "Runtime synchronization") ---------------
    def topo_write(self, rank: int, group_id: str, idx: int,
                   asym_way: int = -1, now: float = 0.0,
                   ocs_fail: Optional[Callable[[int], bool]] = None,
                   ways: Optional[Sequence[int]] = None,
                   weight: int = 1, variant: int = 0) -> WriteResult:
        """One rank's (or rank-class representative's) barrier arrival.

        ``weight`` is the rank-equivalence-class cardinality: the op stream
        is SPMD, so ranks sharing a (way, group-role) coordinate issue
        byte-identical writes and one representative write may stand in for
        the whole class.  A barrier of size n therefore completes from k
        class writes whose weights sum to n — the weighted-barrier
        invariant (DESIGN.md §8).  ``weight=1`` is the uncollapsed per-rank
        protocol and the two are observationally identical at the
        controller (same barrier/dispatch sequence, same timestamps).

        ``variant`` selects the circuit-round matching the write requests
        (DESIGN.md §13): 0 is the canonical ring; consecutive rounds of a
        per-collective decomposition carry distinct variants, so a round
        on an unchanged digit is still a real reconfiguration instead of
        being suppressed as a digit no-op.
        """
        assert not self.static, \
            "topo_write on a static-fabric job (shims must run STATIC)"
        g = self.groups[group_id]
        if idx != g.idx:
            # stale write (rank ahead/behind): queue semantics collapse to
            # asserting schedule agreement — a real deployment errors here
            raise ValueError(
                f"rank {rank} wrote idx {idx}, controller at {g.idx}")
        assert weight >= 1, weight
        g.ready += weight
        g.waiting.append(rank)
        if g.ready < g.size:
            return WriteResult(complete=False)
        assert g.ready == g.size, \
            f"group {group_id}: class weights overshoot the barrier " \
            f"({g.ready} > {g.size})"

        # barrier reached: (1) update topo_id (2) dispatch (3) await ACKs
        # (4) ACK ranks (5) clear counter
        self.n_barriers += 1
        reconfigured = False
        ack = now
        if g.digit == PP_DIGIT:
            # each PP way also claims the way it feeds (Send/Recv circuit)
            base = tuple(ways) if ways else (asym_way,)
            ways = tuple(sorted({x for w in base for x in (w, w + 1)}))
        elif not ways or any(w < 0 for w in ways):
            ways = g.ways          # -1 = "all ways of the group"
        ways = tuple(w for w in ways if 0 <= w < self.n_ways)
        if self.fallback_giant_ring:
            # §4.2: after the persistent-failure fallback the job runs on
            # the static giant ring — barriers still synchronize the ranks
            # but no further reconfiguration is dispatched (no-op writes).
            # The requested topology is still tracked so a later repair
            # can restore what the healthy run would be on.
            self._note_pending(g, ways, variant)
            acked = tuple(g.waiting)
            g.idx += 1
            g.ready = 0
            g.waiting = []
            return WriteResult(True, now, False, acked)
        # rails already consistent with this barrier (dispatch succeeded or
        # digit no-op), with their pre-write topo records: a LATER rail's
        # persistent failure must demote these too (§4.2 — the whole job
        # moves to the giant ring, rails never stay on divergent
        # topologies), reverting records the ring superseded
        handled: List[Tuple[RailOrchestrator, TopoId]] = []
        for o in self.orchestrators:
            if o.rail_id not in g.rails:
                continue
            if self.fallback_giant_ring:
                # an earlier rail's persistent failure within THIS barrier
                # demoted the whole job (§4.2): the remaining rails join
                # the static giant ring instead of the requested topology,
                # so every rail of the job stays consistent
                ack = max(ack, o.apply_giant_ring(self.job_id, now))
                reconfigured = True
                continue
            prev = self.topo[o.rail_id]
            new_topo = prev.with_ways(ways, g.digit,
                                      0 if g.digit == PP_DIGIT else variant)
            if new_topo == prev:
                handled.append((o, prev))
                continue
            done = self._dispatch(o, new_topo, now, ocs_fail)
            if not self.fallback_giant_ring:
                # on fallback the rail runs the static giant ring, NOT the
                # requested topology — recording new_topo would make
                # telemetry claim circuits the OCS never programmed
                self.topo[o.rail_id] = new_topo
                handled.append((o, prev))
            ack = max(ack, done)
            reconfigured = True
        if self.fallback_giant_ring:
            for o, prev in handled:
                self.topo[o.rail_id] = prev
                ack = max(ack, o.apply_giant_ring(self.job_id, now))
            # after the revert every rail's topo record is its pre-barrier
            # state, so the pending update folds the DEMOTING barrier's
            # request in too (the repair must land on it)
            self._note_pending(g, ways, variant)
        acked = tuple(g.waiting)
        g.idx += 1
        g.ready = 0
        g.waiting = []
        return WriteResult(True, ack, reconfigured, acked)

    def _note_pending(self, g: GroupState, ways, variant: int) -> None:
        """Fold a fallback-suppressed barrier's requested update into the
        pending (would-be-healthy) topology record per rail."""
        v = 0 if g.digit == PP_DIGIT else variant
        for rail in g.rails:
            if rail not in self.topo:
                continue
            base = self.pending_topo.get(rail, self.topo[rail])
            self.pending_topo[rail] = base.with_ways(ways, g.digit, v)

    def _dispatch(self, o: RailOrchestrator, topo: TopoId, now: float,
                  ocs_fail) -> float:
        """Forward with timeout/retry; persistent failure -> giant ring."""
        self.n_dispatches += 1
        if isinstance(ocs_fail, FaultModel):
            return self._dispatch_flaps(o, topo, now, ocs_fail)
        for attempt in range(self.max_retries):
            if ocs_fail is not None and ocs_fail(attempt):
                self.failure_log.append(
                    f"rail {o.rail_id} attempt {attempt}: timeout")
                now += self.timeout
                continue
            return o.apply(self.job_id, topo, now)
        # persistent failure: fall back to the static giant ring — via the
        # orchestrator, so the §9 port-ownership invariant and per-job
        # accounting hold on the fault path too
        self.fallback_giant_ring = True
        self.n_demotions += 1
        self.failure_log.append(
            f"rail {o.rail_id}: persistent failure -> giant ring fallback")
        return o.apply_giant_ring(self.job_id, now)

    def _dispatch_flaps(self, o: RailOrchestrator, topo: TopoId,
                        now: float, fm: FaultModel) -> float:
        """Wall-clock retry loop against a FaultModel's outage windows:
        each failed attempt waits ``timeout * backoff**attempt``, so a
        short flap is WAITED OUT within the budget instead of demoting.
        With ``backoff=1.0`` and the default budget this is timestamp-
        identical to the legacy attempt loop."""
        budget = fm.retry_budget if fm.retry_budget is not None \
            else self.max_retries
        for attempt in range(budget):
            if fm.down(o.rail_id, now):
                self.n_retries += 1
                self.failure_log.append(
                    f"rail {o.rail_id} attempt {attempt}: timeout")
                now += self.timeout * fm.backoff ** attempt
                continue
            if attempt:
                self.n_flaps_survived += 1
            return o.apply(self.job_id, topo, now)
        self.fallback_giant_ring = True
        self.n_demotions += 1
        self.failure_log.append(
            f"rail {o.rail_id}: persistent failure -> giant ring fallback")
        return o.apply_giant_ring(self.job_id, now)

    # -- repair (DESIGN.md §14: the degrade-and-recover state machine) ------
    def recover(self, now: float = 0.0) -> float:
        """Restore the topology the job would be on had the fault never
        happened, clearing the giant-ring demotion.

        The giant ring superseded EVERY rail's circuits without touching
        the recorded topo/sub-mappings, so each rail gets a FULL re-wire
        (``RailOrchestrator.repair``) to its pending target — a digit-diff
        ``apply`` would under-program ways the suppressed barriers never
        named.  After this the replay cache re-promotes (``replay_ready``
        keys off the fallback flag) and the vector engine's fast-forward
        re-arms."""
        assert self.fallback_giant_ring, "recover() outside fallback"
        ack = now
        for o in self.orchestrators:
            target = self.pending_topo.get(o.rail_id, self.topo[o.rail_id])
            ack = max(ack, o.repair(self.job_id, target, now))
            self.topo[o.rail_id] = target
        self.pending_topo.clear()
        self.fallback_giant_ring = False
        self.n_recoveries += 1
        self.failure_log.append(
            f"rail repair at t={now:.6g}: requested topology restored")
        return ack
