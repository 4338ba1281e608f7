"""Opus shim: one instance per GPU rank (paper §4.1, Algorithms 1-3).

Intercepts every collective, classifies it (scale-up / management /
rail-data), detects phase boundaries against the profiled phase table, and
issues topo_writes to the controller — before the op (default mode) or
speculatively right after the previous phase's last op (provisioning mode,
O2).  A per-shim topology lock serializes reconfiguration with
communication (G1/G2).

The shim is a synchronous state machine: ``pre_comm``/``post_comm`` return
Action records; the caller (simulator or tests) executes them and supplies
timestamps.  Profiling (first iterations) is ``Shim.profile``: in this
reproduction the schedule is compiled (XLA) and therefore exact — see
DESIGN.md §2 change (1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.phases import CommOp, build_phase_table

DEFAULT = "default"
PROVISIONING = "provisioning"
# static-fabric mode (DESIGN.md §10): the shim still intercepts and
# classifies every collective and walks the phase table, but the fabric
# under it cannot move (patch panel) or never needs to (packet switch) —
# it never takes the topology lock and never issues a topo_write.  This
# is how native/oneshot run through the REAL control plane.
STATIC = "static"


@dataclass(frozen=True)
class Action:
    kind: str        # "select_network" | "topo_write" | "wait_topology"
    network: str = ""            # for select_network
    group_id: str = ""           # for topo_write
    idx: int = -1
    asym_way: int = -1
    # ways the write configures: the full phase-table entry at a boundary
    # (one write programs the whole phase's topology), the op's own way for
    # mid-phase per-op PP writes.  () = use the controller group's default.
    ways: Tuple[int, ...] = ()
    # circuit-round matching the write requests (DESIGN.md §13): 0 = the
    # canonical ring, nonzero = a per-collective round matching
    variant: int = 0


@dataclass
class PhaseTableEntry:
    """(start_gid, start_idx, end_gid, end_idx) per Algorithm 3.

    With per-collective scheduling an entry is one collective round; its
    ``variant`` names the matching the round's topo_write programs."""

    dim: str
    start_uid: int
    end_uid: int
    ways: Tuple[int, ...]
    variant: int = 0


def table_from_ops(ops: Sequence[CommOp]) -> List[PhaseTableEntry]:
    return [PhaseTableEntry(p.dim, p.start_idx, p.end_idx, p.ways,
                            p.variant)
            for p in build_phase_table(list(ops))]


class Shim:
    """Per-rank control logic."""

    def __init__(self, rank: int, mode: str = DEFAULT):
        assert mode in (DEFAULT, PROVISIONING, STATIC)
        self.rank = rank
        self.mode = mode
        self.phase_table: List[PhaseTableEntry] = []
        self.comm_stage = 0
        self.idx = 0
        self.topology_busy = False
        # telemetry for the O-invariant tests
        self.n_topo_writes = 0
        self.n_waits = 0

    # -- profiling (paper §4.2, first 5 steps) ------------------------------
    def profile(self, ops: Sequence[CommOp]):
        """Populate the phase table from one traced iteration."""
        self.phase_table = table_from_ops(ops)
        self.comm_stage = 0
        self.idx = 0

    # -- Algorithm 3 helpers -------------------------------------------------
    def _entry(self) -> Optional[PhaseTableEntry]:
        if self.comm_stage < len(self.phase_table):
            return self.phase_table[self.comm_stage]
        return None

    def phase_change_before(self, op: CommOp) -> bool:
        e = self._entry()
        return e is not None and op.uid == e.start_uid

    def phase_change_after(self, op: CommOp) -> bool:
        e = self._entry()
        return e is not None and op.uid == e.end_uid

    def get_next_comm(self, op: CommOp) -> Tuple[int, int]:
        """(next stage's first op uid, stage index) for provisioning.

        The profiled table is CYCLIC: steady-state training repeats the
        iteration, so the stage after the last wraps to stage 0 — the
        wrap-around write provisions the next iteration's first phase
        inside the current iteration's trailing window (§4.2).
        """
        if self.phase_change_after(op) and self.phase_table:
            n_stage = (self.comm_stage + 1) % len(self.phase_table)
            return self.phase_table[n_stage].start_uid, n_stage
        return op.uid + 1, self.comm_stage

    def restart(self):
        """Rewind the phase-table walk for the next iteration (the table,
        topology lock and telemetry persist)."""
        self.comm_stage = 0
        self.idx = 0

    def absorb(self, acts: Sequence[Action]) -> None:
        """Account a replayed action stream without re-walking the state
        machine.

        Steady-state iterations are cyclic: the action sequence a shim
        emits is identical every iteration (``restart()`` resets the walk
        to the same state), so the plane's schedule cache replays the
        recorded actions and calls ``absorb`` to keep the telemetry
        counters exactly what a live walk would have produced."""
        for a in acts:
            if a.kind == "topo_write":
                self.n_topo_writes += 1
            elif a.kind == "wait_topology":
                self.n_waits += 1

    # -- Algorithm 1: PRE_COMM ----------------------------------------------
    def pre_comm(self, op: CommOp) -> List[Action]:
        acts: List[Action] = []
        if op.scale in ("scale_up", "mgmt"):
            acts.append(Action("select_network",
                               network="scale_up" if op.scale == "scale_up"
                               else "frontend"))
            return acts
        if self.mode == STATIC:
            # static fabric: nothing to write, nothing to lock — the op
            # just gets routed onto the rail network
            self.idx += 1
            acts.append(Action("select_network", network="rail"))
            return acts
        if self.topology_busy:
            self.n_waits += 1
            acts.append(Action("wait_topology"))
        shift = self.phase_change_before(op)
        if self.mode == DEFAULT and (shift or op.dim == "pp"):
            e = self._entry()
            acts.append(Action("topo_write", group_id=self._gid(op.dim),
                               idx=op.uid, asym_way=op.way,
                               ways=e.ways if (shift and e) else (op.way,),
                               variant=op.variant))
            self.n_topo_writes += 1
        if shift:
            self.topology_busy = True
        self.idx += 1
        acts.append(Action("select_network", network="rail"))
        return acts

    # -- Algorithm 2: POST_COMM ---------------------------------------------
    def post_comm(self, op: CommOp) -> List[Action]:
        acts: List[Action] = []
        if op.scale in ("scale_up", "mgmt"):
            return acts
        shift = self.phase_change_after(op)
        if self.mode == PROVISIONING and \
                (shift or op.dim == "pp"):
            n_uid, n_stage = self.get_next_comm(op)
            # phase shifts wrap cyclically; a mid-phase pp op streamed
            # PAST the final shift (caller continuing without restart())
            # has comm_stage == len(table) and nothing left to provision
            if n_stage < len(self.phase_table):
                nxt = self.phase_table[n_stage]
                acts.append(Action("topo_write",
                                   group_id=self._gid(nxt.dim),
                                   idx=n_uid,
                                   asym_way=nxt.ways[0] if nxt.dim == "pp"
                                   else -1,
                                   ways=nxt.ways, variant=nxt.variant))
                self.n_topo_writes += 1
        if shift:
            self.topology_busy = False
            self.comm_stage += 1
        return acts

    @staticmethod
    def _gid(dim: str) -> str:
        """Group-id derivation — the ONE place a dim maps to a controller
        group, shared by the default (pre_comm) and provisioning
        (post_comm) write paths so the two modes cannot drift."""
        return dim
