"""Operations scenarios over the cluster timeline (DESIGN.md §14).

The cluster simulator models admission, contention and departure; this
module adds the rest of a photonic-rail datacenter's production life as
a deterministic event layer over the SAME merged timeline:

``DrainWindow``     a scheduled maintenance window over a port range (a
                    sub-switch of an OCSArray rail, or the whole rail):
                    the range is reserved, resident tenants are evicted —
                    checkpoint-restart re-placement through the
                    ``PortAllocator`` by default, or LIVE migration via
                    the serving-style ``evacuate`` rail program — and the
                    range returns to the pool when the window closes.
``DefragPolicy``    watches the allocator's fragmentation telemetry at
                    every departure and compacts port space by live-
                    migrating the highest-placed tenants downward when it
                    crosses a threshold — the first thing in this repo
                    that ACTS on the fragmentation number instead of
                    reporting it.
``ScenarioEngine``  binds the above (plus per-tenant ``FaultModel`` flap
                    schedules) to one ``ClusterSim``: the cluster polls
                    ``pending()/next_time()/fire()`` so ops events merge
                    causally with job events (ops-first on ties), and
                    ``on_event`` observes departures for the defrag hook.

Everything is deterministic — windows are declared, flap schedules come
from :class:`~repro_torch.core.faults.FaultModel`'s fixed LCG — because the
ops benchmark commits counters derived from these scenarios.

The digital-twin helpers at the bottom serialize ``ClusterSim.twin()``
rows to JSONL and diff two scenario runs row by row (the Turbobulk
delete/regenerate/re-push idiom: export the fleet, change the scenario,
export again, diff).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.fabric import OCSArray
from repro_torch.core.faults import FaultModel
from repro_torch.core.plane import ControlPlane
from repro_torch.sim.cluster import ClusterSim, JobRecord
from repro_torch.sim.opus_sim import SHIM_MODE


@dataclass(frozen=True)
class DrainWindow:
    """One scheduled maintenance window: ports ``[lo, hi)`` are reserved
    for ``start <= t < start + duration``.  ``migrate=True`` relocates
    resident tenants live (evacuate + re-register on surviving ports);
    the default evicts them to a checkpoint-restart re-admission."""

    start: float
    duration: float
    ports: Tuple[int, int]        # half-open [lo, hi) port range
    migrate: bool = False

    def __post_init__(self):
        assert self.duration > 0.0, self.duration
        assert self.start >= 0.0, self.start
        lo, hi = self.ports
        assert 0 <= lo < hi, self.ports

    @property
    def end(self) -> float:
        return self.start + self.duration

    def port_set(self) -> range:
        return range(self.ports[0], self.ports[1])

    @property
    def label(self) -> str:
        return f"drain[{self.ports[0]}:{self.ports[1]})"


@dataclass(frozen=True)
class DefragPolicy:
    """Compact port space when fragmentation crosses ``threshold``:
    live-migrate up to ``max_moves`` tenants per trigger, each to the
    lowest grant strictly below its current one (``PortAllocator.peek``
    with ``below``), so free space coalesces toward the top."""

    threshold: float = 0.5
    max_moves: int = 4

    def __post_init__(self):
        assert 0.0 < self.threshold <= 1.0, self.threshold
        assert self.max_moves >= 1, self.max_moves


class ScenarioEngine:
    """Deterministic fault/maintenance/defrag driver for one ClusterSim.

    Construct, pass to ``ClusterSim(params, ops=engine)`` (or
    :func:`run_scenario`), and read :attr:`stats` afterwards.  A
    ScenarioEngine drives exactly one simulation.
    """

    def __init__(self, *, flaps: Optional[Dict[str, FaultModel]] = None,
                 drains: Tuple[DrainWindow, ...] = (),
                 defrag: Optional[DefragPolicy] = None,
                 restart_delay_s: float = 5.0,
                 migration_stall_s: float = 0.5):
        assert restart_delay_s >= 0.0 and migration_stall_s >= 0.0
        self.flaps = dict(flaps or {})
        self.drains = tuple(drains)
        self.defrag = defrag
        self.restart_delay_s = restart_delay_s
        self.migration_stall_s = migration_stall_s
        self.sim: Optional[ClusterSim] = None
        # (time, phase, order, kind, window): ends sort before starts at
        # the same instant, so back-to-back windows on one range hand the
        # ports over instead of double-reserving
        self._events: List[Tuple[float, int, int, str, DrainWindow]] = []
        self.stats: Dict[str, int] = {
            "n_drain_starts": 0,
            "n_drain_ends": 0,
            "n_restarted": 0,
            "n_migrated": 0,
            "n_migration_fallbacks": 0,
            "n_defrag_checks": 0,
            "n_defrag_moves": 0,
        }

    # -- ClusterSim protocol -------------------------------------------------
    def bind(self, sim: ClusterSim) -> None:
        assert self.sim is None, "a ScenarioEngine drives one simulation"
        self.sim = sim
        for rec in sim.records:
            fm = self.flaps.get(rec.spec.name)
            if fm is not None:
                assert rec.ocs_fail is None, \
                    f"{rec.spec.name!r} already has a fault injector"
                rec.ocs_fail = fm
        ev = []
        for i, d in enumerate(self.drains):
            lo, hi = d.ports
            assert hi <= sim.params.n_ports, (d.ports, sim.params.n_ports)
            ev.append((d.start, 1, i, "start", d))
            ev.append((d.end, 0, i, "end", d))
        self._events = sorted(ev)

    def pending(self) -> bool:
        return bool(self._events)

    def next_time(self) -> float:
        return self._events[0][0]

    def fire(self, t: float) -> None:
        _, _, _, kind, window = self._events.pop(0)
        if kind == "start":
            self._drain_start(t, window)
        else:
            self._drain_end(t, window)

    def on_event(self, t: float, kind: str, rec: JobRecord) -> None:
        """Timeline observer (currently: departures trigger the defrag
        check — that is when fragmentation jumps)."""
        if kind == "depart" and self.defrag is not None:
            self._defrag_tick(t)

    # -- maintenance drains --------------------------------------------------
    def _drain_start(self, t: float, window: DrainWindow) -> None:
        sim = self.sim
        ports = window.port_set()
        sim.allocator.reserve(ports)
        self.stats["n_drain_starts"] += 1
        drained = set(ports)
        # victims in admission order; indices collected first because the
        # eviction paths mutate sim._active in place
        victims = [entry for entry in list(sim._active)
                   if drained & set(entry[0].ports)]
        stop = t
        for entry in victims:
            stop = max(stop, entry[1].t)
            if window.migrate and self._live_migrate(entry):
                continue
            if window.migrate:
                self.stats["n_migration_fallbacks"] += 1
            self._checkpoint_restart(entry)
        sim._note(t, "drain_start", window.label)
        # evicted tenants went to the FRONT of the queue: re-place them
        # on surviving ports right away when there is room
        sim._drain_queue(stop)

    def _drain_end(self, t: float, window: DrainWindow) -> None:
        sim = self.sim
        sim.allocator.unreserve(window.port_set())
        self.stats["n_drain_ends"] += 1
        sim._note(t, "drain_end", window.label)
        sim._drain_queue(t)

    def _checkpoint_restart(self, entry) -> None:
        """Evict one running tenant: release its ports and re-queue it at
        the head with a checkpoint-reload stall and the iteration
        remainder to finish (sized from the engine's completed count)."""
        sim = self.sim
        rec, engine, _gen, _seq = entry
        idx = sim._active.index(entry)
        del sim._active[idx]
        sim._clocks = np.delete(sim._clocks, idx)
        now = engine.t
        rec.iters_done += engine.iterations_done
        rec.plane.release(now=now)
        sim.allocator.release(rec.spec.name)
        rec.plane = None
        rec.ports = None
        rec.status = "queued"
        rec.n_drains += 1
        rec.restart_delay_s = self.restart_delay_s
        # a non-static engine needs warmup + >= 1 measured iteration
        rec.resume_iterations = max(
            rec.spec.iterations - rec.iters_done, 2)
        self.stats["n_restarted"] += 1
        # victims queue AT THE FRONT (they were already admitted once);
        # multiple victims keep their admission order among themselves
        sim._waiting.insert(self._victims_queued(), rec)
        sim._note(now, "drain_evict", rec.spec.name)

    def _victims_queued(self) -> int:
        """Front-insertion index preserving relative order of already
        re-queued victims (those at the head with n_drains > 0)."""
        sim = self.sim
        i = 0
        while i < len(sim._waiting) and sim._waiting[i].n_drains > 0:
            i += 1
        return i

    def _live_migrate(self, entry, *, below: Optional[int] = None) -> bool:
        """Relocate one running tenant without losing its progress:
        evacuate-copy circuits to a fresh grant, re-register there, and
        resume with only a short stall (vs the checkpoint reload).
        Returns False when no feasible destination exists."""
        sim = self.sim
        rec, engine, _gen, _seq = entry
        name = rec.spec.name
        n = len(rec.ports)
        tgt = sim.allocator.peek(n, below=below)
        if tgt is None:
            return False
        ocs = sim.rails[0].ocs
        if isinstance(ocs, OCSArray) and not ocs.fits(tgt):
            return False
        now = engine.t
        # copy circuits old -> new on every rail (state streaming), then
        # tear the old home down and re-register on the new one
        done = now
        for o in sim.rails:
            ticket = o.evacuate(name, tgt, now)
            done = max(done, ticket.done)
        rec.plane.release(now=done)
        sim.allocator.move(name, tgt)
        rec.iters_done += engine.iterations_done
        rec.resume_iterations = max(
            rec.spec.iterations - rec.iters_done, 2)
        rec.n_migrations += 1
        rec.ports = tgt
        start = done + self.migration_stall_s
        # a fresh plane on the new grant (same shared rails); the engine
        # resumes in place of the old one, keeping the admission seq so
        # the merged timeline's tie-breaking stays stable
        rec.plane = ControlPlane(
            rec.spec.job, mode=SHIM_MODE[rec.spec.mode], job_id=name,
            spec=sim.spec, ocs_fail=rec.ocs_fail, collapse=True,
            orchestrators=sim.rails, ports=tgt, now=start)
        new_engine = sim._build_engine(rec, start=start,
                                      iterations=rec.resume_iterations)
        idx = sim._active.index(entry)
        sim._active[idx] = (rec, new_engine, new_engine.events(), _seq)
        sim._clocks[idx] = new_engine.t
        self.stats["n_migrated"] += 1
        sim._note(done, "migrate", name)
        return True

    # -- defragmentation -----------------------------------------------------
    def _defrag_tick(self, t: float) -> None:
        sim = self.sim
        self.stats["n_defrag_checks"] += 1
        if sim.allocator.fragmentation() <= self.defrag.threshold:
            return
        moves = 0
        # compact top-down: highest-placed tenants move first, so each
        # move enlarges the low free block the next one can land in
        for entry in sorted(list(sim._active),
                            key=lambda e: -min(e[0].ports)):
            if moves >= self.defrag.max_moves:
                break
            lo = min(entry[0].ports)
            if self._live_migrate(entry, below=lo):
                moves += 1
                self.stats["n_defrag_moves"] += 1
            if sim.allocator.fragmentation() <= self.defrag.threshold:
                break


def run_scenario(specs, params, *, ops: Optional[ScenarioEngine] = None,
                 twin: bool = False):
    """Convenience driver mirroring ``simulate_cluster`` with the ops
    layer attached.  Returns ``(ClusterResult, ClusterSim)`` — the sim
    gives access to ``twin()`` and per-plane fault stats afterwards."""
    sim = ClusterSim(params, ops=ops, twin=twin)
    for spec in specs:
        sim.submit(spec)
    result = sim.run()
    return result, sim


# ---------------------------------------------------------------------------
# digital-twin export / diff (DESIGN.md §14)
# ---------------------------------------------------------------------------


def write_twin_jsonl(rows: List[Dict[str, object]], path: str) -> int:
    """Serialize twin rows to JSONL (sorted keys: byte-stable output for
    a byte-stable simulation).  Returns the row count."""
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True))
            f.write("\n")
    return len(rows)


@dataclass
class TwinDiff:
    """Row-aligned diff of two twin exports."""

    n_rows_a: int
    n_rows_b: int
    n_diffs: int                  # total differing (row, key) cells
    n_differing_rows: int
    samples: List[Dict[str, object]] = field(default_factory=list)

    @property
    def identical(self) -> bool:
        return self.n_diffs == 0 and self.n_rows_a == self.n_rows_b


def diff_twin(a: List[Dict[str, object]], b: List[Dict[str, object]], *,
              max_samples: int = 8) -> TwinDiff:
    """Compare two scenarios' twin exports row by row: which event ticks
    diverge, and in which inventory keys.  Rows past the shorter export
    count as differing in every key of the longer one's row."""
    n_diffs = 0
    rows_hit = set()
    samples: List[Dict[str, object]] = []
    for i in range(max(len(a), len(b))):
        ra = a[i] if i < len(a) else {}
        rb = b[i] if i < len(b) else {}
        for k in sorted(set(ra) | set(rb)):
            va, vb = ra.get(k), rb.get(k)
            if va != vb:
                n_diffs += 1
                rows_hit.add(i)
                if len(samples) < max_samples:
                    samples.append({"row": i, "key": k, "a": va, "b": vb})
    return TwinDiff(len(a), len(b), n_diffs, len(rows_hit), samples)
