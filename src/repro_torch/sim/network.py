"""Reconfigurable analytical network backend (paper §5.3's AstraSim
extension, re-implemented natively).

The backend holds a set of candidate circuit configurations — directed
bandwidth matrices indexed by topology ID (zero entries = absent circuits).
The active matrix changes as Opus selects configurations at runtime; base
link latency and reconfiguration latency apply uniformly.  Correctness
semantics reproduced from the paper:

  * a reconfiguration request is REJECTED while any collective is in
    flight on the affected links, or while another reconfiguration is
    pending (G1/G2 surface here as hard errors);
  * accepted reconfigurations drain active links before applying;
  * traffic arriving during a reconfiguration interval queues and is
    released on completion.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.fabric import CrossbarOCS
from repro_torch.core.topo import ring_pairs


@dataclass
class NetConfig:
    n_ranks: int
    link_gbps: float
    base_latency: float = 5e-6
    reconfig_latency: float = 0.0


class ReconfigurableBackend:
    """Time-stepped fabric: one active bandwidth matrix at a time.

    Reconfiguration *timing* (busy-until semantics) delegates to an
    internal :class:`~repro_torch.core.fabric.CrossbarOCS` — the SAME
    switch model the control plane's orchestrators drive — so the
    ``PlaneBackendBridge`` can never drift from the real OCS driver's
    completion-time arithmetic.  This class adds what the switch model
    does not have: G1/G2 *rejection* semantics (the switch queues;
    the analytical backend errors, per the paper's correctness rules).
    """

    def __init__(self, cfg: NetConfig,
                 candidates: Dict[int, np.ndarray]):
        self.cfg = cfg
        self.candidates = {k: np.asarray(v, dtype=float)
                           for k, v in candidates.items()}
        for k, m in self.candidates.items():
            assert m.shape == (cfg.n_ranks, cfg.n_ranks), (k, m.shape)
        self.active_id: Optional[int] = None
        self.active: np.ndarray = np.zeros((cfg.n_ranks, cfg.n_ranks))
        self.inflight: int = 0
        self.reconfig_until: float = -1.0
        self.queue: List[Tuple[float, float]] = []  # (arrival, duration)
        self._switch = CrossbarOCS(n_ports=cfg.n_ranks,
                                   reconfig_latency=cfg.reconfig_latency)
        self.n_rejections = 0

    @property
    def n_reconfigs(self) -> int:
        """Accepted reconfigurations — counted by the shared switch
        model (one program() per accepted reconfigure)."""
        return self._switch.n_program_calls

    def register_candidate(self, topo_id: int, matrix: np.ndarray):
        """Add (or replace) a circuit configuration at runtime — used by
        the ControlPlane bridge, which discovers topologies as the real
        orchestrators program them."""
        m = np.asarray(matrix, dtype=float)
        assert m.shape == (self.cfg.n_ranks, self.cfg.n_ranks), m.shape
        self.candidates[topo_id] = m

    # -- reconfiguration ----------------------------------------------------
    def reconfigure(self, topo_id: int, now: float) -> float:
        """Switch the active matrix.  Returns completion time."""
        if self.inflight > 0:
            self.n_rejections += 1
            raise RuntimeError(
                "G2 violation: reconfigure with collective in flight")
        if now < self.reconfig_until:
            self.n_rejections += 1
            raise RuntimeError(
                "reconfigure while another reconfiguration pending")
        if topo_id == self.active_id:
            return now  # no-op (O1 suppression downstream)
        # drain is implicit: inflight == 0.  Completion time comes from
        # the real switch model's program() (busy-until + latency); the
        # rejection checks above guarantee the switch is idle, so this
        # never queues — asserted via the switch's own counter.
        self.active_id = topo_id
        self.active = self.candidates[topo_id]
        self.reconfig_until = self._switch.program([], [], now)
        assert self._switch.n_queued_programs == 0, \
            "rejection semantics should have caught a busy switch"
        return self.reconfig_until

    # -- traffic ------------------------------------------------------------
    def transfer(self, src: int, dst: int, nbytes: float,
                 now: float) -> float:
        """Point-to-point transfer on the active circuit.  Returns end
        time.  Arrivals during reconfiguration queue until it completes."""
        start = max(now, self.reconfig_until)
        bw = self.active[src, dst]
        if bw <= 0:
            raise RuntimeError(f"no circuit {src}->{dst} in topo "
                               f"{self.active_id}")
        dur = self.cfg.base_latency + nbytes * 8.0 / (bw * 1e9)
        self.inflight += 1
        return start + dur

    def complete(self):
        assert self.inflight > 0
        self.inflight -= 1

    def ring_collective(self, ranks: List[int], bytes_per_rank: float,
                        now: float) -> float:
        """Duration of a ring collective over `ranks` on active circuits.

        Validates every hop exists (circuit-legality check), then applies
        the bandwidth-optimal ring time at the slowest link.
        """
        n = len(ranks)
        if n <= 1:
            return now
        start = max(now, self.reconfig_until)
        bws = []
        for i in range(n):
            a, b = ranks[i], ranks[(i + 1) % n]
            bw = self.active[a, b]
            if bw <= 0:
                raise RuntimeError(
                    f"ring hop {a}->{b} missing in topo {self.active_id}")
            bws.append(bw)
        bw_min = min(bws)
        dur = self.cfg.base_latency * (n - 1) \
            + bytes_per_rank * 8.0 / (bw_min * 1e9)
        return start + dur


def ring_matrix(n: int, ranks: List[int], gbps: float) -> np.ndarray:
    """Bandwidth matrix wiring `ranks` into a bidirectional ring.

    Ring enumeration delegates to ``core.topo.ring_pairs`` — the same
    builder the orchestrators program sub-mappings from — so the
    analytical matrices cannot drift from the circuits the control plane
    actually dispatches (a single port is no ring: no self-loop)."""
    return pairs_matrix(n, list(ring_pairs(ranks)), gbps)


def pairs_matrix(n: int, pairs: List[Tuple[int, int]],
                 gbps: float) -> np.ndarray:
    m = np.zeros((n, n))
    for a, b in pairs:
        m[a, b] = gbps
        m[b, a] = gbps
    return m


def full_matrix(n: int, gbps: float) -> np.ndarray:
    """EPS baseline: all links that any circuit configuration could form
    are always active (strictly more bandwidth, paper §5.3)."""
    m = np.full((n, n), gbps)
    np.fill_diagonal(m, 0.0)
    return m


# ---------------------------------------------------------------------------
# ControlPlane bridge (the "hooks" side of repro_torch.core.plane)
# ---------------------------------------------------------------------------


class PlaneBackendBridge:
    """Mirrors real ControlPlane reconfigurations into this backend.

    Register via ``ControlPlane(..., listeners=[bridge.listener])`` (or
    append to ``plane.listeners``): every completed topo_write barrier
    that actually reprogrammed a rail is replayed as a
    ``reconfigure(topo_id, now)`` on the analytical backend, with the
    bandwidth matrix derived from the rail-0 OCS circuit table at that
    instant.  G1/G2 rejection semantics therefore apply to the real
    control plane's dispatch stream.
    """

    def __init__(self, cfg: NetConfig, link_gbps: Optional[float] = None):
        self.backend = ReconfigurableBackend(cfg, {})
        self.link_gbps = link_gbps if link_gbps is not None else cfg.link_gbps
        self.n_applied = 0
        # every applied dispatch, in order: (group_id, topo_id, circuit
        # pairs, time).  The rank-equivalence-class plane must produce THE
        # SAME log as the uncollapsed plane (tests/test_plane_collapse.py)
        # — the bridge is the observability point for that contract.
        self.dispatch_log: List[Tuple[str, int, Tuple[Tuple[int, int], ...],
                                      float]] = []

    GIANT_RING_ID = -1   # fallback circuits match no TopoId encoding

    def listener(self, plane, group_id: str, write, now: float):
        if not write.reconfigured:
            return
        rail = plane.orchestrators[0]
        tid = (self.GIANT_RING_ID if plane.fallback_giant_ring
               else plane.controller.topo[rail.rail_id].encode())
        pairs = tuple(sorted(rail.ocs.circuits.items()))
        self.backend.register_candidate(
            tid, pairs_matrix(self.backend.cfg.n_ranks, list(pairs),
                              self.link_gbps))
        self.backend.reconfigure(tid, now)
        self.n_applied += 1
        self.dispatch_log.append((group_id, tid, pairs, now))
