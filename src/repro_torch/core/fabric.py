"""The rail fabric's switch model, behind ONE import surface (a copy of
``repro.core.fabric`` without its datapath, DESIGN.md §10).

``repro_torch.core.fabric`` is the port's module for the fabric the control
plane programs: the declarative :class:`FabricSpec` the simulator times
AND the cost model bills, plus the :class:`SwitchBackend` family behind
every rail (crossbar OCS, ACOS-style OCS array, patch panel, packet
switch).  It models switches and moves no tensor.  The datapath, the ring
collectives a step runs over the rails, is ``repro_torch.fabric``
(``Fabric``), a module of its own: this one does not re-export it.

``repro_torch.core.fabricspec`` (the spec's former home) remains as a thin
deprecation alias.

The paper's two headline results are computed from the same hardware:
the <6% training overhead (Figs 10-13) comes from simulating a switch's
reconfiguration behaviour, and the 23x/4x power/cost savings (Fig 14)
from pricing that switch's ports.  Historically this repo described the
fabric twice — ``SimParams.mode`` strings on the timing side and
``costmodel`` part-name strings on the billing side — which could drift.
:class:`FabricSpec` is the one declarative object both sides consume:

    switch technology      which :class:`SwitchBackend` the rails run
    radix                  ports per (sub-)switch — ACOS-style arrays of
                           small OCSes are ``ocs_array`` with a small radix
    reconfig-latency model reconfig_latency + nic_linkup seconds/program
    scheduler              circuit-scheduling granularity (DESIGN.md §13):
                           ``phase_boundary`` (paper default) or
                           ``per_collective`` (PCCL-style rounds)
    per-port cost/power    ``part`` names a costmodel.PARTS entry; the
                           Fig-14 bill is derived from THIS spec

``SwitchBackend`` is the vendor-neutral switch interface extracted from
the original in-memory OCS driver (TL1/SCPI/NETCONF in hardware).  Four
implementations cover the paper's design space plus the related work's
(ACOS arrays, PCCL per-collective circuits, static baselines):

    CrossbarOCS   one non-blocking crossbar per rail (the paper's OCS;
                  previously ``orchestrator.OCSDriver`` — behaviour is
                  bit-identical, the class merely moved and was renamed)
    OCSArray      an array of radix-limited sub-switches (ACOS): a
                  circuit spanning sub-switch boundaries is physically
                  impossible and is REJECTED (CrossSubSwitchError),
                  surfacing the admission/fragmentation effects a single
                  big crossbar hides; disjoint sub-switches reconfigure
                  in parallel (independent busy clocks)
    PatchPanel    passive fibre panel: circuits are patched once when a
                  job registers and unpatched when it leaves; a
                  reconfiguration dispatch (disconnect+connect in one
                  program) raises StaticFabricError — ``oneshot`` runs
                  on THIS through the real control plane instead of a
                  closed-form bypass
    PacketSwitch  electrical packet switch: always-connected, programs
                  are accepted but free and hold no circuit state —
                  ``native`` through the plane too
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.core.scheduler import PHASE_BOUNDARY, SCHEDULERS

CROSSBAR_OCS = "crossbar_ocs"
OCS_ARRAY = "ocs_array"
PATCH_PANEL = "patch_panel"
PACKET = "packet"

TECHNOLOGIES = (CROSSBAR_OCS, OCS_ARRAY, PATCH_PANEL, PACKET)


class StaticFabricError(RuntimeError):
    """A reconfiguration dispatch reached a fabric that cannot move."""


class CrossSubSwitchError(ValueError):
    """A circuit would span two sub-switches of an OCSArray."""


class SwitchBackend:
    """Vendor-neutral switch interface (extracted from the original OCS
    driver): ``program(disconnect, connect, now) -> done`` plus circuit
    and timing state.  Subclasses model the technologies above; the
    orchestrator only ever talks to this interface."""

    #: False for fabrics with no circuit state to program (PacketSwitch):
    #: the orchestrator skips programming AND programming counters, so
    #: telemetry honestly reports zero ports programmed.
    programmable = True

    def __init__(self, n_ports: int, reconfig_latency: float = 0.0):
        self.n_ports = n_ports
        self.reconfig_latency = reconfig_latency
        self.circuits: Dict[int, int] = {}       # src -> dst
        self.n_program_calls = 0
        self.n_ports_programmed = 0
        self.busy_until = 0.0
        # reconfiguration serialization: programs that found the switch
        # mid-reconfiguration and had to queue behind it.  The switch has
        # no tenant concept, so this counts queueing behind ANY in-flight
        # program — another job's (cluster contention) or this job's own
        # back-to-back dispatches — a property of the switch, not of who
        # asked.
        self.n_queued_programs = 0
        self.queue_wait_s = 0.0

    def program(self, disconnect: List[int], connect: List[Tuple[int, int]],
                now: float = 0.0) -> float:
        """Apply a partial reprogram; returns completion time.

        Non-blocking: ports not named are untouched.  Raises on conflicts
        (connecting a port already in another circuit) — G-invariant
        violations surface as errors, not silent corruption.
        """
        self._apply_circuits(disconnect, connect)
        self.n_program_calls += 1
        self.n_ports_programmed += len(disconnect) + len(connect)
        wait = max(0.0, self.busy_until - now)
        if wait > 0.0:
            self.n_queued_programs += 1
            self.queue_wait_s += wait
        done = max(now, self.busy_until) + self.reconfig_latency
        self.busy_until = done
        return done

    def _apply_circuits(self, disconnect: List[int],
                        connect: List[Tuple[int, int]]) -> None:
        for p in disconnect:
            self.circuits.pop(p, None)
        for a, b in connect:
            if a in self.circuits:
                raise ValueError(f"port {a} already connected")
            if not (0 <= a < self.n_ports and 0 <= b < self.n_ports):
                raise ValueError(f"port out of range: {(a, b)}")
            self.circuits[a] = b

    def connected(self, a: int) -> Optional[int]:
        return self.circuits.get(a)

    def circuit_snapshot(self) -> List[Tuple[int, int]]:
        """The live circuit table as sorted (src, dst) pairs — the
        digital-twin inventory unit (DESIGN.md §14).  A circuit-free
        fabric (PacketSwitch) reports an empty table."""
        return sorted(self.circuits.items())


class CrossbarOCS(SwitchBackend):
    """One non-blocking crossbar per rail — the paper's OCS and the
    default backend.  This IS the original ``OCSDriver`` (renamed; the
    old name stays importable from ``repro_torch.core.orchestrator``)."""


class OCSArray(SwitchBackend):
    """ACOS-style array of radix-limited sub-switches sharing one rail's
    port space: port ``p`` lives on sub-switch ``p // radix``.

    * a circuit spanning sub-switch boundaries is physically impossible
      and raises :class:`CrossSubSwitchError` — the admission effect the
      single crossbar hides (placements/grants must fit a sub-switch);
    * each sub-switch has its own reconfiguration clock: programs that
      touch disjoint sub-switches do not serialize, so an array can be
      LESS contended than one big crossbar under multi-tenant load.
    """

    def __init__(self, n_ports: int, radix: int,
                 reconfig_latency: float = 0.0):
        assert 1 <= radix <= n_ports, (radix, n_ports)
        super().__init__(n_ports, reconfig_latency)
        self.radix = radix
        self.n_sub = math.ceil(n_ports / radix)
        self.sub_busy_until = [0.0] * self.n_sub
        self.n_rejected_programs = 0

    def sub_switch(self, port: int) -> int:
        return port // self.radix

    def fits(self, ports) -> bool:
        """True when ``ports`` all sit inside ONE sub-switch — THE
        placement rule shared by cluster admission (ClusterSim._admit)
        and plane registration (ControlPlane._check_subswitch_fit):
        circuits are only ever wired among a job's own ports, so a
        one-sub-switch port set makes every dispatchable topology
        (including the §4.2 fallback ring) physically wireable."""
        return self.sub_switch(min(ports)) == self.sub_switch(max(ports))

    def program(self, disconnect: List[int], connect: List[Tuple[int, int]],
                now: float = 0.0) -> float:
        spanning = [(a, b) for a, b in connect
                    if self.sub_switch(a) != self.sub_switch(b)]
        if spanning:
            self.n_rejected_programs += 1
            raise CrossSubSwitchError(
                f"circuits span sub-switch boundaries (radix "
                f"{self.radix}): {spanning[:4]}"
                f"{'...' if len(spanning) > 4 else ''}")
        self._apply_circuits(disconnect, connect)
        self.n_program_calls += 1
        self.n_ports_programmed += len(disconnect) + len(connect)
        touched = sorted({self.sub_switch(p) for p in disconnect}
                         | {self.sub_switch(a) for a, _ in connect})
        done = now
        for s in touched:
            wait = max(0.0, self.sub_busy_until[s] - now)
            if wait > 0.0:
                self.n_queued_programs += 1
                self.queue_wait_s += wait
            fin = max(now, self.sub_busy_until[s]) + self.reconfig_latency
            self.sub_busy_until[s] = fin
            done = max(done, fin)
        self.busy_until = max(self.sub_busy_until)
        return done


class PatchPanel(SwitchBackend):
    """Passive fibre patch panel: circuits are patched in when a job
    registers (connect-only program) and unpatched at departure
    (disconnect-only program).  A reconfiguration dispatch — one program
    that both disconnects and connects — is a runtime topology change a
    patch panel cannot perform and raises :class:`StaticFabricError`.
    The one-time patching costs ``reconfig_latency`` like any program
    (job setup, off the training critical path)."""

    def program(self, disconnect: List[int], connect: List[Tuple[int, int]],
                now: float = 0.0) -> float:
        if disconnect and connect:
            raise StaticFabricError(
                "patch panel cannot reconfigure at runtime "
                f"({len(disconnect)} disconnects + {len(connect)} "
                "connects in one program)")
        return super().program(disconnect, connect, now)


class PacketSwitch(SwitchBackend):
    """Electrical packet switch: every port pair is always connected, so
    there are no circuits to hold and nothing to program — programs are
    accepted, cost nothing, and leave no state (``native`` mode's fabric,
    now behind the same interface as the photonic ones)."""

    programmable = False

    def program(self, disconnect: List[int], connect: List[Tuple[int, int]],
                now: float = 0.0) -> float:
        return now

    def connected(self, a: int) -> Optional[int]:
        return None


# ---------------------------------------------------------------------------
# the declarative spec
# ---------------------------------------------------------------------------

# which backend each SimParams.mode naturally runs on, and which others
# are physically coherent (the DESIGN.md §10 mode x backend matrix).
# opus modes need a fabric that can move; native needs always-on
# connectivity only a packet switch provides; oneshot sets circuits once,
# which any circuit-holding fabric can do (a patch panel is merely the
# cheapest hardware that suffices).
NATURAL_BACKEND = {
    "native": PACKET,
    "oneshot": PATCH_PANEL,
    "opus": CROSSBAR_OCS,
    "opus_prov": CROSSBAR_OCS,
}
MODE_BACKENDS = {
    "native": (PACKET,),
    "oneshot": (PATCH_PANEL, CROSSBAR_OCS, OCS_ARRAY),
    "opus": (CROSSBAR_OCS, OCS_ARRAY),
    "opus_prov": (CROSSBAR_OCS, OCS_ARRAY),
}

# default costmodel.PARTS entry per technology (overridable per spec)
DEFAULT_PART = {
    CROSSBAR_OCS: "ocs",
    OCS_ARRAY: "ocs_small",
    PATCH_PANEL: "patch_panel",
    PACKET: "eps_400g",
}


@dataclass(frozen=True)
class FabricSpec:
    """Declarative description of one rail fabric — the ONE object the
    simulator times and the cost model bills (DESIGN.md §10).

    ``radix`` bounds the ports per (sub-)switch: ``None`` means one
    switch spans the whole rail (crossbar / packet), a value means
    OCSArray sub-switches of that size AND ``ceil(rail_size/radix)``
    chassis in the Fig-14 bill.  ``scheduler`` names the circuit-
    scheduling granularity (``repro_torch.core.scheduler``, DESIGN.md §13):
    ``phase_boundary`` reconfigures at parallelism-phase boundaries (the
    paper), ``per_collective`` per collective round (PCCL) — the latter
    needs a fabric whose circuits can move mid-job.  ``part`` names the
    ``sim.costmodel.PARTS`` entry pricing each port; ``ports_per_link``
    is the OCS fibre ports one NIC link occupies (2 for 800G links).
    """

    technology: str = CROSSBAR_OCS
    n_rails: int = 1
    reconfig_latency: float = 0.0     # seconds per switch program
    nic_linkup: float = 0.0           # §5.1 firmware link-up penalty
    radix: Optional[int] = None       # ports per sub-switch (OCSArray)
    scheduler: str = PHASE_BOUNDARY   # circuit-scheduling granularity (§13)
    part: Optional[str] = None        # costmodel part; None = tech default
    ports_per_link: int = 1

    def __post_init__(self):
        assert self.technology in TECHNOLOGIES, self.technology
        assert self.n_rails >= 1, self.n_rails
        assert self.ports_per_link >= 1, self.ports_per_link
        if self.scheduler not in SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {self.scheduler!r}; "
                f"one of {sorted(SCHEDULERS)}")
        if self.scheduler != PHASE_BOUNDARY and not self.reconfigurable:
            raise ValueError(
                f"scheduler {self.scheduler!r} reprograms circuits per "
                f"collective round; a {self.technology} fabric cannot move")
        if self.technology == OCS_ARRAY:
            assert self.radix is not None, \
                "ocs_array needs an explicit sub-switch radix"
            assert self.radix >= 1, self.radix
        elif self.radix is not None:
            # the bill would size ceil(rail_size/radix) chassis while the
            # timing side built one whole-rail switch — exactly the
            # timed-vs-billed drift this spec exists to prevent
            raise ValueError(
                f"radix only applies to ocs_array, not {self.technology}")

    # -- mode x backend matrix ----------------------------------------------
    @property
    def reconfigurable(self) -> bool:
        """Can circuits change during a job? (patch panels hold them
        static; packet switches have none at all)"""
        return self.technology in (CROSSBAR_OCS, OCS_ARRAY)

    @property
    def circuit_switched(self) -> bool:
        """Do collectives EXECUTE on physical circuits (rings/matchings)
        rather than packet routes?  This is where the scheduler axis has
        effect: a ring-executed all-to-all pays the §7 forwarding tax a
        packet fabric never sees."""
        return self.technology != PACKET

    def validate_mode(self, mode: str) -> "FabricSpec":
        allowed = MODE_BACKENDS.get(mode)
        if allowed is None:
            raise ValueError(f"unknown mode {mode!r}")
        if self.technology not in allowed:
            raise ValueError(
                f"mode {mode!r} cannot run on a {self.technology} backend "
                f"(allowed: {', '.join(allowed)})")
        if self.scheduler != PHASE_BOUNDARY and mode not in ("opus",
                                                             "opus_prov"):
            raise ValueError(
                f"scheduler {self.scheduler!r} needs shims that write "
                f"(opus/opus_prov), not mode {mode!r} — a static-fabric "
                "mode never reprograms a circuit round")
        return self

    @classmethod
    def for_mode(cls, mode: str, *, ocs_latency: float = 0.0,
                 nic_linkup: float = 0.0, n_rails: int = 1,
                 technology: Optional[str] = None,
                 radix: Optional[int] = None,
                 scheduler: Optional[str] = None,
                 part: Optional[str] = None,
                 ports_per_link: int = 1) -> "FabricSpec":
        """The back-compat constructor behind ``SimParams.mode``: map a
        mode string (plus the legacy latency knobs) onto its natural
        backend, or a compatible override via ``technology``."""
        tech = technology if technology is not None else NATURAL_BACKEND[mode]
        return cls(technology=tech, n_rails=n_rails,
                   reconfig_latency=ocs_latency, nic_linkup=nic_linkup,
                   radix=radix,
                   scheduler=(scheduler if scheduler is not None
                              else PHASE_BOUNDARY),
                   part=part,
                   ports_per_link=ports_per_link).validate_mode(mode)

    def with_rails(self, n_rails: int) -> "FabricSpec":
        return replace(self, n_rails=n_rails)

    # -- the timing side ------------------------------------------------------
    @property
    def program_latency(self) -> float:
        return self.reconfig_latency + self.nic_linkup

    def make_backend(self, n_ports: int) -> SwitchBackend:
        """One rail's switch: the simulator's per-rail backend instance."""
        if self.technology == CROSSBAR_OCS:
            return CrossbarOCS(n_ports, reconfig_latency=self.program_latency)
        if self.technology == OCS_ARRAY:
            return OCSArray(n_ports, radix=min(self.radix, n_ports),
                            reconfig_latency=self.program_latency)
        if self.technology == PATCH_PANEL:
            return PatchPanel(n_ports, reconfig_latency=self.program_latency)
        return PacketSwitch(n_ports, reconfig_latency=0.0)

    # -- the billing side -----------------------------------------------------
    @property
    def part_name(self) -> str:
        return self.part if self.part is not None \
            else DEFAULT_PART[self.technology]
