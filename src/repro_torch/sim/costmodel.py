"""Network cost & power model (paper Fig 14).

Components follow the paper's citations ([16-18, 44, 52, 63]); prices and
powers are public list-price class numbers.  The comparison replaces, per
rail, the electrical packet switch + its switch-side optical transceivers
with an OCS (passive optical datapath: no ASIC, no transceivers, no DSP).
Server-side (NIC) optics exist identically in both designs and are
excluded, as are fiber cables (Fig 14 caption).

Fabrics:
  eps_h200   per-rail electrical: 64x400G Tomahawk-class switch [17]
             + 400G-XDR4 transceiver per port [16]
  eps_gb200  co-packaged-optics 800G switch (Quantum-X800 class [44,52]);
             CPO integrates optics: no pluggables, but the ASIC+laser
             power/cost per port is higher
  ocs        Polatis/Coherent-class OCS [63,13]: ~$100k per 384-port
             chassis, 45-75 W total (drive electronics only)
  ocs_small  64-port MEMS-class small OCS (the ACOS argument: arrays of
             cheap small switches) — the OCSArray backend's default part
  patch_panel passive LC fibre patch panel: structured-cabling list
             price per duplex port, zero power — the oneshot baseline's
             hardware

Scaling: one rail per scale-up-domain rank; rail size = #domains; switches
per rail = ceil(rail_size / ports_per_switch) (single-tier within the
paper's 128-2,048 GPU range; beyond 18K GPUs per rail see §7).

The bill is derived from the SAME :class:`repro_torch.core.fabric.
FabricSpec` the simulator times (DESIGN.md §10): ``rail_fabric`` /
``compare`` accept a spec — technology picks the part, ``radix`` sizes
the chassis count — so the Fig-14 numbers cannot drift from the timed
hardware.  Bare part-name strings remain accepted (they resolve to the
equivalent spec).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Union

from repro_torch.core.fabric import CROSSBAR_OCS, PACKET, FabricSpec


@dataclass(frozen=True)
class SwitchPart:
    name: str
    ports: int
    cost: float              # $ per switch chassis
    power: float             # W per chassis (ASIC + fans, no optics)
    optics_cost: float       # $ per port (switch-side transceiver / CPO)
    optics_power: float      # W per port


PARTS: Dict[str, SwitchPart] = {
    # FS N9510-64D 64x400G (Tomahawk-4) [17] + 400G XDR4 pluggable [16]
    "eps_400g": SwitchPart("eps_400g", 64, 32_000.0, 1_100.0, 800.0, 8.0),
    # Quantum-X800-class 144x800G CPO switch [44, 52, 8]
    "eps_800g_cpo": SwitchPart("eps_800g_cpo", 144, 280_000.0, 3_500.0,
                               0.0, 7.0),
    # Polatis 6000n / Coherent liquid-crystal OCS [63, 13]: passive
    # datapath, ~$300/port, ~1 W/port drive electronics
    "ocs": SwitchPart("ocs", 384, 117_000.0, 400.0, 0.0, 0.0),
    # 64-port MEMS-class small OCS (ACOS-style array element): smaller
    # mirror array, commodity control board — cheaper per port than the
    # big chassis, slightly more drive power per port
    "ocs_small": SwitchPart("ocs_small", 64, 12_000.0, 70.0, 0.0, 0.0),
    # passive LC patch panel, structured-cabling class: ~$40/port, 0 W
    "patch_panel": SwitchPart("patch_panel", 96, 3_840.0, 0.0, 0.0, 0.0),
}

# an 800G link occupies two OCS fiber ports (2x400G lambdas); 400G one
OCS_PORTS_PER_LINK = {"eps_400g": 1, "eps_800g_cpo": 2}


@dataclass(frozen=True)
class FabricBill:
    n_gpus: int
    fabric: str
    n_switches: int
    cost: float
    power: float

    @property
    def cost_per_gpu(self) -> float:
        return self.cost / self.n_gpus

    @property
    def power_per_gpu(self) -> float:
        return self.power / self.n_gpus


def _as_spec(fabric: Union[str, FabricSpec],
             ports_per_link: int = 1) -> FabricSpec:
    """Resolve a bare part name to its equivalent FabricSpec (EPS parts
    are packet switches; everything else bills as a crossbar OCS)."""
    if isinstance(fabric, FabricSpec):
        return fabric
    tech = PACKET if fabric.startswith("eps_") else CROSSBAR_OCS
    return FabricSpec(technology=tech, part=fabric,
                      ports_per_link=ports_per_link)


def rail_fabric(n_gpus: int, domain: int,
                fabric: Union[str, FabricSpec],
                ports_per_link: int = 1) -> FabricBill:
    """Bill of materials for a rail-optimized scale-out fabric.

    ``fabric`` is the FabricSpec the simulator timed (or a bare PARTS
    name, resolved to the equivalent spec): ``spec.part_name`` prices
    each port, ``spec.radix`` bounds ports per chassis (OCSArray's small
    sub-switches), ``spec.ports_per_link`` the OCS fibre ports one NIC
    link occupies.  The explicit ``ports_per_link`` argument only applies
    to bare part names (a spec carries its own)."""
    spec = _as_spec(fabric, ports_per_link)
    part = PARTS[spec.part_name]
    ports_per_switch = spec.radix if spec.radix is not None else part.ports
    rails = domain                      # one rail per local rank
    rail_size = (n_gpus // domain) * spec.ports_per_link  # ports per rail
    per_rail_switches = math.ceil(rail_size / ports_per_switch)
    n_sw = rails * per_rail_switches
    # switch cost amortized by port utilization (partial chassis are
    # fractionally billed, matching per-port list pricing practice);
    # a radix-limited sub-switch is billed as radix/part.ports of its
    # part's chassis (per-port list pricing again)
    if ports_per_switch == part.ports:
        chassis_cost, chassis_power = part.cost, part.power
    else:
        chassis_cost = part.cost * ports_per_switch / part.ports
        chassis_power = part.power * ports_per_switch / part.ports
    used_frac = rail_size / (per_rail_switches * ports_per_switch)
    cost = n_sw * chassis_cost * used_frac \
        + rails * rail_size * part.optics_cost
    power = n_sw * chassis_power * used_frac \
        + rails * rail_size * part.optics_power
    return FabricBill(n_gpus, part.name, n_sw, cost, power)


def compare(n_gpus: int, domain: int, eps: Union[str, FabricSpec],
            ocs: Union[str, FabricSpec, None] = None) -> Dict[str, float]:
    """Fig-14 comparison: electrical packet fabric vs the photonic rail
    fabric.  Both sides accept the FabricSpec the simulator timed; the
    default photonic side is the paper's crossbar OCS, sized for the EPS
    link rate (an 800G link occupies two OCS fibre ports)."""
    eps_spec = _as_spec(eps)
    if ocs is None:
        ocs = FabricSpec(
            technology=CROSSBAR_OCS,
            ports_per_link=OCS_PORTS_PER_LINK.get(eps_spec.part_name, 1))
    eps_bill = rail_fabric(n_gpus, domain, eps_spec)
    ocs_bill = rail_fabric(n_gpus, domain, ocs)
    # a zero-cost/zero-power photonic side (a passive patch panel) makes
    # the savings ratio unbounded, not undefined
    return {
        "eps_cost": eps_bill.cost, "ocs_cost": ocs_bill.cost,
        "eps_power": eps_bill.power, "ocs_power": ocs_bill.power,
        "cost_ratio": (eps_bill.cost / ocs_bill.cost
                       if ocs_bill.cost else math.inf),
        "power_ratio": (eps_bill.power / ocs_bill.power
                        if ocs_bill.power else math.inf),
    }
