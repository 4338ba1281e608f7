"""Roofline terms of a dry-run cell (a copy of ``repro.analysis.roofline``,
which the port does not import).

    compute term    = FLOPs / peak FLOP/s                    per device
    memory term     = bytes / HBM bytes/s                    per device
    collective term = rail_bytes / (links x link bytes/s)    the rails
                    + scaleup_bytes / scale-up bytes/s       the model axis

In the port a cell's FLOPs are counted over the plain versions on the meta
device (``analysis.cost``), its bytes come from the analytic traffic model
(``analysis.memmodel``) and its collective bytes from the ``Fabric`` and
``ModelAxis`` counts of the step it runs (``launch.dryrun``).  The default
profile is the port's card, ``h100``; ``tpu_v5e`` (the JAX package's
default) stays selectable.  The scale-up term divides by the profile's
``scale_up_gbps`` (NVLink4's 450 GB/s on an H100), where the JAX package
divides by ``scaleup_links x ici_link_bw``: the two are equal for
``tpu_v5e`` (4 x 50e9 = 1600 Gb/s).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.hardware import PROFILES, HardwareProfile

# the dry-run's default platform: the port's card
DEFAULT_PROFILE = PROFILES["h100"]


@dataclass
class Roofline:
    r"""All hlo_*/\*_bytes quantities are PER-DEVICE (one rank's step; the
    names are the JAX package's, whose counts come from the compiled
    module).  model_flops is GLOBAL (6ND over the global batch).
    """

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # per-device
    hlo_bytes: float             # per-device
    rail_bytes: float            # per-device, data+pod collectives
    scaleup_bytes: float         # per-device, model-axis collectives
    model_flops: float           # GLOBAL useful FLOPs
    profile: HardwareProfile = field(default=DEFAULT_PROFILE)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.profile.flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.profile.hbm_bw

    @property
    def t_rail(self) -> float:
        return self.rail_bytes / (self.profile.ici_links
                                  * self.profile.ici_link_bw)

    @property
    def t_scaleup(self) -> float:
        return self.scaleup_bytes / (self.profile.scale_up_gbps * 1e9 / 8)

    @property
    def t_collective(self) -> float:
        return self.t_rail + self.t_scaleup

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_bound(self) -> float:
        """Lower bound on step time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs (remat/redundancy waste detector).

        Per-device: model_flops/chips vs the per-partition HLO count."""
        return (self.model_flops / self.chips) / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful compute time / step bound."""
        t_useful = self.model_flops / (self.chips * self.profile.flops)
        return t_useful / max(self.step_bound, 1e-30)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "rail_bytes": self.rail_bytes,
            "scaleup_bytes": self.scaleup_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_rail": self.t_rail, "t_scaleup": self.t_scaleup,
            "bottleneck": self.bottleneck, "step_bound": self.step_bound,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_corrected(arch, shape, mesh_name, chips, cc, model_flops, *,
                   profile: HardwareProfile = DEFAULT_PROFILE) -> Roofline:
    """Build from a per-device cost with the JAX package's fields: ``flops``,
    ``bytes_accessed`` and ``collective_bytes`` ({axis: {"_bytes": n}})."""
    coll = cc.collective_bytes
    rail = float(coll.get("data", {}).get("_bytes", 0)
                 + coll.get("pod", {}).get("_bytes", 0))
    sup = float(coll.get("model", {}).get("_bytes", 0))
    return Roofline(arch, shape, mesh_name, chips, cc.flops,
                    cc.bytes_accessed, rail, sup, model_flops, profile)
