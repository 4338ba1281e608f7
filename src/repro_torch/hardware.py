"""One hardware description for the roofline and the calibration fit (a
copy of ``repro.hardware``, which the port does not import).

``PROFILES`` holds the JAX package's rows verbatim and one more, ``h100``:
the card the port runs on (NVIDIA's data sheet, SXM part, dense bf16 without
sparsity, HBM3 at 3.35 TB/s, 700 W; a DGX H100's 8-GPU NVLink domain,
ConnectX-7 at 400 Gb/s, NVLink4 at 3600 Gb/s).  Without it, a fit of
timings taken on this card would be quoted against an H200's HBM.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class HardwareProfile:
    """Per-chip description: roofline denominators + fabric-facing spec.

    ``flops``/``mfu``/``scale_out_gbps``/``scale_up_gbps``/``domain``/
    ``tdp_w`` mirror the simulator's GPUSpec; ``hbm_bw`` and the ICI
    fields are the roofline's memory/collective denominators.
    """

    name: str
    flops: float            # peak dense bf16 FLOP/s
    mfu: float              # flat analytic fraction (uncalibrated default)
    scale_out_gbps: float   # per-GPU NIC bandwidth (one direction)
    scale_up_gbps: float    # per-GPU intra-domain bandwidth
    domain: int             # GPUs per scale-up domain
    tdp_w: float            # board power
    hbm_bw: float           # bytes/s per chip
    ici_link_bw: float = 50e9   # bytes/s per scale-out link
    ici_links: int = 2          # ring degree (paper: 2-degree scale-out)
    scaleup_links: int = 4      # intra-domain links per chip


PROFILES: Dict[str, HardwareProfile] = {
    # Perlmutter node: 4x A100, Slingshot-11 (200 Gb/s per NIC), NVLink3
    "a100": HardwareProfile("a100", 312e12, 0.35, 200.0, 1600.0, 4,
                            tdp_w=400.0, hbm_bw=2.0e12),
    # DGX H200: 8 GPUs, CX-7 400 Gb/s, NVLink4
    "h200": HardwareProfile("h200", 989e12, 0.40, 400.0, 3600.0, 8,
                            tdp_w=700.0, hbm_bw=4.8e12),
    # GB200 NVL72: 800 Gb/s scale-out per GPU (paper §5.3)
    "gb200": HardwareProfile("gb200", 2500e12, 0.40, 800.0, 14400.0, 8,
                             tdp_w=1200.0, hbm_bw=8.0e12),
    # DGX H100: 8 GPUs, CX-7 400 Gb/s, NVLink4 (the port's card)
    "h100": HardwareProfile("h100", 989e12, 0.40, 400.0, 3600.0, 8,
                            tdp_w=700.0, hbm_bw=3.35e12),
    # TPU v5e (the dry-run cross-check platform; roofline constants)
    "tpu_v5e": HardwareProfile("tpu_v5e", 197e12, 0.45, 400.0, 1600.0, 16,
                               tdp_w=220.0, hbm_bw=819e9),
}
