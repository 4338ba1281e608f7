#!/usr/bin/env python3
"""A/B on one card of the SSD scan's shape-specialised build against its
generic build, at mamba2-370m's prefill shape.

    python3 scripts/ssd_full_build_ab.py [--rounds 3] [--iters 20]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  ``csrc/ssd_scan.cu`` builds passes B and D twice: ``FULL``, with the
chunk, P and N at their largest and 16-byte row copies known to the
compiler, which it launches at P=64, N=128, chunk 64 with 16-byte aligned
rows; and a generic build for every other shape.  This script compiles a
second library from the same source with that choice switched off, so that
the main shape runs the generic passes, and times both on the same inputs
(x, B and C strided slices of one conv output, as ``ssm_apply`` passes
them).  Each round runs the builds in the order FULL, generic, generic,
FULL; each reading is torch.profiler's device time per call, by pass, over
``--iters`` calls.  Both builds are held against the plain version to
``ref.ssd_tolerance_ratio`` <= 1.  Prints one line per reading, the
median of each build, and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# the specialised build is chosen on this line of repro_ssd_scan_fwd
FULL_CHOICE = "const bool full = L == MAX_L"


def generic_kernel():
    """A CudaKernel of csrc/ssd_scan.cu with the FULL passes never chosen."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as tssd
    text = tssd.KERNEL.source.read_text()
    if text.count(FULL_CHOICE) != 1:
        raise RuntimeError(f"{tssd.KERNEL.source}: expected one '{FULL_CHOICE}'")
    src = _build.BUILD_DIR / "ssd_scan_generic.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(FULL_CHOICE, "const bool full = false && L == MAX_L"))

    class Generic(_build.CudaKernel):
        @property
        def source(self) -> Path:
            return src

    return Generic("ssd_scan_generic", tssd.KERNEL.signatures)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_full_build_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as tssd

    generic = generic_kernel()
    secs = _build.build_all([tssd.KERNEL, generic])
    print(f"built both in {secs:.1f} s", flush=True)
    libs = {"full": tssd.KERNEL.lib(), "generic": generic.lib()}
    for label, k in (("full", tssd.KERNEL), ("generic", generic)):
        for fn, res in k.resources().items():
            print(f"[{label}] {fn}: {res}", flush=True)

    b, s, h, p, g, n, chunk = 1, 32768, 32, 64, 1, 128, 64
    x, dt, a, bm, cm, _ = cs.ssd_inputs(b, s, h, p, g, n, seed=1)
    y_w, st_w = ref.ssd_chunked(x, dt, a, bm, cm, chunk)

    def use(label):
        tssd.KERNEL._lib = libs[label]
        tssd.plan.cache_clear()  # the plan sets each library's shared-memory limits

    for label in libs:
        use(label)
        y, st = tssd.ssd_scan(x, dt, a, bm, cm, chunk)
        ratios = (ref.ssd_tolerance_ratio(y, y_w), ref.ssd_tolerance_ratio(st, st_w, head_dim=1))
        print(f"[{label}] tolerance ratio y {ratios[0]:.4f}, state {ratios[1]:.4f}", flush=True)
        if not max(ratios) <= 1:
            raise AssertionError(f"{label} build disagrees with the plain version")
    del y, st, y_w, st_w
    torch.cuda.empty_cache()

    readings = {label: [] for label in libs}
    for r in range(args.rounds):
        for label in ("full", "generic", "generic", "full"):
            use(label)
            per = cs.device_ms_by_kernel(lambda: tssd.ssd_scan(x, dt, a, bm, cm, chunk),
                                         args.iters)
            want = "<true>" if label == "full" else "<false>"
            passes = {k: sum(v for key, v in per.items() if k in key) for k in cs.SSD_PASSES}
            ran = [key for key in per if "ssd_output_kernel" in key]
            if not ran or not all(want in key for key in ran):
                raise AssertionError(f"{label}: output pass not the {want} build: {ran}")
            total = sum(passes.values())
            readings[label].append({"total": total, **passes})
            print(f"round {r} {label:7s} {total:.4f} ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()), flush=True)
    med = {label: {k: statistics.median(rd[k] for rd in rs) for k in rs[0]}
           for label, rs in readings.items()}
    gain = med["generic"]["total"] / med["full"]["total"]
    print(f"median device ms per call: full {med['full']['total']:.4f}, generic "
          f"{med['generic']['total']:.4f} (generic / full {gain:.4f}); spread full "
          f"{min(rd['total'] for rd in readings['full']):.4f}-"
          f"{max(rd['total'] for rd in readings['full']):.4f}, generic "
          f"{min(rd['total'] for rd in readings['generic']):.4f}-"
          f"{max(rd['total'] for rd in readings['generic']):.4f}")
    print(json.dumps({"median_device_ms": med, "readings": readings}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
