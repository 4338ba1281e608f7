#!/usr/bin/env python3
"""A/B on one card of the SSD scan's (or its backward's) shape-specialised
build against its generic build, at mamba2-370m's shape.

    python3 scripts/ssd_full_build_ab.py [--kernel fwd|bwd] [--rounds 3] [--iters 20]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  ``csrc/ssd_scan.cu`` builds passes B and D twice, and
``csrc/ssd_scan_bwd.cu`` its local and chunk passes: ``FULL``, with the
chunk, P and N at their largest and 16-byte row copies known to the
compiler, which it launches at P=64, N=128, chunk 64 with 16-byte aligned
rows; and a generic build for every other shape.  This script compiles a
second library from the same source with that choice switched off, so that
the main shape runs the generic passes, and times both on the same inputs
(x, B and C strided slices of one conv output, as ``ssm_apply`` passes
them) at the prefill shape (forward, S=32768) or the training shape
(backward, S=4096, with random cotangents).  Each round runs the builds in
the order FULL, generic, generic, FULL; each reading is torch.profiler's
device time per call, by pass, over ``--iters`` calls.  Both builds are
held against the plain version (``ref.ssd_tolerance_ratio`` or
``ref.ssd_grad_ratios``) <= 1.  Prints one line per reading, the median of
each build, and the card's ``nvidia-smi`` name and power limit.
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
# the specialised build is chosen on this line of each library's entry point
FULL_CHOICE = "const bool full = L == MAX_L"


def generic_kernel(kernel):
    """A CudaKernel of ``kernel``'s source with the FULL passes never chosen."""
    from repro_torch.kernels import _build
    text = kernel.source.read_text()
    if text.count(FULL_CHOICE) != 1:
        raise RuntimeError(f"{kernel.source}: expected one '{FULL_CHOICE}'")
    src = _build.BUILD_DIR / f"{kernel.name}_generic.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(FULL_CHOICE, "const bool full = false && L == MAX_L"))

    class Generic(_build.CudaKernel):
        @property
        def source(self) -> Path:
            return src

    return Generic(f"{kernel.name}_generic", kernel.signatures)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd")
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
    from repro_torch.kernels import ssd_scan_bwd as tssdb

    mod = tssd if args.kernel == "fwd" else tssdb
    generic = generic_kernel(mod.KERNEL)
    secs = _build.build_all([mod.KERNEL, generic])
    print(f"built both in {secs:.1f} s", flush=True)
    libs = {"full": mod.KERNEL.lib(), "generic": generic.lib()}
    for label, k in (("full", mod.KERNEL), ("generic", generic)):
        for fn, res in k.resources().items():
            print(f"[{label}] {fn}: {res}", flush=True)

    if args.kernel == "fwd":
        b, s, h, p, g, n, chunk = 1, 32768, 32, 64, 1, 128, 64
        x, dt, a, bm, cm, _ = cs.ssd_inputs(b, s, h, p, g, n, seed=1)
        passes_of, specialised = cs.SSD_PASSES, ("ssd_output_kernel",)

        def call():
            return tssd.ssd_scan(x, dt, a, bm, cm, chunk)

        def ratios(got, want):
            return {"y": ref.ssd_tolerance_ratio(got[0], want[0]),
                    "state": ref.ssd_tolerance_ratio(got[1], want[1], head_dim=1)}
        want = ref.ssd_chunked(x, dt, a, bm, cm, chunk)
    else:
        b, s, h, p, g, n, chunk = 1, 4096, 32, 64, 1, 128, 64
        ins = cs.ssd_inputs(b, s, h, p, g, n, seed=1)[:5]
        gen = torch.Generator(device="cuda").manual_seed(101)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dst = torch.randn((b, h, p, n), generator=gen, device="cuda")
        passes_of = cs.SSD_BWD_PASSES
        specialised = ("ssd_bwd_local_kernel", "ssd_bwd_chunk_kernel")

        def call():
            return tssdb.ssd_scan_bwd(*ins, chunk, dy, dst)

        ratios = ref.ssd_grad_ratios
        want = ref.ssd_chunked_bwd(*ins, chunk, dy, dst)

    def use(label):
        mod.KERNEL._lib = libs[label]
        if args.kernel == "fwd":
            tssd.plan.cache_clear()  # the plan sets each library's shared-memory limits

    for label in libs:
        use(label)
        r = ratios(call(), want)
        print(f"[{label}] tolerance ratios " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()),
              flush=True)
        if not max(r.values()) <= 1:
            raise AssertionError(f"{label} build disagrees with the plain version")
    del want
    torch.cuda.empty_cache()

    readings = {label: [] for label in libs}
    for rnd in range(args.rounds):
        for label in ("full", "generic", "generic", "full"):
            use(label)
            per = cs.device_ms_by_kernel(call, args.iters)
            tag = "<true>" if label == "full" else "<false>"
            passes = {k: sum(v for key, v in per.items() if k in key) for k in passes_of}
            ran = [key for key in per if any(k in key for k in specialised)]
            if len(ran) != len(specialised) or not all(tag in key for key in ran):
                raise AssertionError(f"{label}: specialised passes not the {tag} build: {ran}")
            total = sum(passes.values())
            readings[label].append({"total": total, **passes})
            print(f"round {rnd} {label:7s} {total:.4f} ms: "
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
    print(json.dumps({"kernel": args.kernel, "median_device_ms": med, "readings": readings}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
