#!/usr/bin/env python3
"""Where the SSD chunk-scan forward's time goes on one card: each phase of
``csrc/ssd_scan.cu``'s passes run twice, one build a phase.

    python3 scripts/ssd_fwd_phases.py [--rounds 3] [--iters 10]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  For each phase in ``PHASES`` (the tile builds; S4, the products of
y's inter-chunk term and C B^T; W; S6, the products of y's intra-chunk term
and the state update; y's store) the script builds the current source with
that phase wrapped in a loop of two, so that the extra device time of a call
is that phase's own.  Removing a phase instead would not measure it: nvcc
drops a `wgmma` whose result goes unused.  The doubled builds compute wrong
values and are timed only.  A phase is the text between the source's
``// phase: NAME`` and ``// end of phase: NAME`` comment lines; a phase
whose pair of markers is not found once makes the script stop with its
name.
Times are torch.profiler's device time a call, medians of ``--rounds``
readings over ``--iters`` calls, per pass, at mamba2-370m's prefill and
jamba-v0.1-52b's mixer.  Prints the ptxas registers and spills and the
SASS ``HGMMA`` and wait (``DEPBAR``) counts of each build, one line a
phase and shape, and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]
# the phases marked in csrc/ssd_scan.cu
PHASES = ("build", "S4", "W", "S6", "ystore")
SHAPES = (("mamba2-370m-prefill", 1, 32768, 32, 64, 1, 128, 64),
          ("jamba-v0.1-52b-mixer", 1, 4096, 128, 64, 1, 16, 64))


def doubled(src: str) -> dict:
    """{phase: the source with that phase run twice}."""
    out = {}
    for name in PHASES:
        first, after = f"// phase: {name}\n", f"// end of phase: {name}\n"
        if src.count(first) != 1 or src.count(after) != 1:
            raise RuntimeError(f"phase {name}: its markers are not found once in the source")
        i, j = src.index(first), src.index(after)
        out[name] = src[:i] + "for (int dup_ = 0; dup_ < 2; ++dup_) {\n" + src[i:j] + "}\n" + src[j:]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_fwd_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from _ab import build_of, card_line
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as tssd
    from ssd_fwd_ab import call_with

    kernels = {k: build_of(tssd.KERNEL.source, f"ssd_twice_{k}", tssd.KERNEL.signatures, v)
               for k, v in doubled(tssd.KERNEL.source.read_text()).items()}
    print(f"built in {_build.build_all([tssd.KERNEL, *kernels.values()]):.1f} s", flush=True)
    for name, k in [("once", tssd.KERNEL), *kernels.items()]:
        res, sass = k.resources(), cs.sass_counts(k, ("HGMMA", "DEPBAR"))
        for fn, c in sass.items():
            if "kernelILi128" in fn:
                print(f"[{name}] {fn[-60:]}: {res[fn]['registers']} registers, "
                      f"{res[fn]['spill_stores']} B spilled, {c}", flush=True)
    for tag, b, s, h, p, g, n, chunk in SHAPES:
        x, dt, a, bm, cm, _ = cs.ssd_inputs(b, s, h, p, g, n, seed=1)
        calls = {"once": lambda: tssd.ssd_scan(x, dt, a, bm, cm, chunk)}
        for k, kern in kernels.items():
            calls[k] = (lambda lib: lambda: call_with(lib, x, dt, a, bm, cm, chunk))(kern.lib())
        res = {k: [] for k in calls}
        for _ in range(args.rounds):
            for k, f in calls.items():
                res[k].append(cs.device_ms_by_kernel(f, args.iters))
        base = None
        for k, rs in res.items():
            med = {part: statistics.median(sum(v for key, v in r.items() if part in key)
                                           for r in rs) for part in ("output", "state", "")}
            base = base or med
            print(f"[{tag}] {k:7s} a call {med['']:.4f} ms: output pass {med['output']:.4f} "
                  f"(+{med['output'] - base['output']:.4f}), state pass {med['state']:.4f} "
                  f"(+{med['state'] - base['state']:.4f})", flush=True)
        del x, dt, a, bm, cm
        torch.cuda.empty_cache()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
