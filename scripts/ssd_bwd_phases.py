#!/usr/bin/env python3
"""Where the SSD chunk-scan backward's time goes on one card: each marked
phase of ``csrc/ssd_scan_bwd.cu`` run twice, one build a phase.

    python3 scripts/ssd_bwd_phases.py [--phases A,B] [--remove A,B]
        [--shapes TAG,TAG] [--rounds 3] [--iters 10]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  For each phase in ``PHASES`` (pass 1's walk: the table of the
chunks' row scales, the carry's store, the transposed operand's build, the
local product, the carry update, the C B^T share; pass 3's correction of S
and G with the (eout B) build, and the correction's FMAs alone) the script
builds the current source with that phase wrapped in a loop of two, so
that the extra device time of its pass is that phase's own.  Removing a
phase instead would not measure it: nvcc drops a `wgmma` whose result goes
unused.  The doubled builds compute wrong values and are timed only.
``--remove`` also builds the source with each named phase taken out (only
for a phase whose removal leaves every product used and every load
waited, such as the walk's store and the correction's FMAs), which says
what the rest costs without it.  A phase is the text between the source's
``// phase: NAME`` and ``// end of phase: NAME`` comment lines; a phase
whose pair of markers is not found once makes the script stop with its
name.  Times are torch.profiler's device time a call by pass, medians of
``--rounds`` readings over ``--iters`` calls, the unmodified build read in
the same rounds, at the shapes of ``scripts/ssd_bwd_ab.py``.  Prints each
build's ptxas registers and spills, one line a phase and shape, and the
card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]
# the phases marked in csrc/ssd_scan_bwd.cu, with the pass that holds each
PHASES = {"walk scan": "walk", "walk store": "walk", "walk build": "walk",
          "walk local": "walk", "walk carry": "walk", "walk cb": "walk", "correct": "chunk",
          "seg fix": "chunk"}


def doubled(src: str, names, remove=False) -> dict:
    """{phase: the source with that phase run twice, or taken out}."""
    out = {}
    for name in names:
        first, after = f"// phase: {name}\n", f"// end of phase: {name}\n"
        if src.count(first) != 1 or src.count(after) != 1:
            raise RuntimeError(f"phase {name}: its markers are not found once in the source")
        i, j = src.index(first), src.index(after)
        body = "" if remove else "for (int dup_ = 0; dup_ < 2; ++dup_) {\n" + src[i:j] + "}\n"
        out[name] = src[:i] + body + src[j:]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None, help="comma-separated (default: all)")
    ap.add_argument("--remove", default="", help="comma-separated phases to time taken out")
    ap.add_argument("--shapes", default=None, help="comma-separated tags (default: all)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from _ab import build_of, card_line, with_lib
    from ssd_bwd_ab import SHAPES
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan_bwd as tssdb

    names = args.phases.split(",") if args.phases else list(PHASES)
    src = tssdb.KERNEL.source
    sig = {k: v for k, v in tssdb.KERNEL.signatures.items() if k != "repro_ssd_scan_bwd_plan"}
    texts = doubled(src.read_text(), names)
    removed = [r for r in args.remove.split(",") if r]
    texts.update({"without " + name: text
                  for name, text in doubled(src.read_text(), removed, remove=True).items()})
    builds = {name: build_of(src, "ssd_scan_bwd_dup_" + re.sub(r"\W", "_", name), sig, text=text)
              for name, text in texts.items()}
    secs = _build.build_all([tssdb.KERNEL, *builds.values()])
    print(f"built in {secs:.1f} s", flush=True)
    for label, k in [("base", tssdb.KERNEL), *builds.items()]:
        for fn, res in k.resources().items():
            m = re.search(r"ssd_bwd_[a-z]+_kernel(ILi\d)?", fn)
            print(f"[{label}] {m.group(0) if m else fn[:40]}: {res}", flush=True)

    def by_pass(per: dict) -> dict:
        out = {}
        for key, v in per.items():
            m = re.search(r"ssd_bwd_([a-z]+)_kernel", key)
            name = m.group(1) if m else key[:24]
            out[name] = out.get(name, 0.0) + v
        return out

    wanted = set(args.shapes.split(",")) if args.shapes else None
    for tag, b, s, h, p, g, n, chunk, h_init in SHAPES:
        if wanted is not None and tag not in wanted:
            continue
        x, dt, a, bm, cm, h0 = cs.ssd_inputs(b, s, h, p, g, n, seed=1, h_init=h_init)
        gen = torch.Generator(device="cuda").manual_seed(101)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dst = torch.randn((b, h, p, n), generator=gen, device="cuda")

        def call():
            return tssdb.ssd_scan_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h0)

        calls = {"base": call, **{name: with_lib(tssdb.KERNEL, k.lib(), call)
                                  for name, k in builds.items()}}
        readings = {label: [] for label in calls}
        for _ in range(args.rounds):
            for label, fn in calls.items():
                readings[label].append(by_pass(cs.device_ms_by_kernel(fn, args.iters)))
        med = {label: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
               for label, rs in readings.items()}
        pl = tssdb.plan(b, s, h, p, g, n, chunk)
        print(f"[{tag}] plan {pl.segments} segments of {pl.chunks_per_segment} chunks; base "
              + ", ".join(f"{k} {v:.4f}" for k, v in med["base"].items()) + " ms", flush=True)
        for name in builds:
            gone = name.startswith("without ")
            ps = PHASES[name[len("without "):] if gone else name]
            print(f"[{tag}] {name}: {ps} pass {med[name][ps]:.4f} ms "
                  f"{'' if gone else 'doubled '}against {med['base'][ps]:.4f}: the phase "
                  f"{(-1 if gone else 1) * (med[name][ps] - med['base'][ps]):.4f} ms", flush=True)
        del x, dt, a, bm, cm, h0, dy, dst
        torch.cuda.empty_cache()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
