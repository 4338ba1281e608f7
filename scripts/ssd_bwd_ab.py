#!/usr/bin/env python3
"""A/B on one card of the SSD chunk-scan backward against an earlier build of
its source, at the shapes of the models whose training runs it.

    python3 scripts/ssd_bwd_ab.py --old-source PATH [--extra NAME=PATH ...]
        [--shapes TAG,TAG] [--rounds 3] [--iters 20]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  PATH is ``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu`` of an
earlier commit (for instance from ``git archive`` of it, unpacked under
``build/``), built beside the headers of its own ``csrc``; its C interface
is the current one (``repro_ssd_scan_bwd``, which the wrapper calls, and
``repro_ssd_scan_bwd_workspace``; the current build's plan entry,
``repro_ssd_scan_bwd_plan``, is not asked of the others).  Each ``--extra`` builds another source
with that interface (a variant under study, beside the headers of its own
directory), timed beside the current one as NAME.  Inputs as
``chip_smoke.ssd_inputs`` makes them (x, B and C strided slices of one conv
output, as ``ssm_apply`` passes them) with random cotangents.  Every build is
first held to the plain version (``ref.ssd_grad_ratios`` <= 1 on every
gradient) at each shape but the rep-12 case, whose ratios are printed and
not held (its da sits at the f32 plain version's own rounding, and an
earlier build read 1.1 there: ROADMAP Queue 3, and
``scripts/ssd_bwd_da_check.py``); then each round runs old,
new, the variants, new, old, each reading torch.profiler's device time a
call, by pass under each build's own kernel names, over ``--iters`` calls.
Prints the current build's plan (segments and chunks a segment) at each
shape, one line a reading, the medians beside the bound, a JSON line and
the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]
# (tag, B, S, H, P, G, N, chunk, h_init): a mamba2-370m training step's
# layer, its model-axis share of 8 ranks, jamba-v0.1-52b's mixer, and the
# card test's rep-12 case (H=24 on G=2), whose da is not held here
SHAPES = (("mamba2-370m-train", 1, 4096, 32, 64, 1, 128, 64, False),
          ("mamba2-370m-share", 1, 4096, 4, 64, 1, 128, 64, False),
          ("jamba-v0.1-52b-mixer", 1, 4096, 128, 64, 1, 16, 64, True),
          ("rep12", 1, 2048, 24, 64, 2, 128, 64, False))
UNHELD = {"rep12"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", type=Path, required=True)
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--shapes", default=None, help="comma-separated tags (default: all)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from _ab import build_of, card_line, with_lib
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan_bwd as tssdb

    sig = {k: v for k, v in tssdb.KERNEL.signatures.items() if k != "repro_ssd_scan_bwd_plan"}
    old = build_of(args.old_source, "ssd_scan_bwd_old", sig)
    extras = {}
    for spec in args.extra:
        name, path = spec.split("=", 1)
        extras[name] = build_of(Path(path), f"ssd_scan_bwd_{name}", sig)
    secs = _build.build_all([tssdb.KERNEL, old, *extras.values()])
    print(f"built in {secs:.1f} s", flush=True)
    builds = {"new": tssdb.KERNEL, "old": old, **extras}
    for label, k in builds.items():
        for fn, res in k.resources().items():
            print(f"[{label}] {fn}: {res}", flush=True)

    def pass_of(key: str) -> str:
        m = re.search(r"ssd_bwd_[a-z]+_kernel", key)
        return m.group(0) if m else key[:24]

    wanted = set(args.shapes.split(",")) if args.shapes else None
    result = {}
    for tag, b, s, h, p, g, n, chunk, h_init in SHAPES:
        if wanted is not None and tag not in wanted:
            continue
        x, dt, a, bm, cm, h0 = cs.ssd_inputs(b, s, h, p, g, n, seed=1, h_init=h_init)
        gen = torch.Generator(device="cuda").manual_seed(101)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dst = torch.randn((b, h, p, n), generator=gen, device="cuda")

        def call():
            return tssdb.ssd_scan_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h0)

        calls = {label: (call if k is tssdb.KERNEL else with_lib(tssdb.KERNEL, k.lib(), call))
                 for label, k in builds.items()}
        pl = tssdb.plan(b, s, h, p, g, n, chunk)
        print(f"[{tag}] B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk}"
              f"{' h_init' if h_init else ''}; new plan: {pl.segments} segments of "
              f"{pl.chunks_per_segment} chunks", flush=True)
        want = ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h0)
        for label, fn in calls.items():
            r = ref.ssd_grad_ratios(fn(), want)
            print(f"[{tag}] {label}: " + ", ".join(f"{k} {v:.4f}" for k, v in r.items())
                  + " of the tolerance", flush=True)
            if not max(r.values()) <= 1 and tag not in UNHELD:
                raise AssertionError(f"{tag}: the {label} kernel disagrees with the plain version")
        del want
        torch.cuda.empty_cache()
        order = ["old", "new", *extras, "new", "old"]
        readings = {label: [] for label in order}
        for rnd in range(args.rounds):
            for label in order:
                per = cs.device_ms_by_kernel(calls[label], args.iters)
                passes = {}
                for key, v in per.items():
                    passes[pass_of(key)] = passes.get(pass_of(key), 0.0) + v
                total = sum(passes.values())
                readings[label].append({"total": total, **passes})
                print(f"[{tag}] round {rnd} {label:8s} {total:.4f} ms ("
                      + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()) + ")", flush=True)
        med = {label: {k: statistics.median(rd.get(k, 0.0) for rd in rs) for k in rs[0]}
               for label, rs in readings.items()}
        flops, nbytes = cs.ssd_bwd_bound(b, s, h, p, g, n, chunk, h_init)
        bnd = cs.bound(flops, nbytes, cs.PEAK_TF32_FLOPS)
        print(f"[{tag}] median device ms a call: old {med['old']['total']:.4f}, new "
              f"{med['new']['total']:.4f} (old / new "
              f"{med['old']['total'] / med['new']['total']:.3f})"
              + "".join(f"; {k} {med[k]['total']:.4f}" for k in extras)
              + "; by pass old " + ", ".join(f"{k} {v:.4f}" for k, v in med["old"].items()
                                             if k != "total")
              + "; new " + ", ".join(f"{k} {v:.4f}" for k, v in med["new"].items()
                                     if k != "total")
              + f"; bound {bnd['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB, {bnd['bound_by']}); "
              f"new at {100 * bnd['bound_ms'] / med['new']['total']:.1f} % of the bound; "
              f"{len(readings['new'])} readings each", flush=True)
        result[tag] = {"median_device_ms": med, "readings": readings, **bnd,
                       "plan": {"segments": pl.segments,
                                "chunks_per_segment": pl.chunks_per_segment},
                       "executed_gflop_new": cs.ssd_bwd_executed_flops(b, s, h, p, g, n, chunk)
                       / 1e9}
        del x, dt, a, bm, cm, h0, dy, dst
        torch.cuda.empty_cache()
    print(json.dumps(result))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
