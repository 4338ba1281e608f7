#!/usr/bin/env python3
"""A/B on one card of the SSD chunk-scan forward against an earlier build of
its source, at the shapes of the models that run it.

    python3 scripts/ssd_fwd_ab.py --old-source PATH
        [--set NAME:KEY=VALUE[,KEY=VALUE] ...] [--extra NAME=PATH ...]
        [--shapes TAG,TAG] [--rounds 3] [--iters 20]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  PATH is ``src/repro_torch/kernels/csrc/ssd_scan.cu`` of an earlier
commit (for instance from ``git archive`` of it, unpacked under ``build/``),
built beside the headers of its own ``csrc``; its C interface is the
current one (``repro_ssd_scan_plan`` sizes its scratch, which this script
allocates for it).  Each ``--set`` builds the current source with its
``constexpr int KEY = ...;`` lines set to VALUE (a variant of the plan, for
instance ``HEADS=1``: one head a block), timed beside the current one as
NAME; each ``--extra`` builds another source with the current C interface
(beside the headers of its own directory) as NAME.  Inputs as
``chip_smoke.ssd_inputs`` makes them: x, B and C strided slices of one conv
output, as ``ssm_apply`` passes them.  Every build is
first held to the plain version (``ref.ssd_tolerance_ratio`` <= 1 on y and
the final state) at each shape; then each round runs old, new, the
variants, new, old, each reading torch.profiler's device time a call, by
pass, over ``--iters`` calls.  Prints one line a reading, the medians beside
the bound, a JSON line and the card's ``nvidia-smi`` name and power limit.
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
# (tag, B, S, H, P, G, N, chunk): the prefill of chip_smoke.py's main shape,
# a training step's forward, jamba's mixer, a model-axis share of 8 ranks
SHAPES = (("mamba2-370m-prefill", 1, 32768, 32, 64, 1, 128, 64),
          ("mamba2-370m-train", 1, 4096, 32, 64, 1, 128, 64),
          ("jamba-v0.1-52b-mixer", 1, 4096, 128, 64, 1, 16, 64),
          ("mamba2-370m-share", 1, 4096, 4, 64, 1, 128, 64))


def variant_text(text: str, sets: dict) -> str:
    """``text`` with each ``constexpr int KEY = ...;`` line set to VALUE."""
    for key, value in sets.items():
        pat = re.compile(rf"(constexpr int {key} = )[^;]+;")
        if len(pat.findall(text)) != 1:
            raise RuntimeError(f"expected one 'constexpr int {key} = ...;'")
        text = pat.sub(rf"\g<1>{value};", text)
    return text


def call_with(lib, x, dt, a, bm, cm, chunk):
    """``ssd_scan``'s call through another build's library, planned and given
    scratch by that library."""
    import ctypes

    import torch
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    dev = x.device.index or 0
    nseg, cps, ws_n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int64()
    err = lib.repro_ssd_scan_plan(b, s, h, p, g, n, chunk, dev, ctypes.byref(nseg),
                                  ctypes.byref(cps), ctypes.byref(ws_n))
    if err != 0:
        raise RuntimeError(f"plan failed with cudaError_t {err}")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    st = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    ws = torch.empty((ws_n.value,), dtype=torch.float32, device=x.device)
    err = lib.repro_ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(), None,
        y.data_ptr(), st.data_ptr(), ws.data_ptr(), ws_n.value, b, s, h, p, g, n, chunk,
        nseg.value, cps.value, *x.stride()[:3], *dt.stride(), *bm.stride()[:3],
        *cm.stride()[:3], *y.stride()[:3], 0, 0, 0, *st.stride()[:3], dev,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError_t {err}")
    return y, st


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", type=Path, required=True)
    ap.add_argument("--set", action="append", default=[], metavar="NAME:KEY=VALUE,...")
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--shapes", default=None, help="comma-separated tags (default: all)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_fwd_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from _ab import build_of, card_line
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as tssd

    sig = tssd.KERNEL.signatures
    old = build_of(args.old_source, "ssd_scan_old", sig)
    extras = {}
    for spec in args.set:
        name, sets = spec.split(":", 1)
        text = variant_text(tssd.KERNEL.source.read_text(),
                            dict(kv.split("=", 1) for kv in sets.split(",")))
        extras[name] = build_of(tssd.KERNEL.source, f"ssd_scan_{name}", sig, text)
    for spec in args.extra:
        name, path = spec.split("=", 1)
        extras[name] = build_of(Path(path), f"ssd_scan_{name}", sig)
    secs = _build.build_all([tssd.KERNEL, old, *extras.values()])
    print(f"built in {secs:.1f} s", flush=True)
    for label, k in (("new", tssd.KERNEL), ("old", old), *extras.items()):
        for fn, res in k.resources().items():
            print(f"[{label}] {fn}: {res}", flush=True)

    def pass_of(key: str) -> str:
        return (re.findall(r"ssd_\w+?_kernel", key) or [key[:24]])[0]

    wanted = set(args.shapes.split(",")) if args.shapes else None
    result = {}
    for tag, b, s, h, p, g, n, chunk in SHAPES:
        if wanted is not None and tag not in wanted:
            continue
        x, dt, a, bm, cm, _ = cs.ssd_inputs(b, s, h, p, g, n, seed=1)
        calls = {"old": lambda: call_with(old.lib(), x, dt, a, bm, cm, chunk),
                 "new": lambda: tssd.ssd_scan(x, dt, a, bm, cm, chunk)}
        for name, k in extras.items():
            calls[name] = (lambda lib: lambda: call_with(lib, x, dt, a, bm, cm, chunk))(k.lib())
        print(f"[{tag}] B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk}: new plan "
              f"{tssd.plan(b, s, h, p, g, n, chunk)}", flush=True)
        y_w, st_w = ref.ssd_chunked(x, dt, a, bm, cm, chunk)
        for label, call in calls.items():
            y, st = call()
            r = max(ref.ssd_tolerance_ratio(y, y_w), ref.ssd_tolerance_ratio(st, st_w, 1))
            print(f"[{tag}] {label} at {r:.4f} of the tolerance", flush=True)
            if not r <= 1:
                raise AssertionError(f"{tag}: the {label} kernel disagrees with the plain version")
        del y_w, st_w, y, st
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
        flops, nbytes = cs.ssd_fwd_bound(b, s, h, p, g, n, chunk)
        bnd = cs.bound(flops, nbytes, cs.PEAK_TF32_FLOPS)
        print(f"[{tag}] median device ms a call: old {med['old']['total']:.4f}, new "
              f"{med['new']['total']:.4f} (old / new "
              f"{med['old']['total'] / med['new']['total']:.3f})"
              + "".join(f"; {k} {med[k]['total']:.4f}" for k in extras)
              + f"; bound {bnd['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB, {bnd['bound_by']}); "
              f"new at {100 * bnd['bound_ms'] / med['new']['total']:.1f} % of the bound; "
              f"{len(readings['new'])} readings each", flush=True)
        result[tag] = {"median_device_ms": med, "readings": readings, **bnd,
                       "executed_gflop_new": cs.ssd_executed_flops(b, s, h, p, g, n, chunk) / 1e9}
        del x, dt, a, bm, cm
        torch.cuda.empty_cache()
    print(json.dumps(result))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
