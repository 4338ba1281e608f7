"""Kernel calibration: measure, fit, and write the artifacts (the twin of
``examples/calibrate_kernels.py``).

    PYTHONPATH=src python -m repro_torch.launch.calibrate --device cpu
    PYTHONPATH=src python -m repro_torch.launch.calibrate --full \
        --out build/CALIB_h100_timings.json --table build/CALIB_h100_table.json

Times the kernels (through ``kernels.ops``: on the card the CUDA kernels)
and the train and serve step phases, pairs every sample with the FLOPs
counted over the plain versions (``analysis.cost``), fits the
per-(kernel, shape-class) effective-MFU table against ``--gpu``, and writes
both artifacts: the raw timing record and the fitted ``CalibrationTable``,
in the JAX package's formats.  Without ``--full`` it times the catalog's
smoke shapes; with it, the full configurations' shape classes.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.analysis.calibrate import CalibrationTable
from repro_torch.launch.serve import resolve_device
from repro_torch.profiling.microbench import run_suite


def table_lines(table: CalibrationTable) -> list:
    """The fitted table as printed: one line per (key, shape class)."""
    lines = [f"== fitted effective throughput (target {table.target_gpu}) ==",
             f"  {'key':20s} {'class':16s} {'n':>2s} {'achieved FLOP/s':>15s} "
             f"{'eff MFU':>10s} {'eff HBM':>8s} {'rms':>6s}"]
    for e in table.entries:
        hbm = f"{e.eff_hbm:8.3f}" if e.eff_hbm is not None else "       -"
        lines.append(f"  {e.key:20s} {e.shape_class:16s} {e.n_samples:2d} "
                     f"{e.achieved_flops_per_s:15.4g} {e.eff_mfu:10.3g} "
                     f"{hbm} {e.rms_rel_err:6.3f}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="CALIB_timings.json", help="timing-artifact output path")
    ap.add_argument("--table", default="CALIB_table.json",
                    help="fitted CalibrationTable output path")
    ap.add_argument("--gpu", default="h100",
                    help="target GPU kind the effective MFUs are quoted against")
    ap.add_argument("--full", action="store_true",
                    help="full-config shape classes (the card); default uses the catalog "
                         "smoke shapes")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    art = run_suite(device=resolve_device(args.device), smoke=not args.full,
                    repeats=args.repeats, target_gpu=args.gpu,
                    progress=lambda s: print(f"  timing {s}", flush=True))
    for path in (args.out, args.table):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    art.save(args.out)
    n_ok = sum(r.valid for r in art.records)
    n_skip = sum(r.skipped for r in art.records)
    print(f"\n{len(art.records)} records ({n_ok} valid, {n_skip} skipped) -> {args.out}")
    for r in art.records:
        if r.skipped:
            print(f"  skipped {r.key}/{r.shape_class}: {r.skip_reason}")

    table = CalibrationTable.fit(art)
    table.save(args.table)
    print()
    print("\n".join(table_lines(table)))
    print(f"-> {args.table}")
    return table


if __name__ == "__main__":
    main()
