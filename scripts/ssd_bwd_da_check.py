#!/usr/bin/env python3
"""The SSD backward's da against an f64 reference, beside the f32 plain
version's, at the card tests' backward cases.

    python3 scripts/ssd_bwd_da_check.py [--old-source PATH] [--extra NAME=PATH ...]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  da_h sums dt d(dA) over every position of head h, and
``ref.ssd_grad_tolerance_ratio`` holds it to 1e-5 + 1e-4 |da_h|; where the
terms (tens to hundreds) cancel to ~0.1, that bound is at the rounding of
an f32 sum.  This script holds the kernel's da, the da of an earlier build
of its source (``--old-source``, beside the headers of its own directory)
and of other builds with the current C interface (``--extra``), and the
plain f32 version's (``ref.ssd_chunked_bwd``) each to an f64 reference: the
gradient, by autograd in f64, of the scan taken position by position (h_t =
e^{dt_t a} h_{t-1} + dt_t x_t (x) B_t, y_t = h_t C_t), an implementation
independent of the chunked one.  Inputs as
``tests/test_torch_kernels_cuda.py``'s backward test makes them (seed 7).
Prints, per case, each build's ratios against the plain version and each
da's per-head ratio against the f64 reference, then the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]
# (B, S, H, P, G, N, chunk): the backward cases of rep 12 (the one that read
# da 1.0997 against the plain version on an H100), its shorter twin and
# mamba2-370m's training layer
CASES = ((1, 2048, 24, 64, 2, 128, 64), (1, 1024, 24, 64, 2, 128, 64),
         (1, 4096, 32, 64, 1, 128, 64))


def scan64(x, dt, a, bm, cm):
    """(y, final state) of the SSD scan position by position, in f64."""
    import torch
    b, s, h, p = x.shape
    rep = h // bm.shape[2]
    bh, ch = bm.repeat_interleave(rep, 2), cm.repeat_interleave(rep, 2)
    st = x.new_zeros((b, h, p, bm.shape[3]))
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)[..., None, None]
        st = decay * st + (dt[:, t, :, None] * x[:, t])[..., None] * bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", st, ch[:, t]))
    return torch.stack(ys, 1), st


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", type=Path, default=None)
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=PATH")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_da_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from _ab import build_of, card_line, with_lib
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan_bwd as tssdb

    # the current build's plan entry is not asked of the others
    sig = {k: v for k, v in tssdb.KERNEL.signatures.items() if k != "repro_ssd_scan_bwd_plan"}
    builds = {"new": tssdb.KERNEL}
    if args.old_source is not None:
        builds["old"] = build_of(args.old_source, "ssd_scan_bwd_old", sig)
    for spec in args.extra:
        name, path = spec.split("=", 1)
        builds[name] = build_of(Path(path), f"ssd_scan_bwd_{name}", sig)
    _build.build_all(list(builds.values()))
    for b, s, h, p, g, n, chunk in CASES:
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, h), generator=gen, device="cuda") - 3)
        a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
        bm = torch.randn((b, s, g, n), generator=gen, device="cuda")
        cm = torch.randn((b, s, g, n), generator=gen, device="cuda")
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dst = torch.randn((b, h, p, n), generator=gen, device="cuda")

        def call():
            return tssdb.ssd_scan_bwd(x, dt, a, bm, cm, chunk, dy, dst)

        got = {label: (call if k is tssdb.KERNEL else with_lib(tssdb.KERNEL, k.lib(), call))()
               for label, k in builds.items()}
        plain = ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dst)
        with torch.enable_grad():
            ins = [t.double().requires_grad_() for t in (x, dt, a, bm, cm)]
            truth = torch.autograd.grad(scan64(*ins), ins, (dy.double(), dst.double()))[2]
        print(f"[B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk}] da (f64): "
              + ", ".join(f"{v:.4g}" for v in truth.tolist()), flush=True)
        for label, gr in got.items():
            r = ref.ssd_grad_ratios(gr, plain)
            print(f"  {label} against the plain version: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in r.items()), flush=True)
        allowed = ref.SSD_GRAD_ATOL + ref.SSD_GRAD_RTOL * truth.abs()
        for label, da in [*((k, v[2]) for k, v in got.items()), ("plain f32", plain[2])]:
            r = ((da.double() - truth).abs() / allowed).tolist()
            worst = max(range(h), key=lambda i: r[i])
            print(f"  da of {label} against f64: worst {r[worst]:.4f} at head {worst}; "
                  "per head " + ", ".join(f"{v:.2f}" for v in r), flush=True)
        del got, plain, truth, ins
        torch.cuda.empty_cache()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
