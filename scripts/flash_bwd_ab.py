#!/usr/bin/env python3
"""A/B on one card of the flash-attention backward against an earlier build of
its source, at the training shapes of the models whose backward it runs.

    python3 scripts/flash_bwd_ab.py --old-source PATH [--extra NAME=PATH ...]
        [--shapes TAG,TAG] [--rounds 3] [--iters 10]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  PATH is ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` of an
earlier commit (for instance from ``git archive`` of it, unpacked under
``build/``, beside the headers of its own ``csrc``) whose C interface is the
mma.sync kernel's: (q, k, v, o, do, lse, delta, dq, dk, dv, dtype, B, Sq,
Sk, H, KV, dh, strides, scale, causal, window, q_offset, device, stream),
its ``delta`` scratch [B, H, Sq] f32.  Each
``--extra`` is another build of a source with the current interface (a
variant under study, headers beside it too), timed beside the current one
as NAME.  Every build is first held to the plain version ``ref.mha_bwd`` by ``ref.grad_tolerance_ratio`` <= 1 at
each shape, the forward's o and lse from the flash kernel; then each round
runs old, new, the extras, new, old, each reading torch.profiler's device
time a call over ``--iters`` calls, with each kernel's share.  Prints one
line a reading, the medians, a JSON line and the card's ``nvidia-smi`` name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# (tag, B, S, H, KV, dh): the causal training shapes of the models whose
# attention backward is this kernel (chip_smoke.py's training phases)
SHAPES = (("paligemma-3b", 1, 4096, 8, 1, 256), ("gemma-7b", 1, 4096, 16, 16, 256),
          ("h2o-danube-3-4b", 1, 4096, 32, 8, 120), ("seamless-m4t-medium", 2, 4096, 16, 16, 64),
          ("h2o-danube-3-4b-pipeline", 1, 2048, 32, 8, 120))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def old_call(lib, q, k, v, o, lse, do):
    """The earlier kernel's gradients, its outputs allocated as its wrapper did."""
    import torch
    from repro_torch.kernels.flash_attention import DTYPES
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, sk, kvh, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, do, dk, dv, dq, o)
                                       for s in t.stride()[:3]))
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype],
        b, sq, sk, h, kvh, dh, ctypes.cast(strides, ctypes.c_void_p), dh ** -0.5, 1, 0, 0,
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the earlier kernel's launch failed with cudaError_t {err}")
    return dq, dk, dv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", type=Path, required=True)
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--shapes", default=None, help="comma-separated tags (default: all)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from _ab import build_of, card_line, read_rounds, with_lib
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    old = build_of(args.old_source, "flash_attention_bwd_old", {
        "repro_flash_attention_bwd": [_P] * 10 + [_I] * 7 + [_P, _F, _I, _I, _I, _I, _P]})
    extras = {}
    for spec in args.extra:
        name, path = spec.split("=", 1)
        extras[name] = build_of(Path(path), f"flash_attention_bwd_{name}", {
            fn: fab.KERNEL.signatures[fn] for fn in ("repro_flash_attention_bwd",
                                                      "repro_flash_attention_bwd_head_parts")})
    secs = _build.build_all([fa.KERNEL, fab.KERNEL, old, *extras.values()])
    print(f"built in {secs:.1f} s", flush=True)
    for label, k in (("new", fab.KERNEL), ("old", old), *extras.items()):
        for fn, res in k.resources().items():
            if "dkdv" in fn or "dq_kernel" in fn or "head_sum" in fn:
                print(f"[{label}] {fn}: {res}", flush=True)
    new_lib = fab.KERNEL.lib()

    wanted = set(args.shapes.split(",")) if args.shapes else None
    bf16 = torch.bfloat16
    result = {}
    for tag, b, s, h, kv, dh in SHAPES:
        if wanted is not None and tag not in wanted:
            continue
        q, k, v = cs.flash_case(b, s, h, kv, dh, bf16, seed=71)
        do = cs.flash_case(b, s, h, kv, dh, bf16, seed=171)[0]
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        new = lambda: fab.flash_attention_bwd(q, k, v, o, lse, do)  # noqa: E731
        calls = {"old": lambda: old_call(old.lib(), q, k, v, o, lse, do), "new": new}
        calls.update({name: with_lib(fab.KERNEL, x.lib(), new) for name, x in extras.items()})
        print(f"[{tag}] B={b} S={s} H={h} KV={kv} dh={dh}: head parts "
              f"{new_lib.repro_flash_attention_bwd_head_parts(b, s, kv, h // kv)}", flush=True)
        want = ref.mha_bwd(q, k, v, o, lse, do)
        for label, call in calls.items():
            r = [ref.grad_tolerance_ratio(g, w) for g, w in zip(call(), want)]
            print(f"[{tag}] {label} dq, dk, dv at {r[0]:.3f}, {r[1]:.3f}, {r[2]:.3f} of the "
                  f"tolerance", flush=True)
            if not max(r) <= 1:
                raise AssertionError(f"{tag}: the {label} kernel disagrees with the plain version")
        del want
        torch.cuda.empty_cache()
        readings, med = read_rounds(
            tag, calls, ["old", "new", *extras, "new", "old"], args.rounds, args.iters,
            parts=lambda k_: (re.findall(r"(?:delta|dkdv|dq|head_sum)_kernel", k_)
                              or [k_[:24]])[0])
        print(f"[{tag}] median device ms a call: old {med['old']:.4f}, new {med['new']:.4f} "
              f"(old / new {med['old'] / med['new']:.3f})"
              + "".join(f"; {n} {med[n]:.4f}" for n in extras), flush=True)
        result[tag] = {"median_device_ms": med, "readings": readings}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(json.dumps(result))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
