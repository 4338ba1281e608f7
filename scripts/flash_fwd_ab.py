#!/usr/bin/env python3
"""A/B on one card of the flash-attention forward against an earlier build of
its source, at the prefill and training shapes of the models that run it.

    python3 scripts/flash_fwd_ab.py --old-source PATH [--extra NAME=PATH ...]
        [--shapes TAG,TAG] [--rounds 3] [--iters 10]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  PATH is ``src/repro_torch/kernels/csrc/flash_attention.cu`` of an
earlier commit (for instance from ``git archive`` of it, unpacked under
``build/``), built with the headers beside it in its own ``csrc``: the C
entry point ``repro_flash_attention_fwd`` keeps its arguments, so the
current wrapper launches either build.  Each ``--extra`` is another source
with the current interface (a variant under study, headers beside it too),
timed beside the current one as NAME.  Every build is first held to the
plain version ``ref.mha`` by ``ref.tolerance_ratio`` <= 1 at each shape
(and its lse to ``ref.mha_fwd_lse``'s where the shape asks for it); then
each round runs old, new, the extras, new, old, each reading torch.profiler's
device time a call over ``--iters`` calls.  SDPA (the yardstick, never on
the port's path) is read the same way, twice a round.  Prints one line a
reading, the medians beside the bound, a JSON line and the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# (tag, B, S, H, KV, dh, lse): causal, bf16.  The prefill shapes of
# chip_smoke.py's kernel phases, danube's training forward (which keeps the
# rows' lse) and the local shapes of its model-axis shares (8 ranks).
SHAPES = (("llama3-8b", 1, 4096, 32, 8, 128, False),
          ("gemma-7b", 1, 4096, 16, 16, 256, False),
          ("paligemma-3b", 1, 4096, 8, 1, 256, False),
          ("seamless-m4t-medium", 1, 4096, 16, 16, 64, False),
          ("h2o-danube-3-4b-train", 1, 4096, 32, 8, 120, True),
          ("share-danube", 1, 4096, 4, 1, 120, False),
          ("share-granite", 2, 4096, 2, 1, 64, False),
          ("share-paligemma", 1, 4096, 1, 1, 256, False))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", type=Path, required=True)
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--shapes", default=None, help="comma-separated tags (default: all)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_fwd_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from _ab import build_of, card_line, read_rounds, with_lib
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    fwd = "repro_flash_attention_fwd"
    old = build_of(args.old_source, "flash_attention_old", {fwd: fa.KERNEL.signatures[fwd]})
    extras = {}
    for spec in args.extra:
        name, path = spec.split("=", 1)
        extras[name] = build_of(Path(path), f"flash_attention_{name}", fa.KERNEL.signatures)
    secs = _build.build_all([fa.KERNEL, old, *extras.values()])
    print(f"built in {secs:.1f} s", flush=True)
    for label, k in (("new", fa.KERNEL), ("old", old), *extras.items()):
        for fn, res in k.resources().items():
            if "simt" not in fn:
                print(f"[{label}] {fn}: {res}", flush=True)

    wanted = set(args.shapes.split(",")) if args.shapes else None
    result = {}
    for tag, b, s, h, kv, dh, lse in SHAPES:
        if wanted is not None and tag not in wanted:
            continue
        q, k, v = cs.flash_case(b, s, h, kv, dh, torch.bfloat16, seed=81)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        new = lambda: fa.flash_attention(q, k, v, causal=True, return_lse=lse)  # noqa: E731
        calls = {"old": with_lib(fa.KERNEL, old.lib(), new), "new": new}
        calls.update({name: with_lib(fa.KERNEL, x.lib(), new) for name, x in extras.items()})
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                      enable_gqa=True)
        print(f"[{tag}] B={b} S={s} H={h} KV={kv} dh={dh}{' with lse' if lse else ''}: "
              f"{cs.flash_q_tile(dh, b, s, h)}-row blocks, {cs.flash_tile(dh)}-key tiles",
              flush=True)
        o_w, lse_w = ref.mha_fwd_lse(q, k, v, causal=True)
        for label, call in calls.items():
            got = call()
            o, l_ = got if lse else (got, None)
            r = ref.tolerance_ratio(o, o_w)
            rl = ref.lse_tolerance_ratio(l_, lse_w) if lse else 0.0
            print(f"[{tag}] {label} o at {r:.3f} of the tolerance"
                  + (f", lse at {rl:.4f}" if lse else ""), flush=True)
            if not (r <= 1 and rl <= 1):
                raise AssertionError(f"{tag}: the {label} kernel disagrees with the plain version")
        del o_w, lse_w, got, o, l_
        torch.cuda.empty_cache()
        calls["sdpa"] = sdpa
        readings, med = read_rounds(tag, calls, ["old", "new", *extras, "sdpa", "new", "old",
                                                 "sdpa"], args.rounds, args.iters)
        pairs = b * h * s * (s + 1) // 2
        flops = 4 * pairs * dh
        nbytes = 2 * (2 * b * s * h * dh + 2 * b * s * kv * dh) + (4 * b * h * s if lse else 0)
        bnd = cs.bound(flops, nbytes)
        executed = cs.flash_executed_flops(b, s, h, dh)
        print(f"[{tag}] median device ms a call: old {med['old']:.4f}, new {med['new']:.4f} "
              f"(old / new {med['old'] / med['new']:.3f}), sdpa {med['sdpa']:.4f}"
              + "".join(f"; {n} {med[n]:.4f}" for n in extras)
              + f"; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); new at "
              f"{flops / med['new'] / 1e9:.0f} TFLOP/s needed, "
              f"{executed / med['new'] / 1e9:.0f} TFLOP/s executed (derived: "
              f"{executed / 1e9:.1f} GFLOP)", flush=True)
        result[tag] = {"median_device_ms": med, "readings": readings, **bnd,
                       "needed_gflop": flops / 1e9, "executed_gflop": executed / 1e9}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    print(json.dumps(result))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
