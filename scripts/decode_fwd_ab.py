#!/usr/bin/env python3
"""A/B on one card of the flash-decode forward against an earlier build of
its source, at the decode shapes of the models that run it.

    python3 scripts/decode_fwd_ab.py --old-source PATH
        [--set NAME:KEY=VALUE[,KEY=VALUE] ...] [--shapes TAG,TAG] [--rounds 3]
        [--iters 40]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  PATH is ``src/repro_torch/kernels/csrc/decode_attention.cu`` of an
earlier commit (for instance from ``git archive`` of it, unpacked under
``build/``), built beside the headers of its own ``csrc``; its C interface
is the one before the split came from the shape: ``repro_decode_num_splits(C)``
sizes its partials, which this script allocates for it, and
``repro_decode_attention_fwd`` / ``_stats`` take the current arguments.
Each ``--set`` builds the current source with its ``constexpr int KEY =
...;`` lines set to VALUE (a variant of the plan: ``STAGES``, ``NCW``,
``STAGE_BYTES``, ``SMS``), timed beside the current one as NAME.  Every
build is first held to the plain version (``ref.tolerance_ratio``, or
``ref.stats_tolerance_ratio`` for the stats variant) at each shape; then
each round runs old, new, the variants, SDPA, new, old, SDPA, each reading
torch.profiler's device time a call (both passes) over ``--iters`` calls.
SDPA (the yardstick, never on the port's path; for the stats variant it
gives the normalised output) is read the same way.  Prints one line a
reading, the medians beside the bound, a JSON line and the card's
``nvidia-smi`` name and power limit.
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
# (tag, B, C, H, KV, dh, valid slots (None: all), stats): bf16, the decode
# shapes of chip_smoke.py's kernel phases, the model-axis shares (8 ranks)
# and one rail shard of context-sharded llama3-8b (phase 28 (b)'s 32017
# valid slots of 32768, a prefix)
SHAPES = (("paligemma-3b", 8, 4096, 8, 1, 256, None, False),
          ("share-llama", 8, 4096, 4, 1, 128, None, False),
          ("llama3-8b", 8, 4096, 32, 8, 128, None, False),
          ("stats", 1, 4096, 32, 8, 128, None, True),
          ("stats-32k", 1, 32768, 32, 8, 128, 32017, True),
          ("seamless-m4t-medium", 8, 4096, 16, 16, 64, None, False),
          ("gemma-7b", 8, 4096, 16, 16, 256, None, False),
          ("share-paligemma", 8, 4096, 1, 1, 256, None, False))
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


def variant_text(text: str, sets: dict) -> str:
    """``text`` with each ``constexpr int KEY = ...;`` line set to VALUE."""
    for key, value in sets.items():
        pat = re.compile(rf"(constexpr int {key} = )[^;]+;")
        if len(pat.findall(text)) != 1:
            raise RuntimeError(f"expected one 'constexpr int {key} = ...;'")
        text = pat.sub(rf"\g<1>{value};", text)
    return text


def old_call(lib, q, kc, vc, valid, stats: bool):
    """The earlier kernel's call, its partials sized by its own split."""
    import torch
    from repro_torch.kernels.flash_attention import DTYPES
    b, _, h, dh = q.shape
    c, kvh = kc.shape[1], kc.shape[2]
    rep, dev, f32 = h // kvh, q.device, torch.float32
    nsplit = lib.repro_decode_num_splits(c)
    acc_p = torch.empty((b, kvh, nsplit, rep, dh), dtype=f32, device=dev)
    m_p, l_p = (torch.empty((b, kvh, nsplit, rep), dtype=f32, device=dev) for _ in range(2))
    mask = valid.view(torch.uint8)
    strides = (q.stride(0), q.stride(2), *kc.stride()[:3], *vc.stride()[:3], *mask.stride())
    head = (q.data_ptr(), kc.data_ptr(), vc.data_ptr(), mask.data_ptr())
    tail = (acc_p.data_ptr(), m_p.data_ptr(), l_p.data_ptr(), DTYPES[q.dtype], b, c, h, kvh, dh,
            *strides)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if stats:
        acc = torch.empty((b, kvh, rep, dh), dtype=f32, device=dev)
        m, l = (torch.empty((b, kvh, rep), dtype=f32, device=dev) for _ in range(2))
        err = lib.repro_decode_attention_stats(*head, acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                                               *tail, dh ** -0.5, dev.index or 0, stream)
        out = (acc, m, l)
    else:
        out = torch.empty_like(q)
        err = lib.repro_decode_attention_fwd(*head, out.data_ptr(), None, None, *tail,
                                             out.stride(0), out.stride(2), dh ** -0.5,
                                             dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"the earlier kernel's launch failed with cudaError_t {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", type=Path, required=True)
    ap.add_argument("--set", action="append", default=[], metavar="NAME:KEY=VALUE,...")
    ap.add_argument("--shapes", default=None, help="comma-separated tags (default: all)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("decode_fwd_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from _ab import build_of, card_line, read_rounds, with_lib
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as da

    sig = da.KERNEL.signatures
    old = build_of(args.old_source, "decode_attention_old", {
        "repro_decode_attention_fwd": sig["repro_decode_attention_fwd"],
        "repro_decode_attention_stats": sig["repro_decode_attention_stats"],
        "repro_decode_num_splits": [_I]})
    extras = {}
    for spec in args.set:
        name, sets = spec.split(":", 1)
        text = variant_text(da.KERNEL.source.read_text(),
                            dict(kv.split("=", 1) for kv in sets.split(",")))
        extras[name] = build_of(da.KERNEL.source, f"decode_attention_{name}", sig, text)
    secs = _build.build_all([da.KERNEL, old, *extras.values()])
    print(f"built in {secs:.1f} s", flush=True)
    for label, k in (("new", da.KERNEL), ("old", old), *extras.items()):
        for fn, res in k.resources().items():
            print(f"[{label}] {fn}: {res}", flush=True)

    wanted = set(args.shapes.split(",")) if args.shapes else None
    lib = da.KERNEL.lib()
    result = {}
    for tag, b, c, h, kv, dh, n_valid, stats in SHAPES:
        if wanted is not None and tag not in wanted:
            continue
        q, kc, vc, valid = cs.decode_inputs(b, c, h, kv, dh, torch.bfloat16, "all", seed=91)
        if n_valid is not None:
            valid = (torch.arange(c, device="cuda") < n_valid)[None, :].expand(b, c)
        new = ((lambda: da.decode_attention_stats(q, kc, vc, valid)) if stats
               else (lambda: da.decode_attention(q, kc, vc, valid)))
        calls = {"old": lambda: old_call(old.lib(), q, kc, vc, valid, stats), "new": new}
        calls.update({name: with_lib(da.KERNEL, x.lib(), new) for name, x in extras.items()})
        plans = {label: (x.lib().repro_decode_split(1, b, c, h, kv, dh),
                         x.lib().repro_decode_num_splits(1, b, c, h, kv, dh))
                 for label, x in (("new", da.KERNEL), *extras.items())}
        print(f"[{tag}] B={b} C={c} H={h} KV={kv} dh={dh}"
              f"{f' ({int(valid.sum())} valid slots)' if n_valid else ''}"
              f"{' stats' if stats else ''}: {lib.repro_decode_plan(1, h // kv, dh, 0)}-slot "
              f"tiles; (slots a split, splits) " + ", ".join(
                  f"{k} {v[0]} x {v[1]}" for k, v in plans.items()), flush=True)
        want = ref.decode_attention(q, kc, vc, valid, return_stats=stats)
        for label, call in calls.items():
            got = call()
            r = (ref.stats_tolerance_ratio(got, want, q.dtype) if stats
                 else ref.tolerance_ratio(got, want))
            print(f"[{tag}] {label} at {r:.3f} of the tolerance", flush=True)
            if not r <= 1:
                raise AssertionError(f"{tag}: the {label} kernel disagrees with the plain version")
        del want, got
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
        am = valid[:, None, None, :]
        calls["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                                               enable_gqa=True)
        readings, med = read_rounds(tag, calls, ["old", "new", *extras, "sdpa", "new", "old",
                                                 "sdpa"], args.rounds, args.iters,
                                    parts=lambda k: (re.findall(r"decode_\w+?kernel", k)
                                                     or [k[:24]])[0], width=10, digits=5)
        nv = int(valid.sum().item())
        nbytes = 2 * nv * kv * dh * 2 + b * c + (
            2 * b * h * dh + 4 * b * h * (dh + 2) if stats else 2 * (2 * b * h * dh))
        bnd = cs.bound(4 * nv * h * dh, nbytes)
        print(f"[{tag}] median device ms a call: old {med['old']:.5f}, new {med['new']:.5f} "
              f"(old / new {med['old'] / med['new']:.3f}), sdpa {med['sdpa']:.5f}"
              + "".join(f"; {n} {med[n]:.5f}" for n in extras)
              + f"; bound {bnd['bound_ms']:.5f} ms ({nbytes / 1e6:.1f} MB, {bnd['bound_by']}); "
              f"new at {100 * bnd['bound_ms'] / med['new']:.1f} % of the bound", flush=True)
        result[tag] = {"median_device_ms": med, "readings": readings, **bnd,
                       "plans": {k: list(v) for k, v in plans.items()}}
        del q, kc, vc, qt, kt, vt, valid, am
        torch.cuda.empty_cache()
    print(json.dumps(result))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
