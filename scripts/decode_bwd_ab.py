#!/usr/bin/env python3
"""A/B on one card of the decode backward kernel against an earlier build of
its source, at llama3-8b's and paligemma-3b's decode shapes.

    python3 scripts/decode_bwd_ab.py --old-source PATH [--target-blocks N] [--rounds 3]
        [--iters 40]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  PATH is ``src/repro_torch/kernels/csrc/decode_attention_bwd.cu`` of
an earlier commit (for instance from ``git archive`` of it, unpacked under
``build/``) whose C interface is the three-pass kernel's: it computes the
softmax statistics itself, from (q, k, v, valid, do, dq, dk, dv, m_p, l_p,
t_p, dq_p, dtype, B, C, H, KV, dh, strides, scale, device, stream), its
scratch sized by ``repro_decode_bwd_num_splits(C)``.  The current kernel
takes the forward's residuals, made once a shape by the forward kernel's
residual mode and not timed with it.  The earlier source is built beside
the headers of its own ``csrc``.  With ``--target-blocks N`` the current
source is built a second time with its split rule aiming at N blocks in
place of TARGET_BLOCKS (132, one an SM; 264, two an SM, takes paligemma-3b's
decode to 64-slot splits where 132 gives it 128), and that build ("target")
is timed beside the current one.  Each round runs old, new, [target,
target,] new, old, and the forward kernel without and with its residuals
(plain, residuals, residuals, plain); each reading is torch.profiler's
device time a call over ``--iters`` calls (each kernel's share beside it).
Both backwards are held to the plain version's autograd by
``ref.grad_tolerance_ratio`` <= 1 first.  Prints one line a reading, the
medians, a JSON line and the card's ``nvidia-smi`` name and power limit.
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
# (tag, B, C, H, KV, dh): llama3-8b's decode and paligemma-3b's, a full cache
SHAPES = (("llama3-8b", 8, 4096, 32, 8, 128), ("paligemma-3b", 8, 4096, 8, 1, 256))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def target_text(kernel, blocks: int) -> str:
    """``kernel``'s source with its split rule aiming at ``blocks``."""
    line = "constexpr int TARGET_BLOCKS = "
    text = kernel.source.read_text()
    if text.count(line) != 1:
        raise RuntimeError(f"{kernel.source}: expected one '{line}'")
    head, tail = text.split(line)
    return head + line + f"{blocks};" + tail.split(";", 1)[1]


def old_call(lib, q, kc, vc, valid, do):
    """The earlier kernel's gradients, its scratch allocated as its wrapper did."""
    import torch
    from repro_torch.kernels.flash_attention import DTYPES
    b, _, h, dh = q.shape
    c, kvh = kc.shape[1], kc.shape[2]
    rep, dev, f32 = h // kvh, q.device, torch.float32
    nsplit = lib.repro_decode_bwd_num_splits(c)
    m_p, l_p, t_p = (torch.empty((b, kvh, nsplit, rep), dtype=f32, device=dev)
                     for _ in range(3))
    dq_p = torch.empty((b, kvh, nsplit, rep, dh), dtype=f32, device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(kc), torch.empty_like(vc)
    mask = valid.view(torch.uint8)
    strides = (q.stride(0), q.stride(2), *kc.stride()[:3], *vc.stride()[:3], *mask.stride(),
               do.stride(0), do.stride(2), dq.stride(0), dq.stride(2), *dk.stride()[:3],
               *dv.stride()[:3])
    st = (ctypes.c_int64 * len(strides))(*strides)
    err = lib.repro_decode_attention_bwd(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), mask.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), m_p.data_ptr(), l_p.data_ptr(),
        t_p.data_ptr(), dq_p.data_ptr(), DTYPES[q.dtype], b, c, h, kvh, dh,
        ctypes.cast(st, ctypes.c_void_p), dh ** -0.5, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the earlier kernel's launch failed with cudaError_t {err}")
    return dq, dk, dv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", type=Path, required=True)
    ap.add_argument("--target-blocks", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_bwd_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from _ab import build_of, card_line, read_rounds, with_lib
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_bwd as dab

    old = build_of(args.old_source, "decode_attention_bwd_old", {
        "repro_decode_attention_bwd": [_P] * 12 + [_I] * 6 + [_P, _F, _I, _P],
        "repro_decode_bwd_num_splits": [_I]})
    target = build_of(dab.KERNEL.source, f"decode_attention_bwd_target{args.target_blocks}",
                      dab.KERNEL.signatures, target_text(dab.KERNEL, args.target_blocks)
                      ) if args.target_blocks else None
    secs = _build.build_all([da.KERNEL, dab.KERNEL, old] + ([target] if target else []))
    print(f"built in {secs:.1f} s", flush=True)
    for label, k in (("new", dab.KERNEL), ("old", old)):
        for fn, res in k.resources().items():
            print(f"[{label}] {fn}: {res}", flush=True)
    old_lib, new_lib = old.lib(), dab.KERNEL.lib()
    target_lib = target.lib() if target else None
    bf16 = torch.bfloat16
    result = {}
    for tag, b, c, h, kv, dh in SHAPES:
        q, kc, vc, valid = cs.decode_inputs(b, c, h, kv, dh, bf16, "all", seed=61)
        do = cs.decode_inputs(b, 1, h, kv, dh, bf16, "all", seed=161)[0]
        _, lse, o32 = da.decode_attention(q, kc, vc, valid, residuals=True)
        new = lambda: dab.decode_attention_bwd(q, kc, vc, valid, do, lse=lse, o=o32)  # noqa: E731
        calls = {"old": lambda: old_call(old_lib, q, kc, vc, valid, do), "new": new,
                 "fwd": lambda: da.decode_attention(q, kc, vc, valid),
                 "fwd_residuals": lambda: da.decode_attention(q, kc, vc, valid, residuals=True)}
        if target_lib is not None:
            calls["target"] = with_lib(dab.KERNEL, target_lib, new)
            print(f"[{tag}] splits: {new_lib.repro_decode_bwd_split(b, c, kv, dh)} slots, "
                  f"target {target_lib.repro_decode_bwd_split(b, c, kv, dh)}", flush=True)
        want = ref.decode_attention_bwd(q, kc, vc, valid, do)
        for label in [k for k in calls if not k.startswith("fwd")]:
            r = [ref.grad_tolerance_ratio(g, w) for g, w in zip(calls[label](), want)]
            print(f"[{tag}] {label} dq, dk, dv at {r[0]:.3f}, {r[1]:.3f}, {r[2]:.3f} of the "
                  f"tolerance", flush=True)
            if not max(r) <= 1:
                raise AssertionError(f"{tag}: the {label} kernel disagrees with the plain version")
        del want
        mid = ["target", "target"] if target_lib is not None else []
        readings, med = read_rounds(
            tag, calls, ["old", "new", *mid, "new", "old", "fwd", "fwd_residuals",
                         "fwd_residuals", "fwd"], args.rounds, args.iters,
            parts=lambda k: (re.findall(r"decode_\w+", k) or [k[:24]])[0], width=13, digits=5)
        print(f"[{tag}] median device ms a call: old {med['old']:.5f}, new {med['new']:.5f} "
              f"(old / new {med['old'] / med['new']:.3f}); forward {med['fwd']:.5f}, with its "
              f"residuals {med['fwd_residuals']:.5f} "
              f"({100 * (med['fwd_residuals'] / med['fwd'] - 1):+.1f} %)"
              + (f"; target {med['target']:.5f}" if "target" in med else ""), flush=True)
        result[tag] = {"median_device_ms": med, "readings": readings}
        del q, kc, vc, do, lse, o32
        torch.cuda.empty_cache()
    print(json.dumps(result))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
