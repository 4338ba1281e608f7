#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of the repository.  Phases, in order; any failure raises
and the script exits non-zero without printing a result:

 1. device: name, count, and ``nvidia-smi`` name and power limit;
 2. build: the three CUDA kernels from ``src/repro_torch/kernels/csrc`` with
    nvcc (one process per source, started together), with registers, shared
    memory and spills from ``-Xptxas -v``;
 3. kernels: each kernel against its plain version on the card at the main
    path's shapes and a few edge cases, to ``ref.tolerance_ratio`` <= 1 for
    the attention kernels (in bf16 one bf16 ulp of each element) and
    ``ref.ssd_tolerance_ratio`` <= 1 for the SSD scan (f32, 1e-5 + 1e-4 of
    each (batch, head)'s largest value); a planted fault (a KV tile, a cache
    split, a chunk's entering state or intra-chunk term dropped, emulated in
    the plain version) must fail the same check; times of kernel, plain
    version and, for attention, ``scaled_dot_product_attention`` (the
    library yardstick, never used by the port; no PyTorch call computes the
    SSD scan) with CUDA events around back-to-back calls, and the card's own
    time per call from torch.profiler;
 4. prefill: full-width llama3-8b (32 layers, bf16, random weights from a
    seed) on B=1, S=4096 through ``make_prefill_step``; the flash kernel must
    launch once per layer, and each launch of one prefill is held against
    the plain version on its own inputs; at depth 2 the logits at every
    position through the kernels must match those through the plain
    versions, and those with a planted fault (kv heads shifted, or the last
    KV tile dropped) must not;
 5. decode: ``make_decode_step`` on the same weights, B=8, capacity 4096,
    8 teacher-forced and 8 greedy tokens; the flash-decode kernel must launch
    once per layer and step; at depth 2 the teacher-forced logits through the
    kernel must match those through the plain version and the prefill of the
    same prompt at every position; then the cache is filled to 4064 slots
    and 16 more steps are timed, and each launch of one step there is held
    against the plain version; torch.profiler gives the device's busy share
    of prefill and decode, and the decode kernel's share of device time;
 6. mamba2-370m prefill: full width and depth (48 layers, bf16, random
    weights from a seed) on B=1, S=32768 through ``make_prefill_step``; the
    SSD kernel must launch once per layer, and each launch of one prefill is
    held against the plain version on its own inputs; at depth 2 the logits
    at every position (in slices of positions) through the kernel must
    match those through the plain version, and those with a planted fault
    (every chunk's entering state dropped) must not;
 7. mamba2-370m decode: ``make_decode_step`` on the same weights, B=8, 8
    teacher-forced and 8 greedy tokens timed; at depth 2, 160 teacher-forced
    steps (across two chunk boundaries) must give the logits of the
    kernel-path prefill of the same prompt at every position, and not those
    of the faulty prefill: the recurrence checks the scan;
 8. serve: ``repro_torch.launch.serve.main`` at full width, llama3-8b and
    mamba2-370m.

The last line is ``{"ok": true, "device": {...}}``; before it come one JSON
line with every kernel's numbers and the ``nvidia-smi`` line.  Needs one card
and no network; exits non-zero where ``torch.cuda.is_available()`` is false
or the repository's sources are missing.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor cores: the peak for f32 operands
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores (printed as a note)
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
# Kernels are held to ref.tolerance_ratio <= 1 (bf16: 1e-5 + 2^-7 |plain|,
# one bf16 ulp of each element; f32: 1e-5).  Whole models are held to the
# worst position's RMS of the logits' difference over the RMS of the logits;
# the kernels' one-ulp differences, carried through two bf16 layers, give
# about 0.01 there, and a head that reads the wrong kv head more than 1:
MODEL_LIMIT = 0.05
# The bf16 flash kernel runs two blocks an SM; nvcc 12.9 gives it 228
# registers at dh=128 once told the block size, 255 without.  The build
# phase fails above this count or on any spill, so a compiler that drops
# the bound shows here rather than as a slower kernel.
FLASH_BF16_MAX_REGISTERS = 240
NO_LAUNCHES = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}


def log(*a):
    print(*a, flush=True)


def flash_tile() -> int:
    """Keys per KV tile of the bf16 flash kernel, from its library."""
    from repro_torch.kernels import flash_attention as fa
    return fa.KERNEL.lib().repro_flash_attention_kv_tile(1)


def flash_q_tile() -> int:
    """Query rows per block of the bf16 flash kernel, from its library."""
    from repro_torch.kernels import flash_attention as fa
    return fa.KERNEL.lib().repro_flash_attention_q_tile(1)


def decode_split() -> int:
    """Cache slots per split (one pass-1 block) of the flash-decode kernel."""
    from repro_torch.kernels import decode_attention as da
    return da.KERNEL.lib().repro_decode_split()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def position_rel_rms(got, want) -> float:
    """Worst position's RMS of (got - want) over the RMS of want, over the
    last (vocabulary) axis."""
    diff = (got.float() - want.float()).pow(2).mean(-1).sqrt()
    return (diff / want.float().pow(2).mean(-1).sqrt()).max().item()


def _device_us(prof) -> dict:
    """{kernel name: (device microseconds, launches)} of a finished profile."""
    from torch.autograd import DeviceType
    return {e.key: (getattr(e, "self_device_time_total", 0) or 0, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def device_ms(fn, iters: int):
    """Device time of one call of ``fn``: the kernel time torch.profiler sees
    over ``iters`` calls, over ``iters``; None where it sees none.  Unlike
    ``time_ms`` it leaves out the gaps where the card waits for the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(us for us, _ in _device_us(prof).values())
    return total_us / iters / 1e3 if total_us > 0 else None


def device_profile(fn, label: str, top: int = 6):
    """Run ``fn`` once under torch.profiler; print kernel time by name and the
    device's busy share of the wall time.  Returns (busy share, {kernel name:
    device ms}), or (None, {}) where the profiler saw no device time (its own
    host cost lengthens the wall time, so the share reads low)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_us(prof)
    busy_us = sum(us for us, _ in kernels.values())
    if busy_us <= 0:  # a measurement missing, not a failure of the port
        log(f"[profile] {label}: the profiler saw no device time: busy share not measured")
        return None, {}
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / wall_us:.1f} %), {sum(n for _, n in kernels.values())} kernels")
    for key, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[profile]   {us / 1e3:9.3f} ms {n:5d}x  {key[:90]}")
    return busy_us / wall_us, {key: us / 1e3 for key, (us, _) in kernels.items()}


def timings(kernel, plain, library, iters: int) -> dict:
    """ms per call of the kernel, its plain version and the library call (None
    where there is none) by CUDA events around back-to-back calls
    (``time_ms``: where the host launches slower than the card runs, this is
    the host's time), and the card's own time per call (``device_ms``, None
    where not measured)."""
    out = {}
    for name, fn, n in (("ms", kernel, iters), ("plain_ms", plain, max(2, iters // 4)),
                        ("library_ms", library, iters)):
        out[name] = time_ms(fn, n) if fn is not None else None
        out[name.replace("ms", "device_ms")] = device_ms(fn, n) if fn is not None else None
    return out


@contextlib.contextmanager
def swapped_ops(**fns):
    """Route the model's kernels (``mha``, ``decode_attention``, ``ssd``)
    through other functions on the card.

    Only this script does this: to run a model through the plain versions,
    through a planted fault, or through the kernels with each launch held
    against its plain version.  The port itself has no such switch.
    """
    from repro_torch.kernels import ops
    saved = {name: getattr(ops, name) for name in fns}
    for name, fn in fns.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def plain_ops():
    from repro_torch.kernels import ref
    return swapped_ops(mha=ref.mha, decode_attention=ref.decode_attention,
                       ssd=ref.ssd_chunked)


def shifted_heads_ops():
    """A planted fault: every query head reads the next kv head's K/V."""
    from repro_torch.kernels import ref
    return swapped_ops(
        mha=lambda q, k, v, **kw: ref.mha(q, k.roll(1, 2), v.roll(1, 2), **kw),
        decode_attention=lambda q, kc, vc, valid, **kw: ref.decode_attention(
            q, kc.roll(1, 2), vc.roll(1, 2), valid, **kw))


def checked_ops(ratios: list):
    """The kernels, with every launch's output held against the plain version
    on the same inputs; each launch appends its tolerance ratio (for the SSD
    scan the worse of y's and the final state's)."""
    from repro_torch.kernels import ops, ref
    mha, dec, ssd = ops.mha, ops.decode_attention, ops.ssd

    def checked_mha(q, k, v, **kw):
        out = mha(q, k, v, **kw)
        ratios.append(ref.tolerance_ratio(out, ref.mha(q, k, v, **kw)))
        return out

    def checked_dec(q, kc, vc, valid, **kw):
        out = dec(q, kc, vc, valid, **kw)
        ratios.append(ref.tolerance_ratio(out, ref.decode_attention(q, kc, vc, valid, **kw)))
        return out

    def checked_ssd(*args, **kw):
        y, st = ssd(*args, **kw)
        y_w, st_w = ref.ssd_chunked(*args, **kw)
        ratios.append(max(ref.ssd_tolerance_ratio(y, y_w),
                          ref.ssd_tolerance_ratio(st, st_w, head_dim=1)))
        return y, st
    return swapped_ops(mha=checked_mha, decode_attention=checked_dec, ssd=checked_ssd)


def hold(label: str, got, want) -> tuple:
    """Kernel output against the plain version's; returns (max_abs_err, ratio)."""
    from repro_torch.kernels import ref
    err, ratio = max_err(got, want), ref.tolerance_ratio(got, want)
    log(f"{label}: max_abs_err {err:.3g}, {ratio:.3f} of the tolerance")
    if not ratio <= 1:
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    return err, ratio


def control(label: str, fault, want, ratio_fn=None) -> float:
    """A planted fault, emulated in the plain version, must fail ``hold``
    (or the check ``ratio_fn`` stands for)."""
    from repro_torch.kernels import ref
    ratio = (ratio_fn or ref.tolerance_ratio)(fault, want)
    log(f"{label}: max_abs_err {max_err(fault, want):.3g}, {ratio:.1f} x the tolerance "
        f"(must exceed 1)")
    if not ratio > 1:
        raise AssertionError(f"{label}: the tolerance does not see this fault")
    return ratio


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    from repro_torch.kernels import _build, ops
    secs = _build.build_all(list(ops.KERNELS.values()))
    log(f"[build] all {len(ops.KERNELS)} kernels in {secs:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, k in ops.KERNELS.items():
        for fn, res in k.resources().items():
            log(f"[build] {name}: {fn}: {res}")
    tc = {fn: res for fn, res in ops.KERNELS["flash_attention"].resources().items()
          if "tc16flash_fwd_kernel" in fn}
    if not tc:
        raise AssertionError("[build] no bf16 tensor-core flash kernel in the ptxas log")
    for fn, res in tc.items():
        if res["registers"] is None or res["registers"] > FLASH_BF16_MAX_REGISTERS \
                or res["spill_stores"]:
            raise AssertionError(f"[build] bf16 flash kernel {fn}: {res}, over "
                                 f"{FLASH_BF16_MAX_REGISTERS} registers or spilling")
    log(f"[build] bf16 flash kernels within {FLASH_BF16_MAX_REGISTERS} registers, no spills")
    fa_lib, da_lib = ops.KERNELS["flash_attention"].lib(), ops.KERNELS["decode_attention"].lib()
    ssd_lib = ops.KERNELS["ssd_scan"].lib()
    log(f"[build] shared memory per block at dh=128: flash bf16 "
        f"{fa_lib.repro_flash_attention_smem_bytes(1, 128)} B ({flash_tile()}-key tiles), "
        f"f32 {fa_lib.repro_flash_attention_smem_bytes(0, 128)} B; decode pass 1 (rep=4) "
        f"{da_lib.repro_decode_attention_smem_bytes(4, 128)} B ({decode_split()}-slot splits); "
        f"ssd scan at chunk 64, N=128: {ssd_lib.repro_ssd_scan_smem_bytes(64, 128)} B")


def flash_case(b, s, h, kv, dh, dtype, seed=0):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)  # noqa: E731
    return mk(b, s, h, dh), mk(b, s, kv, dh), mk(b, s, kv, dh)


def phase_flash():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    bf16, f32 = torch.bfloat16, torch.float32
    worst, worst_ratio = 0.0, 0.0
    for b, s, h, kv, dh, dtype, window in [
            (1, 1000, 32, 8, 128, bf16, None),    # ragged S
            (1, 4096, 32, 8, 128, bf16, 512),     # sliding window
            (1, 1024, 32, 8, 128, f32, None),
            (1, 1024, 32, 8, 120, bf16, None),    # h2o-danube head dim
            (2, 1024, 32, 8, 64, bf16, None)]:
        q, k, v = flash_case(b, s, h, kv, dh, dtype)
        err, ratio = hold(f"[flash] B={b} S={s} H={h} KV={kv} dh={dh} {dtype} window={window}",
                          fa.flash_attention(q, k, v, causal=True, window=window),
                          ref.mha(q, k, v, causal=True, window=window))
        if dtype == bf16:
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)

    # the main path's shape: llama3-8b prefill, one layer
    b, s, h, kv, dh = 1, 4096, 32, 8, 128
    q, k, v = flash_case(b, s, h, kv, dh, bf16, seed=1)
    want = ref.mha(q, k, v, causal=True)
    err, ratio = hold(f"[flash] main shape B={b} S={s} H={h} KV={kv} dh={dh} bf16 causal",
                      fa.flash_attention(q, k, v, causal=True), want)
    worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    tile = flash_tile()
    ctrl = control(f"[flash] control: plain with the last {tile}-key tile dropped",
                   ref.mha(q, k, v, causal=True, kv_valid_len=s - tile), want)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_ratio = ref.tolerance_ratio(lib.transpose(1, 2), want)
    log(f"[flash] sdpa vs plain max_abs_err {max_err(lib.transpose(1, 2), want):.3g}, "
        f"{lib_ratio:.2f} of the tolerance (reported: SDPA rounds P to bf16 before P.V)")
    t = timings(lambda: fa.flash_attention(q, k, v, causal=True),
                lambda: ref.mha(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True), 12)
    ms, plain_ms, library_ms = t["ms"], t["plain_ms"], t["library_ms"]
    pairs = b * h * s * (s + 1) // 2          # unmasked (query, key) pairs
    flops = 4 * pairs * dh                    # QK^T and PV, two FLOPs per multiply-add
    # derived, not measured: the tensor-core FLOPs of every whole q x kv tile
    # the kernel visits (tile sizes from its library; q tile a multiple of the
    # kv tile, so causal tiles end on the diagonal), with P.V done twice (P
    # split into a bf16 high and low part, csrc/flash_attention.cu)
    bq, bk = flash_q_tile(), flash_tile()
    if bq % bk:
        raise AssertionError(f"[flash] q tile {bq} not a multiple of the kv tile {bk}")
    kv_tiles = sum(-(-min(s, (i + 1) * bq) // bk) for i in range(-(-s // bq)))
    executed = (1 + 2) * 2 * b * h * kv_tiles * bq * bk * dh
    nbytes = 2 * (2 * b * s * h * dh + 2 * b * s * kv * dh)
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    dev_ms = t["device_ms"] or ms
    log(f"[flash] {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, {library_ms:.3f} ms sdpa "
        f"(CUDA events; device time {t['device_ms']} / {t['plain_device_ms']} / "
        f"{t['library_device_ms']}), bound {bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP needed, "
        f"{nbytes / 1e6:.1f} MB); {flops / dev_ms / 1e9:.1f} TFLOP/s needed, "
        f"{100 * bound_ms / dev_ms:.1f} % of the bound (device time)")
    log(f"[flash] derived from the kernel's {bq}x{bk} tiles and P.V done twice, not measured: "
        f"{executed / 1e9:.1f} GFLOP on the tensor cores, "
        f"{executed / dev_ms / 1e9:.1f} TFLOP/s at the device time")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:36",
            "max_abs_err": worst, "tolerance": "1e-5 + 2^-7 |plain| (bf16)",
            "tolerance_ratio": worst_ratio, "control_ratio": ctrl,
            "library_tolerance_ratio": lib_ratio, **t,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_HBM_BYTES
            else "bytes",
            "shape": f"B={b} S={s} H={h} KV={kv} dh={dh} bf16 causal"}


def decode_inputs(b, c, h, kv, dh, dtype, kind, seed=0):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)  # noqa: E731
    q, kc, vc = mk(b, 1, h, dh), mk(b, c, kv, dh), mk(b, c, kv, dh)
    if kind == "prefix":
        lens = torch.randint(1, c + 1, (b,), generator=gen, device="cuda")
        valid = torch.arange(c, device="cuda")[None, :] < lens[:, None]
    elif kind == "holes":
        valid = torch.rand((b, c), generator=gen, device="cuda") < 0.6
    else:
        valid = torch.ones((b, c), dtype=torch.bool, device="cuda")
    return q, kc, vc, valid


def phase_decode_kernel():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    bf16, f32 = torch.bfloat16, torch.float32
    worst, worst_ratio = 0.0, 0.0
    for b, c, dtype, kind in [(8, 4096, bf16, "prefix"), (8, 4100, bf16, "holes"),
                              (8, 4096, f32, "holes")]:
        q, kc, vc, valid = decode_inputs(b, c, 32, 8, 128, dtype, kind)
        err, ratio = hold(f"[decode] B={b} C={c} H=32 KV=8 dh=128 {dtype} mask={kind}",
                          da.decode_attention(q, kc, vc, valid),
                          ref.decode_attention(q, kc, vc, valid))
        if dtype == bf16:
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)

    # the main path's shape with every slot valid: a full 4096-slot cache
    b, c, h, kv, dh = 8, 4096, 32, 8, 128
    q, kc, vc, valid = decode_inputs(b, c, h, kv, dh, bf16, "all", seed=1)
    want = ref.decode_attention(q, kc, vc, valid)
    err, ratio = hold(f"[decode] main shape B={b} C={c} all valid",
                      da.decode_attention(q, kc, vc, valid), want)
    worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    split = decode_split()
    dropped = valid.clone()
    dropped[:, c // 2:c // 2 + split] = False
    ctrl = control(f"[decode] control: plain with one {split}-slot split dropped",
                   ref.decode_attention(q, kc, vc, dropped), want)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
    am = valid[:, None, None, :]
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, enable_gqa=True)
    lib_ratio = ref.tolerance_ratio(lib.transpose(1, 2), want)
    log(f"[decode] sdpa vs plain max_abs_err {max_err(lib.transpose(1, 2), want):.3g}, "
        f"{lib_ratio:.2f} of the tolerance (reported)")
    t = timings(lambda: da.decode_attention(q, kc, vc, valid),
                lambda: ref.decode_attention(q, kc, vc, valid),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                                       enable_gqa=True), 40)
    ms, plain_ms, library_ms = t["ms"], t["plain_ms"], t["library_ms"]
    n_valid = int(valid.sum().item())          # slots this run's mask lets through
    kv_bytes = 2 * n_valid * kv * dh * 2
    nbytes = kv_bytes + 2 * (2 * b * h * dh) + b * c
    flops = 4 * n_valid * h * dh
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    dev_ms = t["device_ms"] or ms
    log(f"[decode] {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, {library_ms:.4f} ms sdpa "
        f"(CUDA events; device time {t['device_ms']} / {t['plain_device_ms']} / "
        f"{t['library_device_ms']}), bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB); "
        f"{nbytes / dev_ms / 1e6:.0f} GB/s achieved, {100 * bound_ms / dev_ms:.1f} % of the "
        f"bound (device time)")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:29",
            "max_abs_err": worst, "tolerance": "1e-5 + 2^-7 |plain| (bf16)",
            "tolerance_ratio": worst_ratio, "control_ratio": ctrl,
            "library_tolerance_ratio": lib_ratio, **t,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_HBM_BYTES
            else "bytes",
            "shape": f"B={b} C={c} H={h} KV={kv} dh={dh} bf16, all slots valid"}


def _first_periods(params, n: int):
    """The same weights cut to the first ``n`` periods (views, no copies)."""
    cut = dict(params)
    cut["layers"] = [{k: ({kk: vv[:n] for kk, vv in v.items()} if isinstance(v, dict)
                          else v[:n]) for k, v in lp.items()} for lp in params["layers"]]
    return cut


def phase_prefill(cfg, params):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import padded_vocab
    from repro_torch.serve.step import ServeSetup, make_prefill_step
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, 4096), generator=gen, device="cuda")
    step = make_prefill_step(ServeSetup(cfg=cfg), (1, 1), params)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        if counts != {**NO_LAUNCHES, "flash_attention": cfg.n_layers}:
            raise AssertionError(f"prefill launches {counts}, want {cfg.n_layers} flash")
    if logits.shape != (1, 1, padded_vocab(cfg)) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite/shaped")
    log(f"[prefill] llama3-8b 32 layers B=1 S=4096: {times[0]:.1f} ms first, "
        f"{times[1]:.1f} ms second; flash launches {counts['flash_attention']}")
    busy, _ = device_profile(lambda: step(params, {"tokens": tokens}), "prefill B=1 S=4096")

    # every launch of a full prefill, held against the plain version on its own inputs
    ratios = []
    with checked_ops(ratios):
        step(params, {"tokens": tokens})
    log(f"[prefill] 32 layers: each flash launch against ref.mha on the same inputs: "
        f"worst {max(ratios):.3f} of the tolerance over {len(ratios)} launches")
    if len(ratios) != cfg.n_layers or not max(ratios) <= 1:
        raise AssertionError(f"prefill: a flash launch disagrees with ref.mha: {ratios}")

    # depth 2, full width: logits at every position through the kernels, the
    # plain versions and two planted faults
    cfg2 = cfg.replace(n_layers=2)
    p2 = _first_periods(params, 2)

    def all_logits():
        return tf.lm_forward(p2, {"tokens": tokens}, cfg2)[0]
    got = all_logits()
    with plain_ops():
        want = all_logits()
    rel = position_rel_rms(got, want)
    del got
    with shifted_heads_ops():
        shifted = position_rel_rms(all_logits(), want)
    tile = flash_tile()
    with swapped_ops(mha=lambda q, k, v, **kw: ref.mha(
            q, k, v, kv_valid_len=k.shape[1] - tile, **kw)):
        dropped = position_rel_rms(all_logits(), want)
    log(f"[prefill] depth 2, full width, all 4096 positions, worst position's relative RMS "
        f"of the logits: kernels vs plain {rel:.3g} (limit {MODEL_LIMIT}); controls: "
        f"heads shifted {shifted:.3g}, last {tile}-key tile dropped {dropped:.3g} "
        f"(both must exceed the limit)")
    if not rel <= MODEL_LIMIT < min(shifted, dropped):
        raise AssertionError(f"depth-2 prefill: kernels {rel}, controls {shifted}, {dropped}")
    return {"flash_launches": counts["flash_attention"], "prefill_calls": 1,
            "prefill_ms": times[1], "prefill_first_ms": times[0],
            "prefill_device_busy": busy, "prefill_flash_worst_ratio": max(ratios),
            "prefill_depth2_rel_rms": rel, "prefill_depth2_shifted_heads": shifted,
            "prefill_depth2_tile_dropped": dropped}


def fill_cache(state, n: int, seed: int) -> None:
    """Random K/V in the first ``n`` slots of every layer, as if ``n`` tokens
    had been decoded, and every later slot empty."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for c in state:
        c["k"][:, :, :n].normal_(generator=gen)
        c["v"][:, :, :n].normal_(generator=gen)
        c["slot_pos"].fill_(-1)
        c["slot_pos"][:, :n] = torch.arange(n, dtype=c["slot_pos"].dtype, device="cuda")


def phase_decode(cfg, params):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import ServeSetup, init_serve_state, make_decode_step
    b, cap, n_forced, n_gen = 8, 4096, 8, 8
    setup = ServeSetup(cfg=cfg)
    state = init_serve_state(setup, (1, 1), params, b, cap)
    step = make_decode_step(setup, (1, 1), params, batch=b, capacity=cap)
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (b, n_forced), generator=gen, device="cuda")
    steps = n_forced + n_gen

    def run_steps(first: int, n: int, tok, forced_tokens=None):
        """``n`` steps from position ``first``, teacher-forced on the columns
        of ``forced_tokens`` while they last, then greedy; returns (seconds,
        the logits of each step, decode launches)."""
        nonlocal state
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = []
        t0 = time.perf_counter()
        for i in range(n):
            if forced_tokens is not None and i < forced_tokens.shape[1]:
                tok = forced_tokens[:, i:i + 1]
            logits, state = step(params, state, tok, first + i)
            out.append(logits)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts != {**NO_LAUNCHES, "decode_attention": cfg.n_layers * n}:
            raise AssertionError(f"decode launches {counts}, want {cfg.n_layers * n} decode")
        if not torch.isfinite(logits).all():
            raise AssertionError("decode logits not finite")
        return secs, out, counts["decode_attention"]

    secs, out, launches = run_steps(0, steps, None, forced_tokens=prompt)
    tok_s = b * steps / secs
    log(f"[decode] llama3-8b B={b} cap={cap}: {n_forced} teacher-forced + {n_gen} greedy "
        f"steps in {secs * 1e3:.1f} ms, {secs / steps * 1e3:.2f} ms/step, {tok_s:.1f} tok/s; "
        f"decode launches {launches}")
    busy, _ = device_profile(lambda: run_steps(steps, 2, out[-1].argmax(-1)),
                             f"decode 2 steps B={b} cap={cap}, {steps + 1} filled slots")
    want_f, _ = tf.lm_forward(params, {"tokens": prompt}, cfg)
    deep = position_rel_rms(torch.cat(out[:n_forced], 1), want_f)
    log(f"[decode] 32 layers, {b}x{n_forced} teacher-forced positions vs the prefill of "
        f"the prompt: worst position's relative RMS {deep:.3g} (reported, not checked)")

    # depth 2, full width: the cache built token by token through the kernel
    # must give the logits of every teacher-forced position that the plain
    # version and the prefill give; a planted fault must not
    cfg2 = cfg.replace(n_layers=2)
    p2 = _first_periods(params, 2)

    def forced_logits():
        st = init_serve_state(ServeSetup(cfg=cfg2), (1, 1), p2, b, cap)
        out = []
        for t in range(n_forced):
            lg, st = tf.decode_step(p2, st, prompt[:, t:t + 1], t, cfg2)
            out.append(lg)
        return torch.cat(out, 1)
    got = forced_logits()
    with plain_ops():
        plain = forced_logits()
    with shifted_heads_ops():
        shifted = position_rel_rms(forced_logits(), plain)
    pre, _ = tf.lm_forward(p2, {"tokens": prompt}, cfg2)
    e_plain, e_pre = position_rel_rms(got, plain), position_rel_rms(got, pre)
    log(f"[decode] depth 2, full width, {b}x{n_forced} positions, worst position's relative "
        f"RMS of the logits: kernel vs plain {e_plain:.3g}, vs prefill {e_pre:.3g} (limit "
        f"{MODEL_LIMIT}); control: heads shifted {shifted:.3g} (must exceed the limit)")
    if not (e_plain <= MODEL_LIMIT and e_pre <= MODEL_LIMIT < shifted):
        raise AssertionError(f"depth-2 decode: {e_plain} / {e_pre}, control {shifted}")

    # a realistic context: the cache filled to n_ctx slots, then timed steps
    n_ctx, n_full = cap - 32, 16
    fill_cache(state, n_ctx, seed=5)
    full_s, out, full_launches = run_steps(n_ctx, n_full, out[-1].argmax(-1))
    logits = out[-1]
    full_tok_s = b * n_full / full_s
    log(f"[decode] llama3-8b B={b} cap={cap}, cache filled to {n_ctx} slots: {n_full} steps, "
        f"{full_s / n_full * 1e3:.2f} ms/step, {full_tok_s:.1f} tok/s; decode launches "
        f"{full_launches}")
    full_busy, dev = device_profile(lambda: run_steps(n_ctx + n_full, 2, logits.argmax(-1)),
                                    f"decode 2 steps B={b} cap={cap}, {n_ctx + n_full + 1} "
                                    f"filled slots")
    kernel_ms = sum(ms for key, ms in dev.items() if "decode_partial_kernel" in key
                    or "decode_combine_kernel" in key)
    share = kernel_ms / sum(dev.values()) if dev else None
    if dev:
        log(f"[decode] full context: flash-decode kernels {kernel_ms:.3f} ms of "
            f"{sum(dev.values()):.3f} ms device time over 2 steps ({100 * share:.1f} %)")
    ratios = []
    with checked_ops(ratios):
        step(params, state, logits.argmax(-1), n_ctx + n_full + 2)
    log(f"[decode] full context: each decode launch of one step against "
        f"ref.decode_attention on the same inputs: worst {max(ratios):.3f} of the tolerance "
        f"over {len(ratios)} launches")
    if len(ratios) != cfg.n_layers or not max(ratios) <= 1:
        raise AssertionError(f"decode: a launch disagrees with ref.decode_attention: {ratios}")
    return {"decode_launches": launches, "decode_steps": steps, "decode_tok_s": tok_s,
            "decode_ms_per_step": secs / steps * 1e3, "decode_device_busy": busy,
            "decode_depth2_rel_rms": e_plain, "decode_depth2_vs_prefill": e_pre,
            "decode_depth2_shifted_heads": shifted, "decode_32_layers_vs_prefill": deep,
            "full_context_slots": n_ctx, "full_context_launches": full_launches,
            "full_context_ms_per_step": full_s / n_full * 1e3,
            "full_context_tok_s": full_tok_s, "full_context_device_busy": full_busy,
            "full_context_kernel_share_of_device": share,
            "full_context_decode_worst_ratio": max(ratios)}


def ssd_inputs(b, s, h, p, g, n, seed=0, h_init=False):
    """Inputs at the model's scale, x, B and C sliced out of one conv output
    [B,S,H*P+2*G*N] as ``ssm_apply`` slices them (strided, not copied); dt
    = softplus(z + dt_bias) with dt_bias drawn as the model's init draws it;
    a = -(1..H)."""
    import math

    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xbc = F.silu(torch.randn((b, s, h * p + 2 * g * n), generator=gen, device="cuda"))
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt0 = torch.exp(torch.rand((h,), generator=gen, device="cuda") * (hi - lo) + lo)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda") + dt_bias)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
    h0 = torch.randn((b, h, p, n), generator=gen, device="cuda") if h_init else None
    return x, dt, a, bm, cm, h0


def pad_seq(t, s_to: int):
    import torch.nn.functional as F
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, s_to - t.shape[1]))


def ssd_drop_entering_state(x, dt, a, bm, cm, chunk, at):
    """A planted fault: the plain scan with the state entering chunk ``at`` dropped."""
    import torch
    from repro_torch.kernels import ref
    cut = at * chunk
    y1, _ = ref.ssd_chunked(x[:, :cut], dt[:, :cut], a, bm[:, :cut], cm[:, :cut], chunk)
    y2, st = ref.ssd_chunked(x[:, cut:], dt[:, cut:], a, bm[:, cut:], cm[:, cut:], chunk)
    return torch.cat([y1, y2], 1), st


def ssd_drop_intra(x, dt, a, bm, cm, chunk, at):
    """A planted fault: the plain scan without chunk ``at``'s intra-chunk term
    (that chunk alone from a zero state is exactly its intra-chunk term)."""
    from repro_torch.kernels import ref
    y, st = ref.ssd_chunked(x, dt, a, bm, cm, chunk)
    sl = slice(at * chunk, (at + 1) * chunk)
    intra, _ = ref.ssd_chunked(x[:, sl], dt[:, sl], a, bm[:, sl], cm[:, sl], chunk)
    y[:, sl] -= intra
    return y, st


def ssd_chunks_independent(x, dt, a, bm, cm, chunk, h_init=None):
    """A planted model fault: every chunk's entering state dropped (the plain
    scan over each chunk as a sequence of its own; a ragged S zero-padded)."""
    from repro_torch.kernels import ref
    b, s, h, p = x.shape
    nc, g, n = -(-s // chunk), bm.shape[2], bm.shape[3]
    x, dt, bm, cm = (pad_seq(t, nc * chunk) for t in (x, dt, bm, cm))
    y, st = ref.ssd_chunked(x.reshape(b * nc, chunk, h, p), dt.reshape(b * nc, chunk, h), a,
                            bm.reshape(b * nc, chunk, g, n), cm.reshape(b * nc, chunk, g, n),
                            chunk)
    return y.reshape(b, nc * chunk, h, p)[:, :s], st.reshape(b, nc, h, p, n)[:, -1]


def hold_ssd(label: str, y, st, y_want, st_want) -> tuple:
    """The SSD kernel's y and state against the plain version's; returns
    (max_abs_err, worst ratio)."""
    from repro_torch.kernels import ref
    ratio = max(ref.ssd_tolerance_ratio(y, y_want), ref.ssd_tolerance_ratio(st, st_want, 1))
    err = max(max_err(y, y_want), max_err(st, st_want))
    log(f"{label}: max_abs_err {err:.3g} (max |y| {y_want.abs().max().item():.3g}), "
        f"{ratio:.4f} of the tolerance, margin {1 - ratio:.4f}")
    if not ratio <= 1:
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    return err, ratio


def phase_ssd_kernel():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as tssd
    worst, worst_ratio = 0.0, 0.0
    for b, s, h, p, g, n, chunk, h_init, padded in [
            (2, 4096, 32, 64, 2, 128, 64, False, False),    # two groups
            (1, 2048, 32, 64, 1, 128, 8, False, False),     # chunks 8, 16, 32
            (1, 2048, 32, 64, 1, 128, 16, False, False),
            (1, 2048, 32, 64, 1, 128, 32, False, False),
            (1, 1000, 32, 64, 1, 128, 64, False, False),    # ragged S, masked by the kernel
            (1, 1000, 32, 64, 1, 128, 64, False, True),     # ragged S, zero-padded by the caller
            (1, 2048, 32, 64, 1, 128, 64, True, False)]:    # h_init
        x, dt, a, bm, cm, h0 = ssd_inputs(b, s, h, p, g, n, h_init=h_init)
        y_w, st_w = ref.ssd_chunked(x, dt, a, bm, cm, chunk, h_init=h0)
        if padded:
            sp = -(-s // chunk) * chunk
            y, st = tssd.ssd_scan(*(pad_seq(t, sp) for t in (x, dt)), a,
                                  *(pad_seq(t, sp) for t in (bm, cm)), chunk, h_init=h0)
            y = y[:, :s]
        else:
            y, st = tssd.ssd_scan(x, dt, a, bm, cm, chunk, h_init=h0)
        err, ratio = hold_ssd(f"[ssd] B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk}"
                              f"{' h_init' if h_init else ''}{' zero-padded' if padded else ''}",
                              y, st, y_w, st_w)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)

    # the main path's shape: mamba2-370m prefill, one layer
    b, s, h, p, g, n, chunk = 1, 32768, 32, 64, 1, 128, 64
    x, dt, a, bm, cm, _ = ssd_inputs(b, s, h, p, g, n, seed=1)
    y_w, st_w = ref.ssd_chunked(x, dt, a, bm, cm, chunk)
    y, st = tssd.ssd_scan(x, dt, a, bm, cm, chunk)
    err, ratio = hold_ssd(f"[ssd] main shape B={b} S={s} H={h} P={p} G={g} N={n} "
                          f"chunk={chunk}, strided inputs", y, st, y_w, st_w)
    worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    del y, st
    at = s // chunk // 2
    ctrl = min(control(f"[ssd] control: plain with the state entering chunk {at} dropped",
                       ssd_drop_entering_state(x, dt, a, bm, cm, chunk, at)[0], y_w,
                       ratio_fn=ref.ssd_tolerance_ratio),
               control(f"[ssd] control: plain without chunk {at}'s intra-chunk term",
                       ssd_drop_intra(x, dt, a, bm, cm, chunk, at)[0], y_w,
                       ratio_fn=ref.ssd_tolerance_ratio))
    del y_w, st_w
    torch.cuda.empty_cache()
    t = timings(lambda: tssd.ssd_scan(x, dt, a, bm, cm, chunk),
                lambda: ref.ssd_chunked(x, dt, a, bm, cm, chunk), None, 12)
    nc, L = s // chunk, chunk
    # bytes: each input read once, each output written once (f32)
    nbytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * g * n + b * h * p * n + h)
    # least operations: C B^T once per group and chunk, causal halves, the
    # state read and the state update
    flops = b * nc * (g * L * (L + 1) * n + h * (L * (L + 1) * p + 4 * L * n * p))
    # f32 operands: the card's peak for them is the TF32 tensor cores
    bound_ms = max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    ms = t["ms"]
    log(f"[ssd] {ms:.3f} ms kernel, {t['plain_ms']:.3f} ms plain (CUDA events; device time "
        f"{t['device_ms']} / {t['plain_device_ms']}); no library call computes the SSD scan; "
        f"bound {bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP: {flops / PEAK_TF32_FLOPS * 1e3:.4f} "
        f"ms on the TF32 tensor cores, {flops / PEAK_F32_FLOPS * 1e3:.4f} ms on the f32 CUDA "
        f"cores alone; {nbytes / 1e6:.1f} MB: {nbytes / PEAK_HBM_BYTES * 1e3:.4f} ms); "
        f"{flops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e6:.0f} GB/s achieved")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:31",
            "max_abs_err": worst, "tolerance": "1e-5 + 1e-4 max|plain| per (batch, head) (f32)",
            "tolerance_ratio": worst_ratio, "control_ratio": ctrl, **t,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_TF32_FLOPS > nbytes / PEAK_HBM_BYTES
            else "bytes",
            "shape": f"B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk} f32, strided"}


def sliced_logits_rel_rms(p2, cfg2, tokens, runs: dict, slice_len: int = 4096) -> dict:
    """Worst position's relative RMS of the logits of each run against the
    first, at every position.  ``runs`` maps a label to a context manager
    factory (or None for the port as it is); ``lm_forward`` gives the final
    hidden states and ``unembed`` makes the logits ``slice_len`` positions
    at a time, since all logits at S=32768 would take 6.6 GB in f32."""
    from repro_torch.models import transformer as tf
    hs = {}
    for label, ctx in runs.items():
        with (ctx() if ctx is not None else contextlib.nullcontext()):
            hs[label], _ = tf.lm_forward(p2, {"tokens": tokens}, cfg2, hidden=True)
    labels = list(runs)
    out = {label: 0.0 for label in labels[1:]}
    for i in range(0, tokens.shape[1], slice_len):
        want = tf.unembed(p2, hs[labels[0]][:, i:i + slice_len], cfg2)
        for label in labels[1:]:
            got = tf.unembed(p2, hs[label][:, i:i + slice_len], cfg2)
            out[label] = max(out[label], position_rel_rms(got, want))
    return out


def phase_mamba_prefill(cfg, params):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.layers import padded_vocab
    from repro_torch.serve.step import ServeSetup, make_prefill_step
    s = 32768
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device="cuda")
    step = make_prefill_step(ServeSetup(cfg=cfg), (1, 1), params)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        if counts != {**NO_LAUNCHES, "ssd_scan": cfg.n_layers}:
            raise AssertionError(f"mamba prefill launches {counts}, want {cfg.n_layers} ssd")
    if logits.shape != (1, 1, padded_vocab(cfg)) or not torch.isfinite(logits).all():
        raise AssertionError(f"mamba prefill logits {tuple(logits.shape)} not finite/shaped")
    log(f"[mamba prefill] mamba2-370m {cfg.n_layers} layers B=1 S={s}: {times[0]:.1f} ms "
        f"first, {times[1]:.1f} ms second; ssd launches {counts['ssd_scan']}")
    busy, dev = device_profile(lambda: step(params, {"tokens": tokens}),
                               f"mamba prefill B=1 S={s}")
    ssd_ms = sum(ms for key, ms in dev.items() if "ssd_chunk_scan_kernel" in key)
    share = ssd_ms / sum(dev.values()) if dev else None
    if dev:
        log(f"[mamba prefill] ssd kernel {ssd_ms:.2f} ms of {sum(dev.values()):.2f} ms device "
            f"time ({100 * share:.1f} %)")

    ratios = []
    with checked_ops(ratios):
        step(params, {"tokens": tokens})
    log(f"[mamba prefill] {cfg.n_layers} layers: each ssd launch against ref.ssd_chunked on the "
        f"same inputs: worst {max(ratios):.4f} of the tolerance over {len(ratios)} launches")
    if len(ratios) != cfg.n_layers or not max(ratios) <= 1:
        raise AssertionError(f"mamba prefill: an ssd launch disagrees with the plain version: "
                             f"{ratios}")

    # depth 2, full width: logits at every position through the kernel, the
    # plain version and a planted fault
    cfg2 = cfg.replace(n_layers=2)
    p2 = _first_periods(params, 2)
    rel = sliced_logits_rel_rms(p2, cfg2, tokens, {
        "plain": plain_ops, "kernel": None,
        "chunks independent": lambda: swapped_ops(ssd=ssd_chunks_independent),
        "middle state dropped": lambda: swapped_ops(
            ssd=lambda x, dt, a, bm, cm, chunk, h_init=None: ssd_drop_entering_state(
                x, dt, a, bm, cm, chunk, x.shape[1] // chunk // 2))})
    log(f"[mamba prefill] depth 2, full width, all {s} positions, worst position's relative "
        f"RMS of the logits: kernel vs plain {rel['kernel']:.3g} (limit {MODEL_LIMIT}); "
        f"controls: every chunk's entering state dropped {rel['chunks independent']:.3g} "
        f"(must exceed the limit), the middle chunk's entering state dropped "
        f"{rel['middle state dropped']:.3g} (reported)")
    if not rel["kernel"] <= MODEL_LIMIT < rel["chunks independent"]:
        raise AssertionError(f"depth-2 mamba prefill: {rel}")
    return {"ssd_launches": counts["ssd_scan"], "mamba_prefill_calls": 1,
            "mamba_prefill_ms": times[1], "mamba_prefill_first_ms": times[0],
            "mamba_prefill_device_busy": busy, "mamba_prefill_ssd_share_of_device": share,
            "mamba_prefill_ssd_worst_ratio": max(ratios),
            "mamba_prefill_depth2_rel_rms": rel["kernel"],
            "mamba_prefill_depth2_chunks_independent": rel["chunks independent"],
            "mamba_prefill_depth2_middle_state_dropped": rel["middle state dropped"]}


def phase_mamba_decode(cfg, params):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import ServeSetup, init_serve_state, make_decode_step
    b, n_forced, n_gen = 8, 8, 8
    steps = n_forced + n_gen
    setup = ServeSetup(cfg=cfg)
    state = init_serve_state(setup, (1, 1), params, b, steps + 2)
    step = make_decode_step(setup, (1, 1), params, batch=b, capacity=steps + 2)
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (b, n_forced), generator=gen, device="cuda")

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out, tok = [], None
    t0 = time.perf_counter()
    for i in range(steps):
        if i < n_forced:
            tok = prompt[:, i:i + 1]
        logits, state = step(params, state, tok, i)
        out.append(logits)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    if counts != NO_LAUNCHES or not torch.isfinite(logits).all():
        raise AssertionError(f"mamba decode: launches {counts} (the recurrent step launches "
                             f"no kernel of the port), finite {torch.isfinite(logits).all()}")
    tok_s = b * steps / secs
    log(f"[mamba decode] mamba2-370m B={b}: {n_forced} teacher-forced + {n_gen} greedy steps "
        f"in {secs * 1e3:.1f} ms, {secs / steps * 1e3:.2f} ms/step, {tok_s:.1f} tok/s")
    busy, _ = device_profile(lambda: step(params, state, tok, steps), f"mamba decode 1 step B={b}")
    want, _ = tf.lm_forward(params, {"tokens": prompt}, cfg)
    deep = position_rel_rms(torch.cat(out[:n_forced], 1), want)
    log(f"[mamba decode] {cfg.n_layers} layers, {b}x{n_forced} teacher-forced positions vs the "
        f"prefill of the prompt: worst position's relative RMS {deep:.3g} (reported)")

    # depth 2: the recurrence over 160 positions (two chunk boundaries of 64)
    # against the kernel-path prefill of the same prompt, and a faulty prefill
    cfg2 = cfg.replace(n_layers=2)
    p2 = _first_periods(params, 2)
    n_long = 160
    prompt2 = torch.randint(0, cfg.vocab_size, (b, n_long), generator=gen, device="cuda")
    st2 = init_serve_state(ServeSetup(cfg=cfg2), (1, 1), p2, b, n_long)
    forced = []
    for t in range(n_long):
        lg, st2 = tf.decode_step(p2, st2, prompt2[:, t:t + 1], t, cfg2)
        forced.append(lg)
    forced = torch.cat(forced, 1)
    ops.reset_launch_counts()
    pre, _ = tf.lm_forward(p2, {"tokens": prompt2}, cfg2)
    if ops.launch_counts()["ssd_scan"] != cfg2.n_layers:
        raise AssertionError("depth-2 prefill did not run the ssd kernel")
    with swapped_ops(ssd=ssd_chunks_independent):
        faulty, _ = tf.lm_forward(p2, {"tokens": prompt2}, cfg2)
    e_pre, e_fault = position_rel_rms(forced, pre), position_rel_rms(forced, faulty)
    log(f"[mamba decode] depth 2, full width, {b}x{n_long} teacher-forced positions vs the "
        f"kernel-path prefill: worst position's relative RMS {e_pre:.3g} (limit {MODEL_LIMIT}); "
        f"control: vs a prefill with every chunk's entering state dropped {e_fault:.3g} "
        f"(must exceed the limit)")
    if not e_pre <= MODEL_LIMIT < e_fault:
        raise AssertionError(f"depth-2 mamba decode vs prefill: {e_pre}, control {e_fault}")
    return {"mamba_decode_steps": steps, "mamba_decode_tok_s": tok_s,
            "mamba_decode_ms_per_step": secs / steps * 1e3, "mamba_decode_device_busy": busy,
            "mamba_decode_48_layers_vs_prefill": deep,
            "mamba_decode_depth2_vs_prefill": e_pre,
            "mamba_decode_depth2_vs_faulty_prefill": e_fault}


def run() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} missing; run from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    t_start = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()
    kernels = [phase_flash(), phase_decode_kernel(), phase_ssd_kernel()]

    cfg = get_config("llama3_8b")
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] llama3-8b {tf.param_count(params) / 1e9:.3f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    pre = phase_prefill(cfg, params)
    dec = phase_decode(cfg, params)
    kernels[0].update(launches=pre["flash_launches"],
                      launches_per_step=pre["flash_launches"] / pre["prefill_calls"])
    kernels[1].update(launches=dec["decode_launches"],
                      launches_per_step=dec["decode_launches"] / dec["decode_steps"])
    del params
    torch.cuda.empty_cache()

    cfg = get_config("mamba2_370m")
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] mamba2-370m {tf.param_count(params) / 1e9:.3f} B params (bf16 projections, "
        f"f32 SSM leaves) in {time.perf_counter() - t0:.1f} s")
    mpre = phase_mamba_prefill(cfg, params)
    mdec = phase_mamba_decode(cfg, params)
    kernels[2].update(launches=mpre["ssd_launches"],
                      launches_per_step=mpre["ssd_launches"] / mpre["mamba_prefill_calls"])
    del params
    torch.cuda.empty_cache()

    for arch in ("llama3_8b", "mamba2_370m"):
        out = serve.main(["--arch", arch, "--batch", "4", "--prompt-len", "12", "--gen", "20"])
        if not torch.isfinite(out["logits"]).all():
            raise AssertionError(f"serve entry point, {arch}: logits not finite")
    log(f"[serve] ok; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
        f"whole run {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels, **pre, **dec, **mpre, **mdec, "card": smi}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
