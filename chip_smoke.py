#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of the repository.  Phases, in order; any failure raises
and the script exits non-zero without printing a result:

 1. device: name, count, and ``nvidia-smi`` name and power limit;
 2. build: the five CUDA kernels from ``src/repro_torch/kernels/csrc`` with
    nvcc (one process per source, started together), with registers, shared
    memory and spills from ``-Xptxas -v``; a spill in the bf16 flash kernel,
    in the flash backward's kernels, in any pass of the SSD scan or of its
    backward or in any 256-wide instantiation fails, as does a missing bf16
    tensor-core flash, dk/dv or dq kernel (dh 64, 128 and 256);
 3. kernels: each kernel against its plain version on the card at the main
    path's shapes and a few edge cases, to ``ref.tolerance_ratio`` <= 1 for
    the attention kernels (in bf16 one bf16 ulp of each element) and
    ``ref.ssd_tolerance_ratio`` <= 1 for the SSD scan (f32, 1e-5 + 1e-4 of
    each (batch, head)'s largest value); a planted fault (a KV tile, a cache
    split, a chunk's entering state, also at the first chunk of one of the
    SSD kernel's segments, or an intra-chunk term dropped, emulated in the
    plain version) must fail the same check; times of kernel, plain version
    and, for attention, ``scaled_dot_product_attention`` (the library
    yardstick, never used by the port; no PyTorch call computes the SSD
    scan) with CUDA events around back-to-back calls, and the card's own
    time per call from torch.profiler, for the SSD scan also per pass; the
    flash backward kernel against ``ref.mha_bwd`` (dq, dk and dv, to
    ``ref.grad_tolerance_ratio`` <= 1: one bf16 ulp, or 1e-4 in f32) at the
    training path's shape, with a binding window and in f32 with a ragged S,
    with the forward kernel's log-sum-exp against ``ref.mha_fwd_lse``'s, three
    planted faults, and the autograd of ``scaled_dot_product_attention`` as
    its library yardstick; its device time per pass (delta, dk/dv, dq) and
    the tensor-core FLOPs its tiles execute (derived, logged only);
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
 8. deepseek-moe-16b prefill: full width and depth (28 layers, bf16, random
    weights from a seed) on B=1, S=4096 through ``make_prefill_step``; the
    flash kernel must launch once per layer, and each launch is held
    against the plain version on its own inputs; at depth 2 each run's
    routing is recorded: the (token, k) choices that the kernels flip
    against the plain versions must stay within 1 %, and over the tokens
    routed alike the logits must match and those of two planted faults
    must not;
 9. deepseek-moe-16b decode: B=8, capacity 4096, (a) 8 teacher-forced and 8
    greedy steps from an empty cache, (b) 16 steps with the cache filled to
    4064 slots; flash-decode once per layer and step; host and device ms a
    step beside the floor of the bytes a step reads; at depth 2 the
    teacher-forced logits through the kernel must match the plain
    version's and the prefill's over the positions routed alike, and a
    planted fault's must not; each decode launch of one step is held
    against the plain version;
10. gemma-7b prefill: full width and depth (28 layers, 16 heads on 16 kv
    heads at dh 256, GeGLU, tied embeddings, bf16, random weights from
    seed 0), as phase 4: every one of its 28 flash launches (the 256-wide
    instantiation) held against the plain version, and the depth-2 logits;
11. gemma-7b decode, as phase 9 without routing: (a) and (b), host and
    device ms a step beside the floor, every flash-decode launch of a step
    held against the plain version, the depth-2 teacher-forced logits
    against the plain version's and the prefill's;
12. llama-80b (the paper's Table 3 model) prefill at full width (d=8192, 64
    heads on 8 kv heads, d_ff 28672) on 4 of its 96 layers, B=1, S=4096, as
    phase 4;
13. jamba-v0.1-52b (Mamba-2 and attention 7:1, MoE on every other layer)
    prefill at full width on 8 of its 32 layers (one whole period), B=1,
    S=4096: 7 SSD launches and 1 flash launch, each held against the plain
    version; the logits of the 8 layers through the kernels against the
    plain versions routed as the kernels routed (the plain router's own
    choices there differ from the kernels' in at most 1 %), and two planted
    faults (every chunk's entering state dropped, the kv heads shifted)
    must not match (the last KV tile dropped is reported; free routing's
    flips and the comparison over the tokens routed alike too);
14. jamba decode on the same weights: B=8, capacity 4096, (a) and
    (b), one flash-decode launch a step held against the plain version, and
    the 8-layer teacher-forced logits against the prefill's and the plain
    version's over the positions routed alike;
15. serve: ``repro_torch.launch.serve.main`` at full width, llama3-8b,
    mamba2-370m, deepseek-moe-16b and gemma-7b;
16. train: h2o-danube-3-4b at full width and depth (24 layers, bf16, random
    weights from seed 0) through ``make_train_step`` as ``repro_torch.launch.train`` sets it up
    on an NCCL group of one process, B=1, S=4096, four AdamW steps on one
    fixed ``synth_batch``: the loss must fall at every step, the flash
    forward and backward kernels must launch once per layer and step, and
    each launch of one step is held against its plain version on its own
    inputs; at depth 2 every leaf's gradient through the kernels must match
    the gradient through the plain versions, and the gradient with a planted
    fault in the backward must not; step time, tokens/s, the model-FLOP
    share of the bf16 peak, peak memory and the device's busy share of one
    profiled step;
17. train: granite-moe-1b-a400m (24 layers, 32 experts, top-8) the same way
    at B=2, S=4096, with the model-FLOP share over the active parameters,
    and the first step's ``moe_aux`` held to the aux of the plain forward on
    the same parameters;
18. train: gemma-7b at full width on 8 of its 28 layers (its whole training
    state does not fit the card), B=1, S=4096, the same way;
19. train: mamba2-370m at full width and depth (48 layers), B=1, S=4096, the
    same way: the SSD scan and its backward launch once per layer and step,
    each launch is held against its plain version, and at depth 2 the
    gradients with a planted fault in the backward (ddt without the decays'
    term) must not match; the model-FLOP share counts 6 N T only (the scan's
    FLOPs are not counted).

The kernel phase also holds the SSD scan's backward kernel to
``ref.ssd_chunked_bwd`` at mamba2-370m's training shape and its edge cases
(G=2, a ragged S, h_init, jamba's H=128 and N=16 with a = -(1..128), with
and without h_init, a chunk of 16) by ``ref.ssd_grad_tolerance_ratio`` <= 1
on every gradient, with four planted faults that must read > 1 (a carried
state cotangent dropped at a segment boundary, the intra-chunk term of du
dropped, ddt without the decays' gradient, dB from one head of each
group); two calls on the same inputs must give bit-identical gradients;
and it times the kernel and each of its passes.  It also runs each
attention kernel's 256-wide instantiation
at gemma-7b's shapes (flash and its backward at B=1 S=4096, flash-decode at
B=8 and a full 4096-slot cache), held to its plain version, with two planted
faults of its column split (the output's columns 128-255 zeroed, S from the
first 128 dims only) that must fail the same check.

The last line is ``{"ok": true, "device": {...}}``; before it come one JSON
line with every kernel's numbers (and its launches in each path that ran
it) and the ``nvidia-smi`` line.  Needs one card
and no network; exits non-zero where ``torch.cuda.is_available()`` is false
or the repository's sources are missing.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor cores: the peak for f32 operands
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
# Kernels are held to ref.tolerance_ratio <= 1 (bf16: 1e-5 + 2^-7 |plain|,
# one bf16 ulp of each element; f32: 1e-5).  Whole models are held to the
# worst position's RMS of the logits' difference over the RMS of the logits;
# the kernels' one-ulp differences, carried through two bf16 layers, give
# about 0.01 there, and a head that reads the wrong kv head more than 1:
MODEL_LIMIT = 0.05
# An MoE model's routing through the kernels and through the plain versions:
# the share of (token, k) choices that may differ (a one-ulp difference
# flips a near-tie among the experts; a flipped token is left out of the
# logits' comparison, see ``moe_prefill_depth2``).
MOE_FLIP_LIMIT = 0.01
# The bf16 flash kernel runs two blocks an SM up to dh 128; nvcc 12.9 gives
# it 222 registers at dh=128 once told the block size, 255 without.  The
# build phase fails above this count or on any spill, so a compiler that
# drops the bound shows here rather than as a slower kernel.
FLASH_BF16_MAX_REGISTERS = 240
# At dh 256 it runs one block of 8 warps an SM (its 165 KiB of shared
# memory), each warp owning half of the output columns and reading Q's
# fragments from shared memory; nvcc 12.9 gives it 176 registers.  Keeping
# Q's fragments in registers would add 64: the build fails above this count.
FLASH_BF16_256_MAX_REGISTERS = 200
NO_LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0, "decode_attention": 0,
               "ssd_scan": 0, "ssd_scan_bwd": 0}
# The kernels of one flash_attention_bwd call (csrc/flash_attention_bwd.cu).
FLASH_BWD_PASSES = ("delta_kernel", "dkdv_kernel", "dq_kernel")
# Training (phase 11): h2o-danube-3-4b, the one dense configuration whose
# training state (bf16 parameters and gradients, f32 AdamW moments: 47.5 GB)
# fits one 80 GB card, on one sequence of S=4096 (flash attention at S >=
# 1024).  AdamW's lr with a warmup of one step, so the first step takes it
# whole; at 3e-4 a step moves a weight of ~0.016 (1/sqrt(3840)) by ~2 %.
TRAIN_ARCH, TRAIN_SEQ, TRAIN_STEPS = "h2o_danube_3_4b", 4096, 4
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
# The MoE family (phases 8, 9 and 12): deepseek-moe-16b serving at full width and
# depth (16.9 B parameters, 33.8 GB in bf16), and granite-moe-1b-a400m
# training (1.33 B parameters, 0.43 B active a token) at B=2, S=TRAIN_SEQ.
MOE_ARCH, MOE_TRAIN_ARCH, MOE_TRAIN_BATCH = "deepseek_moe_16b", "granite_moe_1b_a400m", 2
# The rest of the dense zoo (phases 10-12 and 16): gemma-7b (attention of 16
# heads on 16 kv heads at dh 256) served at full width and depth, trained at
# full width on GEMMA_TRAIN_LAYERS of its 28 layers (its training state at
# full depth, 102 GB, does not fit one card); the paper's llama-80b (Table 3)
# prefill at full width on PAPER_LAYERS of its 96 layers.
GEMMA_ARCH, GEMMA_TRAIN_LAYERS = "gemma_7b", 8
PAPER_ARCH, PAPER_LAYERS = "llama_80b", 4
GEMMA_ATTN = (16, 16, 256)  # heads, kv heads, head dim
# The CUDA kernels of one ssd_scan call (csrc/ssd_scan.cu), in launch order.
SSD_PASSES = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_combine_kernel", "ssd_output_kernel")
# The CUDA kernels of one ssd_scan_bwd call (csrc/ssd_scan_bwd.cu), in launch order.
SSD_BWD_PASSES = ("ssd_bwd_local_kernel", "ssd_bwd_scan_kernel", "ssd_bwd_chunk_kernel",
                  "ssd_bwd_group_kernel", "ssd_bwd_da_kernel")
# SSM training (phase 19): mamba2-370m at full width and depth.  The hybrid
# family (phases 13 and 14): jamba-v0.1-52b at full width on HYBRID_LAYERS of
# its 32 (one period of the 1:7 pattern with its 4 MoE layers: 13.27 B
# parameters, 26.5 GB in bf16; all 32 layers, ~103 GB, do not fit the card).
SSM_TRAIN_ARCH, HYBRID_ARCH, HYBRID_LAYERS = "mamba2_370m", "jamba_v0_1_52b", 8


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


def device_ms_by_kernel(fn, iters: int) -> dict:
    """{kernel name: device ms per call of ``fn``} that torch.profiler sees
    over ``iters`` calls; empty where it sees none.  A kernel's time is its
    mean time a launch times its launches a call (launches seen / ``iters``,
    rounded), so a profile that lost the records of a few calls (10 of 12
    once on an H100) still reads the time of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for key, (us, n) in _device_us(prof).items():
        if us <= 0:
            continue
        per_call = round(n / iters)
        if per_call and n != per_call * iters:
            log(f"[profile] {n} launches of {key[:60]} seen over {iters} calls: "
                f"taken as {per_call} a call")
        out[key] = (us / n * per_call if per_call else us / iters) / 1e3
    return out


def device_ms(fn, iters: int):
    """Device time of one call of ``fn``: the kernel time torch.profiler sees
    over ``iters`` calls, over ``iters``; None where it sees none.  Unlike
    ``time_ms`` it leaves out the gaps where the card waits for the host."""
    total = sum(device_ms_by_kernel(fn, iters).values())
    return total if total > 0 else None


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


def hold(label: str, got, want, ratio_fn=None) -> tuple:
    """Kernel output against the plain version's, by ``ref.tolerance_ratio``
    or ``ratio_fn``; returns (max_abs_err, ratio)."""
    from repro_torch.kernels import ref
    err, ratio = max_err(got, want), (ratio_fn or ref.tolerance_ratio)(got, want)
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
    if len(tc) != 3:  # dh 64, 128 and 256
        raise AssertionError(f"[build] bf16 tensor-core flash kernels in the ptxas log: {sorted(tc)}")
    for fn, res in tc.items():
        limit = FLASH_BF16_256_MAX_REGISTERS if "Li256E" in fn else FLASH_BF16_MAX_REGISTERS
        if res["registers"] is None or res["registers"] > limit or res["spill_stores"]:
            raise AssertionError(f"[build] bf16 flash kernel {fn}: {res}, over {limit} "
                                 f"registers or spilling")
    log(f"[build] bf16 flash kernels within {FLASH_BF16_MAX_REGISTERS} registers up to dh 128 "
        f"and {FLASH_BF16_256_MAX_REGISTERS} at 256, no spills")
    # every 256-wide instantiation (flash forward, backward and decode, bf16 and f32)
    wide = {f"{name}: {fn}": res for name, k in ops.KERNELS.items()
            for fn, res in k.resources().items() if "Li256E" in fn}
    if len(wide) != 12:  # forward 2, backward 4, decode pass 1: 2 dtypes x 3 bundle sizes
        raise AssertionError(f"[build] 256-wide instantiations in the ptxas log: {sorted(wide)}")
    for fn, res in sorted(wide.items()):
        log(f"[build] dh 256: {fn[:110]}: {res['registers']} registers, {res['static_smem']} B "
            f"static shared memory, {res['spill_stores']} B spilled")
    spills = {fn: res for fn, res in wide.items() if res["spill_stores"]}
    if spills:
        raise AssertionError(f"[build] 256-wide instantiations spilling: {spills}")
    ssd = ops.KERNELS["ssd_scan"].resources()
    missing = [k for k in SSD_PASSES if not any(k in fn for fn in ssd)]
    spills = {fn: res for fn, res in ssd.items() if res["spill_stores"]}
    if missing or spills:
        raise AssertionError(f"[build] ssd scan: passes missing from the ptxas log {missing}, "
                             f"spilling {spills}")
    log(f"[build] ssd scan: all {len(SSD_PASSES)} passes built, no spills")
    ssdb = ops.KERNELS["ssd_scan_bwd"].resources()
    missing = [k for k in SSD_BWD_PASSES if not any(k in fn for fn in ssdb)]
    spills = {fn: res for fn, res in ssdb.items() if res["spill_stores"]}
    if missing or spills:
        raise AssertionError(f"[build] ssd scan backward: passes missing from the ptxas log "
                             f"{missing}, spilling {spills}")
    ssdb_lib = ops.KERNELS["ssd_scan_bwd"].lib()
    log("[build] ssd scan backward: all {} passes built, no spills; {}; shared memory per "
        "block: local {} B, chunk {} B".format(
            len(SSD_BWD_PASSES), "; ".join(
                f"{k} {res['registers']} registers, {res['spill_stores']} B spilled"
                for k in SSD_BWD_PASSES for fn, res in ssdb.items() if k in fn),
            ssdb_lib.repro_ssd_scan_bwd_smem_bytes(0), ssdb_lib.repro_ssd_scan_bwd_smem_bytes(1)))
    bwd = ops.KERNELS["flash_attention_bwd"].resources()
    missing = [k for k in FLASH_BWD_PASSES if not any(k in fn for fn in bwd)]
    spills = {fn: res for fn, res in bwd.items() if res["spill_stores"]}
    if missing or spills:
        raise AssertionError(f"[build] flash backward: kernels missing from the ptxas log "
                             f"{missing}, spilling {spills}")
    tc_bwd = {fn: res for fn, res in bwd.items() if "2tc4dkdv11dkdv_kernel" in fn
              or "2tc2dq9dq_kernel" in fn}
    if len(tc_bwd) != 6:  # dk/dv and dq, each at dh 64, 128 and 256
        raise AssertionError(f"[build] flash backward: bf16 tensor-core kernels in the ptxas "
                             f"log: {sorted(tc_bwd)}")
    log("[build] flash backward bf16 tensor-core kernels: " + "; ".join(
        f"{fn[:48]}: {res['registers']} registers, {res['spill_stores']} B spilled"
        for fn, res in sorted(tc_bwd.items())))
    bwd_lib = ops.KERNELS["flash_attention_bwd"].lib()
    log(f"[build] flash backward: all {len(FLASH_BWD_PASSES)} kernels built, no spills; shared "
        f"memory per bf16 block at dh=128: dk/dv "
        f"{bwd_lib.repro_flash_attention_bwd_smem_bytes(0, 128)} B "
        f"({bwd_lib.repro_flash_attention_bwd_tile(0)}-key tiles, "
        f"{bwd_lib.repro_flash_attention_bwd_tile(2)}-row q steps), dq "
        f"{bwd_lib.repro_flash_attention_bwd_smem_bytes(1, 128)} B "
        f"({bwd_lib.repro_flash_attention_bwd_tile(1)}-row tiles)")
    fa_lib, da_lib = ops.KERNELS["flash_attention"].lib(), ops.KERNELS["decode_attention"].lib()
    ssd_lib = ops.KERNELS["ssd_scan"].lib()
    log(f"[build] shared memory per block at dh=128: flash bf16 "
        f"{fa_lib.repro_flash_attention_smem_bytes(1, 128)} B ({flash_tile()}-key tiles), "
        f"f32 {fa_lib.repro_flash_attention_smem_bytes(0, 128)} B; decode pass 1 (rep=4) "
        f"{da_lib.repro_decode_attention_smem_bytes(4, 128)} B ({decode_split()}-slot splits); "
        f"ssd scan passes A, B, D: "
        f"{', '.join(str(ssd_lib.repro_ssd_scan_smem_bytes(i)) for i in (0, 1, 3))} B")
    log(f"[build] at dh=256: flash bf16 {fa_lib.repro_flash_attention_smem_bytes(1, 256)} B "
        f"({fa_lib.repro_flash_attention_col_parts(256)} warps a row group, one a column half), "
        f"f32 {fa_lib.repro_flash_attention_smem_bytes(0, 256)} B; backward bf16 dk/dv "
        f"{bwd_lib.repro_flash_attention_bwd_smem_bytes(0, 256)} B, dq "
        f"{bwd_lib.repro_flash_attention_bwd_smem_bytes(1, 256)} B "
        f"({bwd_lib.repro_flash_attention_bwd_col_parts(256)} blocks a tile, one a column half); "
        f"decode pass 1 (rep=1) {da_lib.repro_decode_attention_smem_bytes(1, 256)} B")


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
    t = flash_times(q, k, v, "[flash]")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:36", "dh256": flash_256(),
            "max_abs_err": worst, "tolerance": "1e-5 + 2^-7 |plain| (bf16)",
            "tolerance_ratio": worst_ratio, "control_ratio": ctrl,
            "library_tolerance_ratio": lib_ratio, **t,
            "shape": f"B={b} S={s} H={h} KV={kv} dh={dh} bf16 causal"}


def bound(flops: int, nbytes: int, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time of a call, the larger of its operations at the card's
    peak for their type and its bytes at the memory rate, and which binds."""
    by_ops = flops / peak_flops > nbytes / PEAK_HBM_BYTES
    return {"bound_ms": max(flops / peak_flops, nbytes / PEAK_HBM_BYTES) * 1e3,
            "bound_by": "operations" if by_ops else "bytes"}


def flash_times(q, k, v, tag: str) -> dict:
    """The bf16 flash kernel, its plain version and SDPA (the yardstick) on
    causal q, k, v: CUDA events and device times, the bound, and the FLOPs
    the kernel's tiles execute (derived from the library's tiles and column
    parts, not measured)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t = timings(lambda: fa.flash_attention(q, k, v, causal=True),
                lambda: ref.mha(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True), 12)
    pairs = b * h * s * (s + 1) // 2          # unmasked (query, key) pairs
    flops = 4 * pairs * dh                    # QK^T and PV, two FLOPs per multiply-add
    nbytes = 2 * (2 * b * s * h * dh + 2 * b * s * kv * dh)
    t.update(bound(flops, nbytes))
    # every whole q x kv tile the kernel visits (q tile a multiple of the kv
    # tile, so causal tiles end on the diagonal): S once for each column
    # part, P.V twice (P split into a bf16 high and low part)
    bq, bk = flash_q_tile(), flash_tile()
    if bq % bk:
        raise AssertionError(f"{tag} q tile {bq} not a multiple of the kv tile {bk}")
    parts = fa.KERNEL.lib().repro_flash_attention_col_parts(dh)
    kv_tiles = sum(-(-min(s, (i + 1) * bq) // bk) for i in range(-(-s // bq)))
    executed = (parts + 2) * 2 * b * h * kv_tiles * bq * bk * dh
    dev_ms = t["device_ms"] or t["ms"]
    log(f"{tag} {t['ms']:.3f} ms kernel, {t['plain_ms']:.3f} ms plain, {t['library_ms']:.3f} ms "
        f"sdpa (CUDA events; device time {t['device_ms']} / {t['plain_device_ms']} / "
        f"{t['library_device_ms']}), bound {t['bound_ms']:.4f} ms ({flops / 1e9:.1f} GFLOP "
        f"needed, {nbytes / 1e6:.1f} MB); {flops / dev_ms / 1e9:.1f} TFLOP/s needed, "
        f"{100 * t['bound_ms'] / dev_ms:.1f} % of the bound (device time)")
    log(f"{tag} derived from the kernel's {bq}x{bk} tiles, S once for each of {parts} column "
        f"part(s) and P.V twice, not measured: {executed / 1e9:.1f} GFLOP on the tensor cores, "
        f"{executed / dev_ms / 1e9:.1f} TFLOP/s at the device time")
    return t


def upper_half_zeroed(t):
    """A planted fault of a column split: the last dim's columns from half
    its width on (128-255 at dh 256) never written."""
    t = t.clone()
    t[..., t.shape[-1] // 2:] = 0
    return t


def flash_bwd_times(q, k, v, o, lse, do, tag: str) -> dict:
    """The bf16 flash backward, its plain version and SDPA's backward (the
    yardstick) on causal inputs: CUDA events and device times, the device
    time of each of its kernels, the bound, and the FLOPs its tiles execute
    (derived from the library's tiles and column parts, not measured)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    t = timings(lambda: fab.flash_attention_bwd(q, k, v, o, lse, do),
                lambda: ref.mha_bwd(q, k, v, o, lse, do),
                lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True), 6)
    passes = device_ms_by_kernel(lambda: fab.flash_attention_bwd(q, k, v, o, lse, do), 4)
    t["pass_device_ms"] = {k_: sum(v_ for key, v_ in passes.items() if k_ in key)
                           for k_ in FLASH_BWD_PASSES}
    log(f"{tag} device ms per call by kernel: "
        + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in t["pass_device_ms"].items()))
    pairs = b * h * s * (s + 1) // 2           # unmasked (query, key) pairs
    flops = 10 * pairs * dh                    # S again, dP, dV, dK, dQ: 2.5x the forward
    nbytes = 2 * (4 * b * s * h * dh + 4 * b * s * kv * dh) + 4 * b * h * s
    t.update(bound(flops, nbytes))
    dev_ms = t["device_ms"] or t["ms"]
    log(f"{tag} {t['ms']:.3f} ms kernel, {t['plain_ms']:.3f} ms plain, "
        f"{t['library_ms']:.3f} ms sdpa backward (CUDA events; device time {t['device_ms']} / "
        f"{t['plain_device_ms']} / {t['library_device_ms']}), bound {t['bound_ms']:.4f} ms "
        f"({flops / 1e9:.1f} GFLOP needed, {nbytes / 1e6:.1f} MB); "
        f"{flops / dev_ms / 1e9:.1f} TFLOP/s needed, {100 * t['bound_ms'] / dev_ms:.2f} % of the "
        f"bound (device time)")
    executed = flash_bwd_executed_flops(b, s, h, kv, dh)
    log(f"{tag} derived from the kernels' tiles, not measured: {executed / 1e9:.1f} GFLOP "
        f"on the tensor cores ({executed / flops:.2f}x the {flops / 1e9:.1f} needed: the dq pass "
        f"recomputes S and dP, P and dS are split hi + lo, S and dP once for each column part), "
        f"{executed / dev_ms / 1e9:.1f} TFLOP/s at the device time")
    return t


def decode_times(q, kc, vc, valid, tag: str) -> dict:
    """The bf16 flash-decode kernel, its plain version and SDPA (the
    yardstick): CUDA events and device times, and the bound of the K/V that
    this run's mask lets through."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    b, c, kv, dh = kc.shape
    h = q.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
    am = valid[:, None, None, :]
    t = timings(lambda: da.decode_attention(q, kc, vc, valid),
                lambda: ref.decode_attention(q, kc, vc, valid),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                                       enable_gqa=True), 40)
    n_valid = int(valid.sum().item())          # slots this run's mask lets through
    nbytes = 2 * n_valid * kv * dh * 2 + 2 * (2 * b * h * dh) + b * c
    t.update(bound(4 * n_valid * h * dh, nbytes))
    dev_ms = t["device_ms"] or t["ms"]
    log(f"{tag} {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms plain, {t['library_ms']:.4f} ms "
        f"sdpa (CUDA events; device time {t['device_ms']} / {t['plain_device_ms']} / "
        f"{t['library_device_ms']}), bound {t['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB); "
        f"{nbytes / dev_ms / 1e6:.0f} GB/s achieved, {100 * t['bound_ms'] / dev_ms:.1f} % of the "
        f"bound (device time)")
    return t


def flash_256() -> dict:
    """The bf16 flash kernel at gemma-7b's prefill shape (B=1 S=4096, 16 heads
    on 16 kv heads, dh 256, causal): held to ``ref.mha``; two planted faults
    of its column split (the output's columns 128-255 zeroed, S from the first
    128 dims only) must fail the same check; times beside the bound, the
    plain version and SDPA."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, s, (h, kv, dh) = 1, 4096, GEMMA_ATTN
    shape = f"B={b} S={s} H={h} KV={kv} dh={dh} bf16 causal"
    q, k, v = flash_case(b, s, h, kv, dh, torch.bfloat16, seed=21)
    want = ref.mha(q, k, v, causal=True)
    got = fa.flash_attention(q, k, v, causal=True)
    err, ratio = hold(f"[flash dh256] gemma-7b shape {shape}", got, want)
    ctrl = min(control("[flash dh256] control: the kernel's output with columns 128-255 zeroed",
                       upper_half_zeroed(got), want),
               control("[flash dh256] control: plain with S from the first 128 dims only",
                       ref.mha(upper_half_zeroed(q), k, v, causal=True, scale=dh ** -0.5), want))
    return {"shape": shape, "max_abs_err": err, "tolerance_ratio": ratio, "control_ratio": ctrl,
            **flash_times(q, k, v, "[flash dh256]")}


def flash_bwd_256() -> dict:
    """The bf16 flash backward at gemma-7b's training shape (B=1 S=4096, 16
    heads on 16 kv heads, dh 256, causal): dq, dk and dv held to
    ``ref.mha_bwd``; the planted faults of its column split (each gradient's
    columns 128-255 zeroed; the gradients of attention whose S sees the
    first 128 dims only) must fail the same check; times beside the bound,
    the plain version and SDPA's backward."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    b, s, (h, kv, dh) = 1, 4096, GEMMA_ATTN
    shape = f"B={b} S={s} H={h} KV={kv} dh={dh} bf16 causal"
    q, k, v = flash_case(b, s, h, kv, dh, torch.bfloat16, seed=22)
    do = flash_case(b, s, h, kv, dh, torch.bfloat16, seed=32)[0]
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    o_w, lse_w = ref.mha_fwd_lse(q, k, v)
    hold(f"[flash bwd dh256] {shape}: forward o", o, o_w)
    lse_ratio = ref.lse_tolerance_ratio(lse, lse_w)
    log(f"[flash bwd dh256] forward lse {lse_ratio:.4f} of the tolerance")
    if not lse_ratio <= 1:
        raise AssertionError("[flash bwd dh256] the forward's lse disagrees with ref.mha_fwd_lse")
    got = fab.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.mha_bwd(q, k, v, o, lse, do)
    worst, worst_ratio = 0.0, 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, ratio = hold(f"[flash bwd dh256] gemma-7b shape {shape}: {name}", g, w,
                          ref.grad_tolerance_ratio)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    ctrl = min(control(f"[flash bwd dh256] control: the kernel's {name} with columns 128-255 "
                       f"zeroed", upper_half_zeroed(g), w, ref.grad_tolerance_ratio)
               for name, g, w in zip(("dq", "dk", "dv"), got, want))
    del got
    qh = upper_half_zeroed(q)
    s_half = ref.mha_bwd(qh, k, v, *ref.mha_fwd_lse(qh, k, v, scale=dh ** -0.5), do,
                         scale=dh ** -0.5)
    s_ratio = max(ref.grad_tolerance_ratio(g, w) for g, w in zip(s_half, want))
    log(f"[flash bwd dh256] control: plain with S from the first 128 dims only: worst of dq, dk, "
        f"dv {s_ratio:.1f} x the tolerance (must exceed 1)")
    if not s_ratio > 1:
        raise AssertionError("[flash bwd dh256]: the tolerance does not see S from 128 dims")
    del s_half, want
    return {"shape": shape, "max_abs_err": worst, "tolerance_ratio": worst_ratio,
            "control_ratio": min(ctrl, s_ratio), "forward_lse_tolerance_ratio": lse_ratio,
            **flash_bwd_times(q, k, v, o, lse, do, "[flash bwd dh256]")}


def decode_256() -> dict:
    """The bf16 flash-decode kernel at gemma-7b's decode shape (B=8, a full
    4096-slot cache, 16 heads on 16 kv heads, dh 256): held to
    ``ref.decode_attention``; the output's columns 128-255 zeroed and S from
    the first 128 dims only must fail the same check; times beside the
    bound, the plain version and SDPA."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    b, c, (h, kv, dh) = 8, 4096, GEMMA_ATTN
    shape = f"B={b} C={c} H={h} KV={kv} dh={dh} bf16, all slots valid"
    q, kc, vc, valid = decode_inputs(b, c, h, kv, dh, torch.bfloat16, "all", seed=23)
    want = ref.decode_attention(q, kc, vc, valid)
    got = da.decode_attention(q, kc, vc, valid)
    err, ratio = hold(f"[decode dh256] gemma-7b shape {shape}", got, want)
    ctrl = min(control("[decode dh256] control: the kernel's output with columns 128-255 zeroed",
                       upper_half_zeroed(got), want),
               control("[decode dh256] control: plain with S from the first 128 dims only",
                       ref.decode_attention(upper_half_zeroed(q), kc, vc, valid,
                                            scale=dh ** -0.5), want))
    return {"shape": shape, "max_abs_err": err, "tolerance_ratio": ratio, "control_ratio": ctrl,
            **decode_times(q, kc, vc, valid, "[decode dh256]")}


def flash_bwd_faults(q, k, v, o, lse, do, want):
    """Three planted faults of the backward, emulated in the plain version:
    one key tile's dk/dv dropped, one q tile's dq dropped, and one q tile's
    share of every dk/dv dropped (its rows of do zeroed).  Returns
    [(label, gradient, the plain version's)]."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    lib = fab.KERNEL.lib()
    bk, bq, step = (lib.repro_flash_attention_bwd_tile(i) for i in range(3))
    s = q.shape[1]
    dk, dq = want[1].clone(), want[0].clone()
    dk[:, s // 2:s // 2 + bk] = 0
    dq[:, s // 2:s // 2 + bq] = 0
    do_f = do.clone()
    do_f[:, s // 2:s // 2 + step] = 0
    _, dk_q, _ = ref.mha_bwd(q, k, v, o, lse, do_f, causal=True)
    return [(f"one {bk}-key tile's dk dropped", dk, want[1]),
            (f"one {bq}-row tile's dq dropped", dq, want[0]),
            (f"one {step}-row q tile's share of every dk dropped", dk_q, want[1])]


def flash_bwd_executed_flops(b, s, h, kv, dh) -> int:
    """Derived, not measured: the tensor-core FLOPs of every whole tile pair
    the bf16 backward kernels visit at a causal shape with no window (tile
    sizes and column parts from the library, dh padded to the kernel's 64,
    128 or 256): (4 parts + 8) dh_pad a (query, key) pair in dk/dv (S^T and
    dP^T once for each column part, dv and dk each twice: P and dS split hi +
    lo) and (4 parts + 4) dh_pad in dq (S and dP for each part, dq twice)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    lib = fab.KERNEL.lib()
    bk, bq_dq, bq_kv = (lib.repro_flash_attention_bwd_tile(i) for i in range(3))
    parts = lib.repro_flash_attention_bwd_col_parts(dh)
    dhp = 64 if dh <= 64 else 128 if dh <= 128 else 256
    n_q = -(-s // bq_kv)
    kv_pairs = sum(n_q - (kt * bk) // bq_kv for kt in range(-(-s // bk))) * (h // kv)
    dq_pairs = sum(-(-min(s, (qt + 1) * bq_dq) // bk) for qt in range(-(-s // bq_dq)))
    return b * (kv * kv_pairs * bk * bq_kv * (4 * parts + 8)
                + h * dq_pairs * bq_dq * bk * (4 * parts + 4)) * dhp


def phase_flash_bwd():
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    bf16, f32 = torch.bfloat16, torch.float32
    worst, worst_ratio, lse_worst = 0.0, 0.0, 0.0
    for b, s, h, kv, dh, dtype, window, seed in [
            (1, 4096, 32, 8, 120, bf16, None, 1),   # the training path's shape
            (1, 4096, 32, 8, 120, bf16, 512, 2),    # a binding window
            (1, 1000, 32, 8, 120, f32, None, 3)]:   # f32, ragged S
        q, k, v = flash_case(b, s, h, kv, dh, dtype, seed=seed)
        do = flash_case(b, s, h, kv, dh, dtype, seed=seed + 10)[0]
        label = f"[flash bwd] B={b} S={s} H={h} KV={kv} dh={dh} {dtype} window={window}"
        o, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
        o_w, lse_w = ref.mha_fwd_lse(q, k, v, window=window)
        hold(f"{label}: forward o", o, o_w)
        lse_ratio = ref.lse_tolerance_ratio(lse, lse_w)
        log(f"{label}: forward lse max_abs_err {max_err(lse, lse_w):.3g}, {lse_ratio:.4f} of "
            f"the tolerance (1e-5 of max(1, |lse|))")
        if not lse_ratio <= 1:
            raise AssertionError(f"{label}: the forward's lse disagrees with ref.mha_fwd_lse")
        lse_worst = max(lse_worst, lse_ratio)
        got = fab.flash_attention_bwd(q, k, v, o, lse, do, window=window)
        want = ref.mha_bwd(q, k, v, o, lse, do, window=window)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, ratio = hold(f"{label}: {name}", g, w, ref.grad_tolerance_ratio)
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        del got
    # the main path's shape again: controls, times, bound
    b, s, h, kv, dh = 1, 4096, 32, 8, 120
    q, k, v = flash_case(b, s, h, kv, dh, bf16, seed=1)
    do = flash_case(b, s, h, kv, dh, bf16, seed=11)[0]
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    want = ref.mha_bwd(q, k, v, o, lse, do)
    faults = flash_bwd_faults(q, k, v, o, lse, do, want)
    ctrl = min(control(f"[flash bwd] control: {label}", fault, w, ref.grad_tolerance_ratio)
               for label, fault, w in faults)
    # the bound the training phase holds each in-model launch to
    head_rms = {label: ref.head_rel_rms(fault, w) for label, fault, w in faults}
    kernel_rms = max(ref.head_rel_rms(g, w) for g, w in
                     zip(fab.flash_attention_bwd(q, k, v, o, lse, do), want))
    log(f"[flash bwd] worst (batch, head) relative RMS: kernel {kernel_rms:.3g}; controls "
        + ", ".join(f"{label} {r:.3g}" for label, r in head_rms.items())
        + f" (limit {ref.HEAD_RMS_LIMIT:.4g}: the kernel within, each control beyond)")
    if not kernel_rms <= ref.HEAD_RMS_LIMIT < min(head_rms.values()):
        raise AssertionError(f"[flash bwd] head RMS bound: kernel {kernel_rms}, controls {head_rms}")
    del want, faults
    t = flash_bwd_times(q, k, v, o, lse, do, "[flash bwd]")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:140", "dh256": flash_bwd_256(),
            "max_abs_err": worst,
            "tolerance": "dq, dk, dv: 1e-5 + 2^-7 |plain| (bf16), 1e-4 (f32)",
            "tolerance_ratio": worst_ratio, "control_ratio": ctrl,
            "forward_lse_tolerance_ratio": lse_worst, "head_rel_rms": kernel_rms,
            "control_head_rel_rms": min(head_rms.values()), **t,
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
    t = decode_times(q, kc, vc, valid, "[decode]")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:29", "dh256": decode_256(),
            "max_abs_err": worst, "tolerance": "1e-5 + 2^-7 |plain| (bf16)",
            "tolerance_ratio": worst_ratio, "control_ratio": ctrl,
            "library_tolerance_ratio": lib_ratio, **t,
            "shape": f"B={b} C={c} H={h} KV={kv} dh={dh} bf16, all slots valid"}


def _first_periods(params, n: int):
    """The same weights cut to the first ``n`` periods (views, no copies)."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[:n]
    return dict(params, layers=[cut(lp) for lp in params["layers"]])


@contextlib.contextmanager
def recorded_routing(routes: list):
    """Append the routed expert ids [G,T,K] of every MoE layer that runs to
    ``routes`` (a swap only this script makes, as ``swapped_ops``)."""
    from repro_torch.models import moe
    topk = moe.router_topk

    def recording(logits, m, generator=None):
        gates, idx, probs = topk(logits, m, generator)
        routes.append(idx)
        return gates, idx, probs
    moe.router_topk = recording
    try:
        yield
    finally:
        moe.router_topk = topk


@contextlib.contextmanager
def replayed_routing(routes: list, own: list = None):
    """Route the MoE layers, in the order they run, to the experts of
    ``routes`` (as ``recorded_routing`` recorded them), with the gates taken
    from this run's own probabilities (a swap only this script makes).
    ``own``: where given, each layer's own choice is appended to it."""
    from repro_torch.models import moe
    topk, replay = moe.router_topk, iter(routes)

    def replaying(logits, m, generator=None):
        _, mine, probs = topk(logits, m, generator)
        if own is not None:
            own.append(mine)
        idx = next(replay)
        vals = probs.gather(-1, idx)
        return vals / vals.sum(-1, keepdim=True).clamp(min=1e-9), idx, probs
    moe.router_topk = replaying
    try:
        yield
    finally:
        moe.router_topk = topk


def routing_agreement(cfg, got: list, want: list):
    """Two runs' routing, layer by layer: (the share of (token, k) choices
    in ``got`` that ``want`` did not make, a mask [G,T] of the tokens whose
    chosen experts and whose experts within capacity agree at every layer)."""
    import torch
    from repro_torch.models import moe
    e = cfg.moe.n_experts
    if len(got) != len(want) or not got:
        raise AssertionError(f"routing recorded for {len(got)} and {len(want)} MoE layers")
    differ, agree = 0, torch.ones(got[0].shape[:2], dtype=torch.bool, device=got[0].device)

    def sets(idx):
        kept = moe.choice_positions(idx, e) < moe.moe_capacity(cfg.moe, idx.shape[1])
        zeros = torch.zeros(idx.shape[:2] + (e,), dtype=torch.bool, device=idx.device)
        return zeros.scatter(-1, idx, True), zeros.scatter(-1, idx, kept)
    for a, b in zip(got, want):
        (ca, ka), (cb, kb) = sets(a), sets(b)
        differ += int((ca & ~cb).sum().item())
        agree &= (ca == cb).all(-1) & (ka == kb).all(-1)
    return differ / sum(a.numel() for a in got), agree


def moe_prefill_depth2(cfg2, p2, tokens, tag: str) -> dict:
    """Depth 2 of an MoE model: the logits through the kernels, the plain
    versions and two planted faults, with each run's routing recorded.  A
    one-ulp difference of the kernels can flip a near-tie among the experts,
    and a flipped token's logits then differ by far more than the limit: so
    the share of flipped (token, k) choices is held to ``MOE_FLIP_LIMIT``,
    and the logits are compared over the tokens whose routing agrees at both
    layers."""
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as tf

    def run(ctx=None):
        routes = []
        with recorded_routing(routes), (ctx or contextlib.nullcontext()):
            logits = tf.lm_forward(p2, {"tokens": tokens}, cfg2)[0]
        return logits, routes
    got, r_got = run()
    want, r_want = run(plain_ops())
    flips, agree = routing_agreement(cfg2, r_got, r_want)
    n_agree = int(agree.sum().item())
    want_a = want[agree]
    rel, rel_all = position_rel_rms(got[agree], want_a), position_rel_rms(got, want)
    del got
    shifted = position_rel_rms(run(shifted_heads_ops())[0][agree], want_a)
    tile = flash_tile()
    dropped = position_rel_rms(run(swapped_ops(mha=lambda q, k, v, **kw: ref.mha(
        q, k, v, kv_valid_len=k.shape[1] - tile, **kw)))[0][agree], want_a)
    log(f"[{tag}] depth 2, full width, {tokens.shape[1]} positions: routed (token, k) choices "
        f"through the kernels that the plain versions did not make {100 * flips:.4f} % (limit "
        f"{100 * MOE_FLIP_LIMIT:.0f} %); {n_agree} positions route alike at both layers; "
        f"worst relative RMS of the logits over those, kernels vs plain {rel:.3g} (limit "
        f"{MODEL_LIMIT}; over all positions {rel_all:.3g}, reported); controls over the same "
        f"positions: heads shifted {shifted:.3g}, last {tile}-key tile dropped {dropped:.3g} "
        f"(both must exceed the limit)")
    if not (flips <= MOE_FLIP_LIMIT and rel <= MODEL_LIMIT < min(shifted, dropped)):
        raise AssertionError(f"depth-2 MoE prefill: flips {flips}, kernels {rel}, controls "
                             f"{shifted}, {dropped}")
    return {"prefill_depth2_routing_flips": flips, "prefill_depth2_positions_agreeing": n_agree,
            "prefill_depth2_rel_rms": rel, "prefill_depth2_rel_rms_all_positions": rel_all,
            "prefill_depth2_shifted_heads": shifted, "prefill_depth2_tile_dropped": dropped}


def hybrid_prefill_check(cfg8, p8, tokens, tag: str) -> dict:
    """One whole period of a hybrid (Mamba-2, attention and MoE layers): the
    logits through the kernels against the plain versions routed as the
    kernels routed.  Unlike attention, the scan carries a token whose
    routing flipped into the state of every later token, so comparing over
    the tokens routed alike (``moe_prefill_depth2``) still compares tokens
    that a flip upstream moved; it is reported.  The flips held to
    ``MOE_FLIP_LIMIT`` are the plain router's own choices in the replayed
    run against the kernels' (the kernels' arithmetic at each MoE layer,
    with no flip upstream).  The planted faults run on the plain versions
    routed as the kernels routed too: every chunk's entering state dropped
    and the kv heads shifted must not match; the last KV tile dropped is
    reported (it moves the last 64 positions of one attention layer of 8,
    within the kernels' own difference here; each flash launch is held to
    its plain version above)."""
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as tf

    def logits():
        return tf.lm_forward(p8, {"tokens": tokens}, cfg8)[0]
    r_got, r_plain, r_own = [], [], []
    with recorded_routing(r_got):
        got = logits()
    with plain_ops(), recorded_routing(r_plain):
        plain = logits()
    flips_free, agree = routing_agreement(cfg8, r_got, r_plain)
    rel_alike = position_rel_rms(got[agree], plain[agree])
    del plain
    with plain_ops(), replayed_routing(r_got, r_own):
        want = logits()
    flips, _ = routing_agreement(cfg8, r_own, r_got)
    rel = position_rel_rms(got, want)
    del got
    tile = flash_tile()
    faults = {}
    for key, ctx in (("chunks_independent", lambda: swapped_ops(ssd=ssd_chunks_independent)),
                     ("shifted_heads", shifted_heads_ops),
                     ("tile_dropped", lambda: swapped_ops(mha=lambda q, k, v, **kw: ref.mha(
                         q, k, v, kv_valid_len=k.shape[1] - tile, **kw)))):
        with plain_ops(), ctx(), replayed_routing(r_got):
            faults[key] = position_rel_rms(logits(), want)
    log(f"[{tag}] {cfg8.n_layers} layers, full width, {tokens.shape[1]} positions, the plain "
        f"versions routed as the kernels routed: (token, k) choices of the plain router that "
        f"the kernels did not make {100 * flips:.4f} % (limit {100 * MOE_FLIP_LIMIT:.0f} %); "
        f"worst position's relative RMS of the logits, kernels vs plain {rel:.3g} (limit "
        f"{MODEL_LIMIT}); controls on the plain versions: every chunk's entering state "
        f"dropped {faults['chunks_independent']:.3g}, kv heads shifted "
        f"{faults['shifted_heads']:.3g} (each must exceed the limit), last {tile}-key tile "
        f"dropped {faults['tile_dropped']:.3g} (reported)")
    log(f"[{tag}] routed freely (reported): choices that differ {100 * flips_free:.4f} %, "
        f"{int(agree.sum())} positions route alike at every MoE layer, worst relative RMS over "
        f"those {rel_alike:.3g}")
    if not (flips <= MOE_FLIP_LIMIT and rel <= MODEL_LIMIT
            < min(faults["chunks_independent"], faults["shifted_heads"])):
        raise AssertionError(f"hybrid prefill check: flips {flips}, kernels {rel}, controls "
                             f"{faults}")
    return {"prefill_period_replayed_flips": flips, "prefill_period_rel_rms": rel,
            "prefill_period_chunks_independent": faults["chunks_independent"],
            "prefill_period_shifted_heads": faults["shifted_heads"],
            "prefill_period_tile_dropped": faults["tile_dropped"],
            "prefill_period_free_flips": flips_free,
            "prefill_period_free_positions_alike": int(agree.sum()),
            "prefill_period_free_rel_rms_alike": rel_alike}


def prefill_flops(cfg, s: int) -> tuple:
    """(needed, executed) model FLOPs of a B=1 prefill: the projections,
    causal attention, dense FFNs, the last position's logits and, in an MoE
    model, the router, the routed experts (the K a token chooses; executed:
    every expert's buffer padded to its capacity) and shared experts; a
    Mamba-2 layer's in- and out-projections (its scan is not counted).
    Derived from the shapes, not measured."""
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.moe import moe_capacity
    d = cfg.d_model
    n_attn, n_ssm = n_mixers(cfg)
    n_moe = sum(cfg.layer_has_moe(i) for i in range(cfg.n_layers))
    common = (cfg.n_layers - n_moe) * 2 * s * 3 * d * cfg.d_ff + 2 * d * padded_vocab(cfg)
    if n_attn:
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        common += n_attn * (2 * s * d * (2 * h + 2 * kv) * dh + 4 * h * dh * s * (s + 1) // 2)
    if n_ssm:
        e = cfg.ssm.expand * d
        heads, gn = e // cfg.ssm.head_dim, cfg.ssm.n_groups * cfg.ssm.state_dim
        common += n_ssm * (2 * s * d * (2 * e + 2 * gn + heads) + 2 * s * e * d)
    if not n_moe:
        return common, common
    m = cfg.moe
    de = m.d_expert if m.d_expert is not None else cfg.d_ff
    common += n_moe * (2 * s * d * m.n_experts + 2 * s * 3 * d * de * m.n_shared_experts)
    expert = 2 * 3 * d * de
    return (common + n_moe * s * m.top_k * expert,
            common + n_moe * m.n_experts * moe_capacity(m, s) * expert)


def phase_prefill(cfg, params, tag: str = "prefill", prefix: str = ""):
    """Prefill at B=1 S=4096; the result's keys start with ``prefix``.  Each
    attention layer launches the flash kernel once, each Mamba-2 layer the
    SSD scan.  The check of the logits is at depth 2 (a dense model; an MoE
    one with its routing recorded), or over one whole period of a hybrid's
    pattern (its faults: every chunk's entering state dropped, the last KV
    tile dropped)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import padded_vocab
    from repro_torch.serve.step import ServeSetup, make_prefill_step
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, 4096), generator=gen, device="cuda")
    step = make_prefill_step(ServeSetup(cfg=cfg), (1, 1), params)
    n_attn, n_ssm = n_mixers(cfg)
    want_counts = {**NO_LAUNCHES, "flash_attention": n_attn, "ssd_scan": n_ssm}
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        if counts != want_counts:
            raise AssertionError(f"prefill launches {counts}, want {want_counts}")
    if logits.shape != (1, 1, padded_vocab(cfg)) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite/shaped")
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers B=1 S=4096: {times[0]:.1f} ms first, "
        f"{times[1]:.1f} ms second; flash launches {counts['flash_attention']}"
        + (f", ssd launches {counts['ssd_scan']}" if n_ssm else ""))
    busy, dev = device_profile(lambda: step(params, {"tokens": tokens}), f"{tag} B=1 S=4096")
    if dev:
        needed, executed = prefill_flops(cfg, tokens.shape[1])
        dev_ms = sum(dev.values())
        log(f"[{tag}] model FLOPs, derived from the shapes, not measured: {needed / 1e12:.2f} T "
            f"needed, {executed / 1e12:.2f} T executed"
            + (" (each expert's buffer padded to its capacity)" if cfg.moe else "")
            + ("; the SSD scan's FLOPs not counted" if n_ssm else "")
            + f"; at the device time {dev_ms:.2f} ms, {needed / dev_ms / 1e9:.1f} TFLOP/s "
            f"needed, {100 * needed / (dev_ms / 1e3) / PEAK_BF16_FLOPS:.1f} % of the bf16 peak")
        for label, keys in (("flash", ("flash_fwd_kernel",)), ("ssd", SSD_PASSES)):
            part = sum(v for key, v in dev.items() if any(k in key for k in keys))
            if part:
                log(f"[{tag}] {label} kernels {part:.2f} ms of {dev_ms:.2f} ms device time "
                    f"({100 * part / dev_ms:.1f} %)")

    # every launch of a full prefill, held against the plain version on its own inputs
    ratios = []
    with checked_ops(ratios):
        step(params, {"tokens": tokens})
    log(f"[{tag}] {cfg.n_layers} layers: each launch against its plain version on the same "
        f"inputs (flash: ref.mha, ssd: ref.ssd_chunked): worst {max(ratios):.4f} of the "
        f"tolerance over {len(ratios)} launches")
    if len(ratios) != n_attn + n_ssm or not max(ratios) <= 1:
        raise AssertionError(f"prefill: a launch disagrees with its plain version: {ratios}")
    out = {"flash_launches": counts["flash_attention"], "ssd_launches": counts["ssd_scan"],
           "prefill_calls": 1, "prefill_ms": times[1], "prefill_first_ms": times[0],
           "prefill_device_busy": busy, "prefill_worst_ratio": max(ratios)}
    if dev:
        out.update(prefill_device_ms=sum(dev.values()), prefill_model_flops=needed)

    if n_ssm:  # a hybrid: one whole period of its pattern, routed as the kernels routed
        out.update(hybrid_prefill_check(cfg.replace(n_layers=len(tf.period_spec(cfg))),
                                        _first_periods(params, 1), tokens, tag))
        return {prefix + k: v for k, v in out.items()}

    # depth 2, full width: logits at every position through the kernels, the
    # plain versions and two planted faults
    cfg2 = cfg.replace(n_layers=2)
    p2 = _first_periods(params, 2)
    if cfg.moe:
        out.update(moe_prefill_depth2(cfg2, p2, tokens, tag))
        return {prefix + k: v for k, v in out.items()}

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
    log(f"[{tag}] depth 2, full width, all 4096 positions, worst position's relative RMS "
        f"of the logits: kernels vs plain {rel:.3g} (limit {MODEL_LIMIT}); controls: "
        f"heads shifted {shifted:.3g}, last {tile}-key tile dropped {dropped:.3g} "
        f"(both must exceed the limit)")
    if not rel <= MODEL_LIMIT < min(shifted, dropped):
        raise AssertionError(f"depth-2 prefill: kernels {rel}, controls {shifted}, {dropped}")
    out.update({"prefill_depth2_rel_rms": rel, "prefill_depth2_shifted_heads": shifted,
                "prefill_depth2_tile_dropped": dropped})
    return {prefix + k: v for k, v in out.items()}


def fill_cache(state, n: int, seed: int) -> None:
    """Random K/V in the first ``n`` slots of every attention layer, as if
    ``n`` tokens had been decoded, and every later slot empty (a Mamba-2
    layer's state keeps what it has)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for c in state:
        if "k" not in c:
            continue
        c["k"][:, :, :n].normal_(generator=gen)
        c["v"][:, :, :n].normal_(generator=gen)
        c["slot_pos"].fill_(-1)
        c["slot_pos"][:, :n] = torch.arange(n, dtype=c["slot_pos"].dtype, device="cuda")


def decode_steps(cfg, step, params, state, first: int, n: int, tok, forced_tokens=None):
    """``n`` steps of ``step`` from position ``first``, teacher-forced on the
    columns of ``forced_tokens`` while they last, then greedy; each step must
    launch the flash-decode kernel once per attention layer.  ``state`` is
    updated in place.  Returns (seconds, the logits of each step, decode
    launches)."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = []
    t0 = time.perf_counter()
    for i in range(n):
        if forced_tokens is not None and i < forced_tokens.shape[1]:
            tok = forced_tokens[:, i:i + 1]
        logits, _ = step(params, state, tok, first + i)
        out.append(logits)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_attn = n_mixers(cfg)[0]
    if counts != {**NO_LAUNCHES, "decode_attention": n_attn * n}:
        raise AssertionError(f"decode launches {counts}, want {n_attn * n} decode")
    if not torch.isfinite(logits).all():
        raise AssertionError("decode logits not finite")
    return secs, out, counts["decode_attention"]


def dense_decode_depth2(cfg, params, prompt, cap: int, tag: str) -> tuple:
    """Depth 2, full width: the cache built token by token through the
    kernel must give the logits of every teacher-forced position that the
    plain version and the prefill give; a planted fault (heads shifted) must
    not.  Returns (vs plain, vs prefill, the fault's)."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import ServeSetup, init_serve_state
    cfg2 = cfg.replace(n_layers=2)
    p2 = _first_periods(params, 2)
    b, n = prompt.shape

    def forced_logits():
        st = init_serve_state(ServeSetup(cfg=cfg2), (1, 1), p2, b, cap)
        out = []
        for t in range(n):
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
    log(f"[{tag}] depth 2, full width, {b}x{n} positions, worst position's relative "
        f"RMS of the logits: kernel vs plain {e_plain:.3g}, vs prefill {e_pre:.3g} (limit "
        f"{MODEL_LIMIT}); control: heads shifted {shifted:.3g} (must exceed the limit)")
    if not (e_plain <= MODEL_LIMIT and e_pre <= MODEL_LIMIT < shifted):
        raise AssertionError(f"depth-2 decode: {e_plain} / {e_pre}, control {shifted}")
    return e_plain, e_pre, shifted


def phase_decode(cfg, params):
    import torch
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
        return decode_steps(cfg, step, params, state, first, n, tok, forced_tokens)

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

    e_plain, e_pre, shifted = dense_decode_depth2(cfg, params, prompt, cap, "decode")

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


def decode_floor_ms(cfg, params, state, n_valid: int) -> float:
    """The least device time of one decode step: every parameter read once
    (all of them: at one token a group every expert of an MoE layer gets a
    buffer) but an untied embedding table, of which a step gathers B rows (a
    tied one is read whole as the unembedding), the K/V of the ``n_valid``
    valid slots of every attention layer's cache, and every Mamba-2 layer's
    conv window and state, at the card's memory rate."""
    from repro_torch.tree import leaves
    weights = sum(t.numel() * t.element_size() for t in leaves(params))
    if not cfg.tie_embeddings:
        weights -= params["embed"].numel() * params["embed"].element_size()
    kv = sum(c[name][:, :, :n_valid].numel() * c[name].element_size()
             for c in state if "k" in c for name in ("k", "v"))
    ssm = sum(c[name].numel() * c[name].element_size()
              for c in state if "state" in c for name in ("conv", "state"))
    return (weights + kv + ssm) / PEAK_HBM_BYTES * 1e3


def moe_decode_depth2(cfg, params, prompt, cap: int, n_layers: int = 2) -> dict:
    """Depth 2 (or the ``n_layers`` of a hybrid's whole period), full width:
    the teacher-forced decode logits through the
    kernel against the plain version's (flips held to ``MOE_FLIP_LIMIT``)
    and against the prefill's of the same prompt (at 8 tokens no expert of
    deepseek-moe-16b overflows its capacity of 8, in decode or in prefill,
    so both compute the same function; the prefill's plain attention rounds
    elsewhere, so its flips are reported), each over the positions that,
    with every earlier position of their row, route alike at both layers:
    over 8 tokens a flipped token's second-layer keys and values weigh on
    every later token.  A planted fault (heads shifted) must not match."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import ServeSetup, init_serve_state
    cfg2 = cfg.replace(n_layers=n_layers)
    p2 = _first_periods(params, n_layers // len(tf.period_spec(cfg)))
    b, n = prompt.shape
    n_moe = sum(cfg2.layer_has_moe(i) for i in range(n_layers))

    def forced(ctx=None):
        routes = []
        with recorded_routing(routes), (ctx or contextlib.nullcontext()):
            st = init_serve_state(ServeSetup(cfg=cfg2), (1, 1), p2, b, cap)
            logits = [tf.decode_step(p2, st, prompt[:, t:t + 1], t, cfg2)[0] for t in range(n)]
        # one [B,1,K] an MoE layer and step, in step order: the routes of each
        # MoE layer over the steps
        return torch.cat(logits, 1), [torch.cat(routes[i::n_moe], 1) for i in range(n_moe)]
    got, r_got = forced()
    plain, r_plain = forced(plain_ops())
    r_pre = []
    with recorded_routing(r_pre):
        pre = tf.lm_forward(p2, {"tokens": prompt}, cfg2)[0]
    flips_plain, agree_plain = routing_agreement(cfg2, r_got, r_plain)
    flips_pre, agree_pre = routing_agreement(cfg2, r_got, r_pre)
    agree_plain, agree_pre = (a.cumprod(1).bool() for a in (agree_plain, agree_pre))
    e_plain = position_rel_rms(got[agree_plain], plain[agree_plain])
    e_pre = position_rel_rms(got[agree_pre], pre[agree_pre])
    shifted = position_rel_rms(forced(shifted_heads_ops())[0][agree_plain], plain[agree_plain])
    log(f"[moe decode] {n_layers} layers, full width, {b}x{n} teacher-forced positions: routed "
        f"choices "
        f"that differ from the plain version's {100 * flips_plain:.3f} % (limit "
        f"{100 * MOE_FLIP_LIMIT:.0f} %), from the prefill's {100 * flips_pre:.3f} % (reported); "
        f"worst relative RMS of the logits, kernel vs plain over the {int(agree_plain.sum())} "
        f"positions routed alike up to them {e_plain:.3g}, vs prefill over {int(agree_pre.sum())} "
        f"{e_pre:.3g} (limit {MODEL_LIMIT}); control: heads shifted {shifted:.3g} (must exceed "
        f"the limit)")
    if not (flips_plain <= MOE_FLIP_LIMIT and max(e_plain, e_pre) <= MODEL_LIMIT < shifted):
        raise AssertionError(f"depth-2 MoE decode: flips {flips_plain}, {flips_pre}; "
                             f"{e_plain} / {e_pre}, control {shifted}")
    return {"moe_decode_depth2_flips_vs_plain": flips_plain,
            "moe_decode_depth2_flips_vs_prefill": flips_pre,
            "moe_decode_depth2_positions_vs_plain": int(agree_plain.sum()),
            "moe_decode_depth2_positions_vs_prefill": int(agree_pre.sum()),
            "moe_decode_depth2_rel_rms": e_plain, "moe_decode_depth2_vs_prefill": e_pre,
            "moe_decode_depth2_shifted_heads": shifted}


def phase_decode_ab(cfg, params, tag: str) -> dict:
    """Decode at B=8, capacity 4096: (a) 8 teacher-forced and 8 greedy steps
    from an empty cache, (b) 16 steps with the cache filled to 4064 slots;
    host ms a step, device ms a step (profiler, two steps) beside the floor
    of the bytes a step must read, a depth-2 check (routed for an MoE model),
    and each decode launch of one step held against the plain version.  Log
    lines start with ``[tag]``, result keys with its words joined by _."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import ServeSetup, init_serve_state, make_decode_step
    key = tag.replace(" ", "_") + "_"
    b, cap, n_forced, n_gen = 8, 4096, 8, 8
    setup = ServeSetup(cfg=cfg)
    state = init_serve_state(setup, (1, 1), params, b, cap)
    step = make_decode_step(setup, (1, 1), params, batch=b, capacity=cap)
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (b, n_forced), generator=gen, device="cuda")
    steps = n_forced + n_gen
    out, tok = {}, None
    for label, first, n, forced in (("a", 0, steps, prompt), ("b", cap - 32, 16, None)):
        if label == "b":
            fill_cache(state, first, seed=5)
        secs, logits, launches = decode_steps(cfg, step, params, state, first, n, tok, forced)
        tok = logits[-1].argmax(-1)
        if label == "a":
            want, _ = tf.lm_forward(params, {"tokens": prompt}, cfg)
            deep = position_rel_rms(torch.cat(logits[:n_forced], 1), want)
            del want
        filled = first + n + 1
        busy, dev = device_profile(lambda: decode_steps(cfg, step, params, state, first + n, 2,
                                                        tok),
                                   f"{tag} 2 steps B={b} cap={cap}, {filled} filled slots")
        dev_ms = sum(dev.values()) / 2 if dev else None
        kernel_ms = sum(ms for k_, ms in dev.items() if "decode_partial_kernel" in k_
                        or "decode_combine_kernel" in k_) / 2
        floor = decode_floor_ms(cfg, params, state, filled)
        log(f"[{tag}] ({label}) {cfg.name} B={b} cap={cap}, from {first} filled slots: {n} "
            f"steps, {secs / n * 1e3:.2f} ms/step (host), {b * n / secs:.1f} tok/s; device "
            f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms/step (flash-decode "
            f"{kernel_ms:.3f} ms), floor {floor:.3f} ms/step (every weight and the valid K/V "
            f"read once at {PEAK_HBM_BYTES / 1e12:.2f} TB/s); decode launches {launches}")
        out.update({f"{key}{label}_ms_per_step": secs / n * 1e3,
                    f"{key}{label}_tok_s": b * n / secs,
                    f"{key}{label}_device_ms_per_step": dev_ms,
                    f"{key}{label}_flash_decode_device_ms_per_step": kernel_ms,
                    f"{key}{label}_floor_ms": floor, f"{key}{label}_device_busy": busy,
                    f"{key}{label}_launches": launches, f"{key}{label}_steps": n})
    log(f"[{tag}] {cfg.n_layers} layers, {b}x{n_forced} teacher-forced positions vs the "
        f"prefill of the prompt: worst position's relative RMS {deep:.3g} (reported, not checked)")
    n_attn, n_ssm = n_mixers(cfg)
    if cfg.moe:  # a hybrid's check takes one whole period of its pattern
        out.update(moe_decode_depth2(cfg, params, prompt, cap,
                                     len(tf.period_spec(cfg)) if n_ssm else 2))
    else:
        e_plain, e_pre, shifted = dense_decode_depth2(cfg, params, prompt, cap, tag)
        out.update({f"{key}depth2_rel_rms": e_plain, f"{key}depth2_vs_prefill": e_pre,
                    f"{key}depth2_shifted_heads": shifted})
    ratios = []
    with checked_ops(ratios):
        step(params, state, tok, cap - 32 + 18)
    log(f"[{tag}] full context: each decode launch of one step against "
        f"ref.decode_attention on the same inputs: worst {max(ratios):.3f} of the tolerance "
        f"over {len(ratios)} launches")
    if len(ratios) != n_attn or not max(ratios) <= 1:
        raise AssertionError(f"{tag}: a launch disagrees with ref.decode_attention: {ratios}")
    return {**out, f"{key}vs_prefill": deep, f"{key}worst_ratio": max(ratios)}


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


def ssd_executed_flops(b, s, h, p, g, n, chunk) -> int:
    """Derived, not measured: the FLOPs the SSD kernel's mma.sync tiles run on
    the tensor cores (csrc/ssd_scan.cu: 16 x 8 x 8 tiles, causal tiles of C
    B^T and of W X only, the state products in passes B and D, each product
    three times for 3xTF32)."""
    nc, up8 = -(-s // chunk), lambda v: -(-v // 8) * 8
    i_tiles = range(0, chunk, 16)
    k_n, k_l, p_tiles, n_tiles = up8(n) // 8, up8(chunk) // 8, -(-p // 8), -(-n // 8)
    cb = sum(sum(1 for j in range(0, chunk, 8) if j <= i + 15) for i in i_tiles) * k_n
    state = -(-p // 16) * n_tiles * k_l
    y = sum(p_tiles * (k_n + min(k_l, (i + 16) // 8)) for i in i_tiles)
    mma = b * nc * (g * cb + h * (2 * state + y))
    return 3 * 2 * 16 * 8 * 8 * mma


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
            (1, 4000, 32, 64, 1, 128, 64, False, False),    # ragged, inside the last segment
            (1, 2048, 32, 64, 1, 128, 64, True, False),     # h_init
            (1, 4096, 128, 64, 1, 16, 64, False, False)]:   # jamba's mixer (generic passes)
        x, dt, a, bm, cm, h0 = ssd_inputs(b, s, h, p, g, n, h_init=h_init)
        y_w, st_w = ref.ssd_chunked(x, dt, a, bm, cm, chunk, h_init=h0)
        if padded:
            sp = -(-s // chunk) * chunk
            y, st = tssd.ssd_scan(*(pad_seq(t, sp) for t in (x, dt)), a,
                                  *(pad_seq(t, sp) for t in (bm, cm)), chunk, h_init=h0)
            y = y[:, :s]
        else:
            y, st = tssd.ssd_scan(x, dt, a, bm, cm, chunk, h_init=h0)
        segs = tssd.plan(b, s, h, p, g, n, chunk).segments
        err, ratio = hold_ssd(f"[ssd] B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk}"
                              f"{' h_init' if h_init else ''}{' zero-padded' if padded else ''}"
                              f" ({segs} segments)", y, st, y_w, st_w)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)

    # the main path's shape: mamba2-370m prefill, one layer
    b, s, h, p, g, n, chunk = 1, 32768, 32, 64, 1, 128, 64
    pl = tssd.plan(b, s, h, p, g, n, chunk)
    x, dt, a, bm, cm, _ = ssd_inputs(b, s, h, p, g, n, seed=1)
    y_w, st_w = ref.ssd_chunked(x, dt, a, bm, cm, chunk)
    y, st = tssd.ssd_scan(x, dt, a, bm, cm, chunk)
    err, ratio = hold_ssd(f"[ssd] main shape B={b} S={s} H={h} P={p} G={g} N={n} "
                          f"chunk={chunk}, strided inputs ({pl.segments} segments of "
                          f"{pl.chunks_per_segment} chunks)", y, st, y_w, st_w)
    worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    del y, st
    at = s // chunk // 2
    edge = pl.chunks_per_segment  # the first chunk of the kernel's second segment
    ctrl = min(control(f"[ssd] control: plain with the state entering chunk {at} dropped",
                       ssd_drop_entering_state(x, dt, a, bm, cm, chunk, at)[0], y_w,
                       ratio_fn=ref.ssd_tolerance_ratio),
               control(f"[ssd] control: plain with the state entering chunk {edge} dropped "
                       f"(the first chunk of a segment)",
                       ssd_drop_entering_state(x, dt, a, bm, cm, chunk, edge)[0], y_w,
                       ratio_fn=ref.ssd_tolerance_ratio),
               control(f"[ssd] control: plain without chunk {at}'s intra-chunk term",
                       ssd_drop_intra(x, dt, a, bm, cm, chunk, at)[0], y_w,
                       ratio_fn=ref.ssd_tolerance_ratio))
    del y_w, st_w
    torch.cuda.empty_cache()
    t = timings(lambda: tssd.ssd_scan(x, dt, a, bm, cm, chunk),
                lambda: ref.ssd_chunked(x, dt, a, bm, cm, chunk), None, 12)
    passes = device_ms_by_kernel(lambda: tssd.ssd_scan(x, dt, a, bm, cm, chunk), 12)
    pass_ms = {k: sum(v for key, v in passes.items() if k in key) for k in SSD_PASSES}
    log("[ssd] device ms per call by pass: "
        + ", ".join(f"{k} {v:.4f}" for k, v in pass_ms.items()))
    nc, L = s // chunk, chunk
    # bytes: each input read once, each output written once (f32)
    nbytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * g * n + b * h * p * n + h)
    # least operations: C B^T once per group and chunk, causal halves, the
    # state read and the state update
    flops = b * nc * (g * L * (L + 1) * n + h * (L * (L + 1) * p + 4 * L * n * p))
    executed = ssd_executed_flops(b, s, h, p, g, n, chunk)
    # f32 operands: the card's peak for them is the TF32 tensor cores
    bound_ms = max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    ms = t["ms"]
    dev_ms = t["device_ms"] or ms
    log(f"[ssd] {ms:.3f} ms kernel, {t['plain_ms']:.3f} ms plain (CUDA events; device time "
        f"{t['device_ms']} / {t['plain_device_ms']}); no library call computes the SSD scan; "
        f"bound {bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP: {flops / PEAK_TF32_FLOPS * 1e3:.4f} "
        f"ms on the TF32 tensor cores; {nbytes / 1e6:.1f} MB: "
        f"{nbytes / PEAK_HBM_BYTES * 1e3:.4f} ms), {100 * bound_ms / dev_ms:.1f} % of the bound "
        f"(device time); {nbytes / dev_ms / 1e6:.0f} GB/s achieved")
    log(f"[ssd] derived from the kernel's tiles, not measured: {executed / 1e9:.1f} GFLOP on the "
        f"tensor cores in 3xTF32 ({executed / PEAK_TF32_FLOPS * 1e3:.4f} ms at the TF32 peak), "
        f"{executed / dev_ms / 1e9:.1f} TFLOP/s at the device time")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:31",
            "max_abs_err": worst, "tolerance": "1e-5 + 1e-4 max|plain| per (batch, head) (f32)",
            "tolerance_ratio": worst_ratio, "control_ratio": ctrl, **t,
            "pass_device_ms": pass_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_TF32_FLOPS > nbytes / PEAK_HBM_BYTES
            else "bytes",
            "shape": f"B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk} f32, strided"}


def ssd_bwd_drop_carried(x, dt, a, bm, cm, chunk, dy, dst, h_init, at):
    """A planted fault: the state cotangent carried out of chunk ``at`` into
    chunk ``at`` - 1 dropped (a segment boundary of the backward kernel,
    whose segments are chunks): the chunks before ``at`` get the gradients
    of a zero cotangent on the state leaving them."""
    import torch
    from repro_torch.kernels import ref
    cut = at * chunk
    head = [t[:, :cut] for t in (x, dt)] + [a] + [t[:, :cut] for t in (bm, cm)]
    tail = [t[:, cut:] for t in (x, dt)] + [a] + [t[:, cut:] for t in (bm, cm)]
    _, st = ref.ssd_chunked(*head, chunk, h_init=h_init)
    g1 = ref.ssd_chunked_bwd(*head, chunk, dy[:, :cut], torch.zeros_like(dst), h_init=h_init)
    g2 = ref.ssd_chunked_bwd(*tail, chunk, dy[:, cut:], dst, h_init=st)
    cat = lambda i: torch.cat([g1[i], g2[i]], 1)  # noqa: E731
    return cat(0), cat(1), g1[2] + g2[2], cat(3), cat(4), g1[5]


def ssd_bwd_drop_intra_du(x, dt, a, bm, cm, chunk, dy, dst, h_init, at):
    """A planted fault: chunk ``at``'s intra-chunk term of du, sum_{i>=j}
    (C_i . B_j) e^{cs_i - cs_j} dy_i, dropped from dx = dt du and from the
    x . du of ddt."""
    import torch
    from repro_torch.kernels import ref
    g = list(ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h_init))
    sl = slice(at * chunk, (at + 1) * chunk)
    rep = x.shape[2] // bm.shape[2]
    bh, ch = (t[:, sl].repeat_interleave(rep, 2) for t in (bm, cm))
    cs = torch.cumsum(dt[:, sl] * a, 1)                                    # [B,L,H]
    low = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))[None, :, :, None]
    diff = torch.where(low, cs[:, :, None] - cs[:, None, :], 0.0)          # [B,i,j,H]
    w = torch.where(low, torch.exp(diff), 0.0) * torch.einsum("bihn,bjhn->bijh", ch, bh)
    du = torch.einsum("bijh,bihp->bjhp", w, dy[:, sl])
    g[0] = g[0].clone()
    g[1] = g[1].clone()
    g[0][:, sl] -= dt[:, sl, :, None] * du
    g[1][:, sl] -= (x[:, sl] * du).sum(-1)
    return tuple(g)


def ssd_bwd_drop_decay_grad(x, dt, a, bm, cm, chunk, dy, dst, h_init):
    """A planted fault: ddt without the decays' term a d(dA), x . du only
    (du = dx / dt)."""
    from repro_torch.kernels import ref
    g = list(ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h_init))
    g[1] = (x * g[0]).sum(-1) / dt
    return tuple(g)


def ssd_bwd_one_head_per_group(x, dt, a, bm, cm, chunk, dy, dst, h_init):
    """A planted fault: dB and dC from the first head of each group only,
    not summed over the group's heads."""
    from repro_torch.kernels import ref
    g = list(ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h_init))
    rep = x.shape[2] // bm.shape[2]
    per_head = ref.ssd_chunked_bwd(x, dt, a, bm.repeat_interleave(rep, 2),
                                   cm.repeat_interleave(rep, 2), chunk, dy, dst, h_init=h_init)
    g[3], g[4] = per_head[3][:, :, ::rep], per_head[4][:, :, ::rep]
    return tuple(g)


def ssd_bwd_bound(b, s, h, p, g, n, chunk, h_init: bool) -> tuple:
    """(FLOPs, bytes) the SSD backward needs, derived from the shapes: each
    input (x, dt, a, B, C, dy, d(final state), h_init) read once and each
    gradient written once, f32; the products: C B^T once per group and chunk
    and dy u^T per head (causal halves), the intra-chunk du, dB and dC
    (causal halves), and per head and chunk the entering state recomputed,
    the local state cotangent, G B, G^T u and S^T dy (2 L P N each)."""
    nc, L = -(-s // chunk), chunk
    flops = b * nc * (g * L * (L + 1) * n
                      + h * (2 * L * (L + 1) * p + 2 * L * (L + 1) * n + 10 * L * p * n))
    nbytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * g * n + b * h * p * n + 2 * h
                  + (2 * b * h * p * n if h_init else 0))
    return flops, nbytes


def ssd_bwd_executed_flops(b, s, h, p, g, n, chunk) -> int:
    """Derived, not measured: the FLOPs the SSD backward's mma.sync tiles run
    on the tensor cores (csrc/ssd_scan_bwd.cu: 16 x 8 x 8 tiles, each
    product three times for 3xTF32): pass 1's local state and cotangent and
    C B^T once per group and chunk; pass 3's nine products per (b, h,
    chunk), causal tiles only, N in steps of 32 columns."""
    nc, up8 = -(-s // chunk), lambda v: -(-v // 8) * 8
    l8, p_t = up8(chunk) // 8, -(-p // 8)
    local = 2 * -(-p // 16) * l8 * -(-n // 8)
    cb = 8 * (up8(n) // 8) * 4
    steps = [min(32, n - nb) for nb in range(0, n, 32)]
    chunk_tiles = 0
    for r0 in range(0, chunk, 16):
        below, above = l8 - r0 // 8, min(l8, r0 // 8 + 2)  # k-steps i >= j0; j <= i0 + 15
        chunk_tiles += min(r0 // 8 + 2, l8) * p_t + below * p_t
        for cols in steps:
            n_t = -(-cols // 8)
            chunk_tiles += up8(cols) // 8 * p_t + (2 * p_t + below + above) * n_t
    mma = b * nc * (g * cb + h * (local + chunk_tiles))
    return 3 * 2 * 16 * 8 * 8 * mma


def hold_ssd_bwd(label: str, got, want) -> tuple:
    """The backward kernel's gradients against the plain version's by
    ``ref.ssd_grad_tolerance_ratio``; returns (max_abs_err, worst ratio)."""
    from repro_torch.kernels import ref
    ratios = ref.ssd_grad_ratios(got, want)
    err = max(max_err(gt, w) for gt, w in zip(got, want) if w is not None)
    worst = max(ratios.values())
    log(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in ratios.items())
        + f" of the tolerance (worst {worst:.4f}); max_abs_err {err:.3g}")
    if not worst <= 1:
        raise AssertionError(f"{label}: the backward kernel disagrees with its plain version")
    return err, worst


def phase_ssd_bwd_kernel():
    """The SSD backward kernel against ``ref.ssd_chunked_bwd`` at mamba2-370m's
    training shape and its edge cases, four planted faults, times and the
    bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan_bwd as tssdb
    worst, worst_ratio = 0.0, 0.0

    def case(b, s, h, p, g, n, chunk, h_init=False, seed=0):
        x, dt, a, bm, cm, h0 = ssd_inputs(b, s, h, p, g, n, seed=seed, h_init=h_init)
        gen = torch.Generator(device="cuda").manual_seed(seed + 100)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dst = torch.randn((b, h, p, n), generator=gen, device="cuda")
        return (x, dt, a, bm, cm), dy, dst, h0

    for b, s, h, p, g, n, chunk, h_init in [
            (1, 4096, 8, 64, 2, 128, 64, False),     # G=2: 4 heads a group
            (1, 4000, 32, 64, 1, 128, 64, False),    # ragged S inside the last segment
            (1, 2048, 32, 64, 1, 128, 64, True),     # h_init: dh_init held too
            (1, 4096, 128, 64, 1, 16, 64, False),    # jamba-v0.1-52b's mixer: H=128, N=16
            (1, 4096, 128, 64, 1, 16, 64, True),     # the same with h_init
            (1, 2048, 32, 64, 1, 128, 16, False)]:   # a chunk of 16
        ins, dy, dst, h0 = case(b, s, h, p, g, n, chunk, h_init)
        got = tssdb.ssd_scan_bwd(*ins, chunk, dy, dst, h_init=h0)
        want = ref.ssd_chunked_bwd(*ins, chunk, dy, dst, h_init=h0)
        err, ratio = hold_ssd_bwd(f"[ssd bwd] B={b} S={s} H={h} P={p} G={g} N={n} "
                                  f"chunk={chunk}{' h_init' if h_init else ''}"
                                  f"{f', a = -(1..{h})' if h == 128 else ''}", got, want)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        del got, want

    # the main path's shape: one layer of the mamba2-370m train step
    b, s, h, p, g, n, chunk = 1, 4096, 32, 64, 1, 128, 64
    ins, dy, dst, _ = case(b, s, h, p, g, n, chunk, seed=1)
    got = tssdb.ssd_scan_bwd(*ins, chunk, dy, dst)
    want = ref.ssd_chunked_bwd(*ins, chunk, dy, dst)
    err, ratio = hold_ssd_bwd(f"[ssd bwd] main shape B={b} S={s} H={h} P={p} G={g} N={n} "
                              f"chunk={chunk}, strided x, B, C", got, want)
    worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    again = tssdb.ssd_scan_bwd(*ins, chunk, dy, dst)
    differ = [name for name, u, v in zip(ref.SSD_GRAD_NAMES, got, again)
              if u is not None and not torch.equal(u, v)]
    log(f"[ssd bwd] the same inputs twice: {'bit-identical gradients' if not differ else differ}")
    if differ:
        raise AssertionError(f"[ssd bwd] two calls on the same inputs differ in {differ}")
    del got, again
    at = s // chunk // 2
    keep = ref.SSD_GRAD_KEEP

    def ctrl(label, fault, i):
        name = ref.SSD_GRAD_NAMES[i]
        return control(f"[ssd bwd] control: plain with {label}, on {name}", fault[i], want[i],
                       ratio_fn=lambda f, w: ref.ssd_grad_tolerance_ratio(f, w, keep[name]))
    args = (*ins, chunk, dy, dst, None)
    ctrls = [ctrl(f"the state cotangent carried into chunk {at - 1} from chunk {at} dropped "
                  f"(a segment boundary)", ssd_bwd_drop_carried(*args, at), 0),
             ctrl(f"chunk {at}'s intra-chunk term of du dropped",
                  ssd_bwd_drop_intra_du(*args, at), 0),
             ctrl("ddt without the decays' gradient", ssd_bwd_drop_decay_grad(*args), 1),
             ctrl(f"dB from one head of each group of {h // g}",
                  ssd_bwd_one_head_per_group(*args), 3)]
    del want
    torch.cuda.empty_cache()
    t = timings(lambda: tssdb.ssd_scan_bwd(*ins, chunk, dy, dst),
                lambda: ref.ssd_chunked_bwd(*ins, chunk, dy, dst), None, 12)
    passes = device_ms_by_kernel(lambda: tssdb.ssd_scan_bwd(*ins, chunk, dy, dst), 12)
    pass_ms = {k: sum(v for key, v in passes.items() if k in key) for k in SSD_BWD_PASSES}
    log("[ssd bwd] device ms per call by pass: "
        + ", ".join(f"{k} {v:.4f}" for k, v in pass_ms.items()))
    flops, nbytes = ssd_bwd_bound(b, s, h, p, g, n, chunk, False)
    # f32 operands: the card's peak for them is the TF32 tensor cores
    t.update(bound(flops, nbytes, PEAK_TF32_FLOPS))
    dev_ms = t["device_ms"] or t["ms"]
    log(f"[ssd bwd] {t['ms']:.3f} ms kernel, {t['plain_ms']:.3f} ms plain (CUDA events; device "
        f"time {t['device_ms']} / {t['plain_device_ms']}); no library call computes the SSD "
        f"scan's gradient; bound {t['bound_ms']:.4f} ms ({flops / 1e9:.2f} GFLOP: "
        f"{flops / PEAK_TF32_FLOPS * 1e3:.4f} ms at the TF32 peak; {nbytes / 1e6:.1f} MB: "
        f"{nbytes / PEAK_HBM_BYTES * 1e3:.4f} ms), {100 * t['bound_ms'] / dev_ms:.1f} % of the "
        f"bound (device time); {flops / dev_ms / 1e9:.1f} TFLOP/s of needed work, "
        f"{100 * flops / dev_ms / 1e9 / (PEAK_TF32_FLOPS / 1e12):.2f} % of the TF32 tensor-core "
        f"peak ({PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s)")
    executed = ssd_bwd_executed_flops(b, s, h, p, g, n, chunk)
    log(f"[ssd bwd] derived from the kernel's tiles, not measured: {executed / 1e9:.1f} GFLOP on "
        f"the tensor cores in 3xTF32 ({executed / PEAK_TF32_FLOPS * 1e3:.4f} ms at the TF32 "
        f"peak), {executed / dev_ms / 1e9:.1f} TFLOP/s at the device time")
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:85",
            "max_abs_err": worst,
            "tolerance": "1e-5 + 1e-4 max|plain| per (batch, head) for dx, ddt; per (batch, "
                         "group) for dB, dC; per head for da, dh_init (f32)",
            "tolerance_ratio": worst_ratio, "control_ratio": min(ctrls), **t,
            "library_note": "none: no PyTorch call computes the SSD scan or its gradient",
            "pass_device_ms": pass_ms,
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
    ssd_ms = sum(ms for key, ms in dev.items() if any(k in key for k in SSD_PASSES))
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


def checked_train_ops(fwd: list, bwd: list, ssd_fwd: list, ssd_bwd: list):
    """The training path's kernels with every launch held against its plain
    version on its own inputs.  The flash forward appends (o's
    ``tolerance_ratio`` with the absolute term scaled by max(1, max |v|),
    lse's ``lse_tolerance_ratio``, o's unscaled ``tolerance_ratio``); the
    flash backward (the worst ``head_rel_rms`` of dq, dk and dv, their worst
    ``grad_tolerance_ratio``); the SSD forward the worse of y's and the
    final state's ``ssd_tolerance_ratio``; the SSD backward (the worst
    ``ssd_grad_tolerance_ratio`` with the absolute term scaled by the
    cotangents' largest |value|, the unscaled one).  Inside a model the
    loss is a mean over thousands of tokens and the scan's gradients are far
    below the kernels' absolute term, so that term scales with them: the
    gradient is linear in its cotangents.  The unscaled ratios are reported
    only."""
    from repro_torch.kernels import ops, ref
    kernel_fwd, kernel_bwd = ops.mha_fwd, ops.mha_bwd
    kernel_ssd_fwd, kernel_ssd_bwd = ops.ssd_fwd, ops.ssd_bwd

    def checked_fwd(q, k, v, **kw):
        o, lse = kernel_fwd(q, k, v, **kw)
        o_w, lse_w = ref.mha_fwd_lse(q, k, v, **kw)
        fwd.append((ref.tolerance_ratio(o, o_w, max(1.0, v.abs().max().item())),
                    ref.lse_tolerance_ratio(lse, lse_w), ref.tolerance_ratio(o, o_w)))
        return o, lse

    def checked_bwd(q, k, v, o, lse, do, **kw):
        got = kernel_bwd(q, k, v, o, lse, do, **kw)
        want = ref.mha_bwd(q, k, v, o, lse, do, **kw)
        bwd.append((max(ref.head_rel_rms(g, w) for g, w in zip(got, want)),
                    max(ref.grad_tolerance_ratio(g, w) for g, w in zip(got, want))))
        return got

    def checked_ssd_fwd(*args, **kw):
        y, st = kernel_ssd_fwd(*args, **kw)
        y_w, st_w = ref.ssd_chunked(*args, **kw)
        ssd_fwd.append(max(ref.ssd_tolerance_ratio(y, y_w),
                           ref.ssd_tolerance_ratio(st, st_w, head_dim=1)))
        return y, st

    def checked_ssd_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=None):
        got = kernel_ssd_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h_init)
        want = ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dst, h_init=h_init)
        scale = max(dy.abs().max().item(), dst.abs().max().item())
        ssd_bwd.append((max(ref.ssd_grad_ratios(got, want, atol_scale=scale).values()),
                        max(ref.ssd_grad_ratios(got, want).values())))
        return got
    return swapped_ops(mha_fwd=checked_fwd, mha_bwd=checked_bwd, ssd_fwd=checked_ssd_fwd,
                       ssd_bwd=checked_ssd_bwd)


def plain_train_ops():
    from repro_torch.kernels import ref
    return swapped_ops(mha_fwd=ref.mha_fwd_lse, mha_bwd=ref.mha_bwd, ssd_fwd=ref.ssd_chunked,
                       ssd_bwd=ref.ssd_chunked_bwd)


def faulty_bwd_ops():
    """A planted fault in the backward: dk and dv from the first query head
    of each kv head's group only (the loop over the group's heads stops
    after one), dq right.  Where each kv head serves one query head
    (gemma-7b) that is no fault: there dk and dv lose their columns from half
    the head dim on (a column split's fault).  The SSD scan's backward: ddt
    without the decays' gradient (``ssd_bwd_drop_decay_grad``)."""
    import torch
    from repro_torch.kernels import ref

    def bwd(q, k, v, o, lse, do, **kw):
        dq, dk, dv = ref.mha_bwd(q, k, v, o, lse, do, **kw)
        b, s, h, dh = q.shape
        kvh = k.shape[2]
        if h == kvh:
            return dq, upper_half_zeroed(dk), upper_half_zeroed(dv)
        first = lambda t: t.reshape(b, s, kvh, h // kvh, dh)[:, :, :, 0]  # noqa: E731
        lse1 = lse.reshape(b, kvh, h // kvh, -1)[:, :, 0].contiguous()
        _, dk, dv = ref.mha_bwd(first(q), k, v, first(o), lse1, first(do), **kw)
        return dq, dk, dv
    return swapped_ops(mha_fwd=ref.mha_fwd_lse, mha_bwd=bwd, ssd_fwd=ref.ssd_chunked,
                       ssd_bwd=lambda *a, h_init=None: ssd_bwd_drop_decay_grad(*a, h_init))


def leaf_rel_rms(got, want) -> dict:
    """{path: RMS of (got - want) over the RMS of want} of two gradient trees."""
    from repro_torch import bridge
    g, w = bridge.flatten(got), bridge.flatten(want)
    return {k: ((g[k].float() - w[k].float()).pow(2).mean().sqrt()
                / w[k].float().pow(2).mean().sqrt()).item() for k in w}


def n_mixers(cfg) -> tuple:
    """(attention layers, Mamba-2 layers) of a configuration."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    return kinds.count("attn"), kinds.count("mamba")


def active_params(cfg, n_params: int) -> int:
    """Parameters a token runs through: all of them for a dense model; for
    an MoE model less the routed experts it is not sent to (E - K of each
    MoE layer's E)."""
    if cfg.moe is None:
        return n_params
    m = cfg.moe
    de = m.d_expert if m.d_expert is not None else cfg.d_ff
    n_moe = sum(cfg.layer_has_moe(i) for i in range(cfg.n_layers))
    return n_params - n_moe * (m.n_experts - m.top_k) * 3 * cfg.d_model * de


def phase_train(arch: str = TRAIN_ARCH, batch_size: int = 1, tag: str = "train",
                n_layers: int = 0):
    """Training steps of ``arch`` at B=``batch_size``, S=TRAIN_SEQ, at full
    width and depth, or on its first ``n_layers`` layers where given; log
    lines start with ``[tag]``."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import TrainSetup, init_sharded_state, make_train_step, mesh_axes
    dev = torch.device("cuda")
    cfg = get_config(arch)
    depth = f"{cfg.n_layers} layers"
    if n_layers:
        depth = f"{n_layers} of {cfg.n_layers} layers: depth cut, full width"
        cfg = cfg.replace(n_layers=n_layers)
    launch_train.init_distributed(dev)
    mesh = launch_train.make_mesh({"data": 1}, dev)
    setup = TrainSetup(cfg=cfg, opt=OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, ef = init_sharded_state(setup, mesh, seed=0, device=dev)
    step = make_train_step(setup, mesh, tf.init_lm(cfg, device="meta"))
    n_params = tf.param_count(params)
    torch.cuda.synchronize()
    n_attn, n_ssm = n_mixers(cfg)
    mixer = (f"{cfg.n_heads} heads, kv {cfg.n_kv_heads}, dh {cfg.resolved_head_dim}" if n_attn
             else f"Mamba-2: {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} SSD heads of "
                  f"P={cfg.ssm.head_dim}, N={cfg.ssm.state_dim}, chunk {cfg.ssm.chunk_size}")
    log(f"[{tag}] {cfg.name} {n_params / 1e9:.3f} B params ({depth}, d={cfg.d_model},"
        f" {mixer}, remat "
        f"{cfg.remat!r}), bf16 with f32 AdamW moments (with the gradients "
        f"{n_params * 12 / 1e9:.1f} GB), initialised on the card from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB; "
        f"NCCL group of {torch.distributed.get_world_size()}, mesh {mesh_axes(mesh)}, "
        f"fabric {step.fabric.kind}; lr {TRAIN_LR}, warmup {TRAIN_WARMUP} step")
    batch = synth_batch(cfg, DataConfig(seq_len=TRAIN_SEQ, global_batch=batch_size), 0, device=dev)
    fwd_runs = 2 if cfg.remat == "full" else 1
    per_step = {**NO_LAUNCHES, "flash_attention": n_attn * fwd_runs, "flash_attention_bwd": n_attn,
                "ssd_scan": n_ssm * fwd_runs, "ssd_scan_bwd": n_ssm}
    n_moe = sum(cfg.layer_has_moe(i) for i in range(cfg.n_layers))
    if n_moe:
        # the aux loss of the model's forward on the initial parameters (one
        # rank: the stored shards are the whole tensors) through the plain
        # versions, for the step's moe_aux metric to be held to
        with plain_ops(), torch.no_grad():
            aux_plain = float(tf.lm_forward(params, batch, cfg)[1])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    total = dict(NO_LAUNCHES)
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, ef, m = step(params, opt, ef, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        if counts != per_step:
            raise AssertionError(f"train step {i}: launches {counts}, want {per_step}")
        total = {k: total[k] + counts[k] for k in total}
        losses.append(float(m["loss"]))
        if i == 0:
            aux0 = float(m["moe_aux"])
        log(f"[{tag}] step {i}: loss {losses[-1]:.5f} ce {float(m['ce']):.5f} grad_norm "
            f"{float(m['grad_norm']):.4f} lr {m['lr']:.3g}, {times[-1]:.1f} ms")
    if not all(math.isfinite(x) for x in losses) or \
            not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"train: the loss did not fall at every step: {losses}")
    if n_moe:
        # the aux loss sums E * sum_e f_e P_e over the MoE layers: 1 a layer
        # when balanced.  A routing flip moves it by ~E/(G T K) of a
        # probability: the kernels' one-ulp differences move it far less
        # than 1 %, a layer missing from the sum by 1/n_moe.
        rel = abs(aux0 - aux_plain) / aux_plain
        log(f"[{tag}] moe_aux at step 1: {aux0:.5f} over {n_moe} MoE layers, {aux0 / n_moe:.5f} "
            f"a layer; the forward through the plain versions on the same parameters "
            f"{aux_plain:.5f}: relative difference {rel:.3g} (must be finite and within 1 %)")
        if not (math.isfinite(aux0) and rel <= 0.01):
            raise AssertionError(f"train: moe_aux {aux0}, plain forward {aux_plain}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times[1:])
    tokens = TRAIN_SEQ * batch_size
    s = TRAIN_SEQ
    n_active = active_params(cfg, n_params)
    dense_flops = 6 * n_active * tokens
    # causal QK^T and PV, x3 for the backward
    attn_flops = (3 * 4 * n_attn * cfg.n_heads * cfg.resolved_head_dim * s * (s + 1) // 2
                  * batch_size if n_attn else 0)
    mfu = (dense_flops + attn_flops) / (step_ms / 1e3) / PEAK_BF16_FLOPS
    log(f"[{tag}] step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}; first "
        f"{times[0]:.1f} ms), {tokens / step_ms * 1e3:.1f} tokens/s; model FLOPs "
        f"{(dense_flops + attn_flops) / 1e12:.2f} T a step (6 N T = {dense_flops / 1e12:.2f} T "
        f"with N = {n_active} active of {n_params}, T = {tokens}; causal attention "
        f"12 L H dh S(S+1)/2 B = {attn_flops / 1e12:.3f} T"
        + ("; the SSD scan's FLOPs are not counted" if n_ssm else "")
        + f"): {100 * mfu:.2f} % of the bf16 peak; peak memory "
        f"{peak / 2**30:.2f} GiB; launches a step {per_step}")
    busy, dev_ms = device_profile(lambda: step(params, opt, ef, batch), "train step", top=8)
    shares = {}
    if dev_ms:
        tot = sum(dev_ms.values())
        for label, keys in (("flash bwd", FLASH_BWD_PASSES), ("flash fwd", ("flash_fwd_kernel",)),
                            ("ssd bwd", SSD_BWD_PASSES), ("ssd fwd", SSD_PASSES)):
            shares[label] = sum(v for key, v in dev_ms.items() if any(k in key for k in keys))
            if shares[label]:
                log(f"[{tag}] profiled step: {label} {shares[label]:.2f} ms of {tot:.2f} ms "
                    f"device time ({100 * shares[label] / tot:.1f} %)")

    # every kernel launch of one step (gradients only), held against the plain version
    fwd, bwd, sfwd, sbwd = [], [], [], []
    with checked_train_ops(fwd, bwd, sfwd, sbwd):
        grads, _ = step.grads_fn(params, batch)
    del grads
    ok = len(bwd) == n_attn and len(sbwd) == n_ssm and len(sfwd) == n_ssm
    if n_attn:
        worst_fwd = [max(r[i] for r in fwd) for i in range(3)]
        worst_bwd = [max(r[i] for r in bwd) for i in range(2)]
        log(f"[{tag}] one step's launches against the plain versions on their own inputs: "
            f"forward over {len(fwd)}: o {worst_fwd[0]:.3f} of the tolerance with its absolute "
            f"term scaled by max(1, max|v|) (unscaled {worst_fwd[2]:.3f}, reported), lse "
            f"{worst_fwd[1]:.4f}; backward over {len(bwd)}: worst (batch, head) relative RMS of "
            f"dq, dk, dv {worst_bwd[0]:.3g} (limit {ref.HEAD_RMS_LIMIT:.4g}; "
            f"grad_tolerance_ratio {worst_bwd[1]:.3g}, reported: the gradients lie below its "
            f"absolute term)")
        ok = ok and worst_fwd[0] <= 1 and worst_fwd[1] <= 1 and worst_bwd[0] <= ref.HEAD_RMS_LIMIT
    else:
        worst_fwd, worst_bwd = [None] * 3, [None] * 2
    worst_sfwd = max(sfwd) if sfwd else None
    worst_sbwd = [max(r[i] for r in sbwd) for i in range(2)] if sbwd else [None, None]
    if n_ssm:
        log(f"[{tag}] one step's SSD launches against the plain versions on their own inputs: "
            f"forward over {len(sfwd)}: {worst_sfwd:.4f} of the tolerance; backward over "
            f"{len(sbwd)}: {worst_sbwd[0]:.4f} of ssd_grad_tolerance_ratio with its absolute "
            f"term scaled by the cotangents' largest |value| (unscaled {worst_sbwd[1]:.3g}, "
            f"reported: the gradients lie below its absolute term)")
        ok = ok and worst_sfwd <= 1 and worst_sbwd[0] <= 1
    if not ok:
        raise AssertionError(f"train: a kernel launch disagrees with its plain version: "
                             f"{fwd} {bwd} {sfwd} {sbwd}")

    # depth 2, full width: every leaf's gradient through the kernels against the
    # gradient through the plain versions and through a planted fault
    cfg2 = cfg.replace(n_layers=2)
    p2 = _first_periods(params, 2)
    step2 = make_train_step(TrainSetup(cfg=cfg2), mesh, tf.init_lm(cfg2, device="meta"))
    routes = []
    with recorded_routing(routes):
        got, _ = step2.grads_fn(p2, batch)
    with plain_train_ops():
        want, _ = step2.grads_fn(p2, batch)
    rel = leaf_rel_rms(got, want)
    rel_replayed = None
    if cfg.moe:
        # the plain versions routed as the kernels routed: what is left of
        # the difference is the kernels' arithmetic, without routing flips
        with plain_train_ops(), replayed_routing(routes):
            rel_replayed = leaf_rel_rms(got, step2.grads_fn(p2, batch)[0])
        worst = max(rel_replayed, key=rel_replayed.get)
        log(f"[{tag}] depth 2, the plain versions routed as the kernels routed: per-leaf "
            f"relative RMS of the gradient, worst {rel_replayed[worst]:.3g} ({worst}; limit "
            f"{MODEL_LIMIT})")
        if not max(rel_replayed.values()) <= MODEL_LIMIT:
            raise AssertionError(f"depth-2 gradients, routing replayed: {rel_replayed}")
    del got, routes
    with faulty_bwd_ops():
        fault = leaf_rel_rms(step2.grads_fn(p2, batch)[0], want)
    worst_leaf = max(rel, key=rel.get)
    fault_label = ("ddt without the decays' gradient" if not n_attn
                   else "dk/dv from one head of each group" if cfg.n_heads > cfg.n_kv_heads
                   else "dk/dv columns from dh/2 on dropped")
    log(f"[{tag}] depth 2, full width, per-leaf relative RMS of the gradient, kernels vs plain: "
        f"worst {rel[worst_leaf]:.3g} ({worst_leaf}; limit {MODEL_LIMIT}); control, {fault_label}: "
        f"worst {max(fault.values()):.3g} "
        f"({max(fault, key=fault.get)}; must exceed the limit)")
    if not max(rel.values()) <= MODEL_LIMIT < max(fault.values()):
        raise AssertionError(f"depth-2 gradients: kernels {rel}, control {fault}")
    del params, opt, p2, want
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return {"train_arch": cfg.name, "train_layers": cfg.n_layers, "train_depth": depth,
            "train_params": n_params, "train_active_params": n_active,
            "train_batch": batch_size, "train_seq": TRAIN_SEQ, "train_moe_aux_step1": aux0,
            "train_moe_aux_plain_forward": aux_plain if n_moe else None,
            "train_remat": cfg.remat, "train_lr": TRAIN_LR, "train_warmup": TRAIN_WARMUP,
            "train_losses": losses, "train_step_ms": step_ms, "train_step_times_ms": times,
            "train_tokens_per_s": tokens / step_ms * 1e3, "train_mfu": mfu,
            "train_model_flops": dense_flops + attn_flops, "train_peak_bytes": peak,
            "train_device_busy": busy, "train_device_ms_by_part": shares,
            "train_launches_per_step": per_step, "train_launches": total,
            "train_fwd_o_scaled_ratio": worst_fwd[0], "train_fwd_lse_ratio": worst_fwd[1],
            "train_fwd_o_unscaled_ratio": worst_fwd[2], "train_bwd_head_rel_rms": worst_bwd[0],
            "train_bwd_grad_tolerance_ratio": worst_bwd[1], "train_ssd_fwd_ratio": worst_sfwd,
            "train_ssd_bwd_scaled_ratio": worst_sbwd[0],
            "train_ssd_bwd_unscaled_ratio": worst_sbwd[1],
            "train_depth2_grad_rel_rms": max(rel.values()),
            "train_depth2_fault_rel_rms": max(fault.values()),
            "train_depth2_grad_rel_rms_routing_replayed":
                rel_replayed and max(rel_replayed.values())}


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
    kernels = [phase_flash(), phase_flash_bwd(), phase_decode_kernel(), phase_ssd_kernel(),
               phase_ssd_bwd_kernel()]

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
    kernels[2].update(launches=dec["decode_launches"],
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
    kernels[3].update(launches=mpre["ssd_launches"],
                      launches_per_step=mpre["ssd_launches"] / mpre["mamba_prefill_calls"])
    del params
    torch.cuda.empty_cache()

    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] {cfg.name} {tf.param_count(params) / 1e9:.3f} B params (bf16, f32 router) in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    moe_pre = phase_prefill(cfg, params, tag="moe prefill", prefix="moe_")
    moe_dec = phase_decode_ab(cfg, params, "moe decode")
    del params
    torch.cuda.empty_cache()

    cfg = get_config(GEMMA_ARCH)
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] {cfg.name} {tf.param_count(params) / 1e9:.3f} B params bf16 ({cfg.n_layers} "
        f"layers, {cfg.n_heads} heads on {cfg.n_kv_heads} kv heads, dh {cfg.resolved_head_dim}, "
        f"GeGLU, tied embeddings) in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    gemma_pre = phase_prefill(cfg, params, tag="gemma prefill", prefix="gemma_")
    gemma_dec = phase_decode_ab(cfg, params, "gemma decode")
    del params
    torch.cuda.empty_cache()

    full = get_config(PAPER_ARCH)
    cfg = full.replace(n_layers=PAPER_LAYERS)
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] {cfg.name} (paper Table 3) {PAPER_LAYERS} of its {full.n_layers} layers: depth "
        f"cut, full width (d={cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} kv heads, "
        f"d_ff {cfg.d_ff}); {tf.param_count(params) / 1e9:.3f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    paper_pre = phase_prefill(cfg, params, tag="paper prefill", prefix="llama80b_")
    del params
    torch.cuda.empty_cache()

    full = get_config(HYBRID_ARCH)
    cfg = full.replace(n_layers=HYBRID_LAYERS)
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] {cfg.name} {HYBRID_LAYERS} of its {full.n_layers} layers (one period: "
        f"{', '.join(f'{k}+{f}' for k, f in tf.period_spec(cfg))}): depth cut, full width "
        f"(d={cfg.d_model}, {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} SSD heads of "
        f"P={cfg.ssm.head_dim}, N={cfg.ssm.state_dim}; {cfg.n_heads} attention heads on "
        f"{cfg.n_kv_heads} kv heads; {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of width "
        f"{cfg.moe.d_expert}); {tf.param_count(params) / 1e9:.3f} B params bf16 (f32 SSM, norm "
        f"and router leaves) in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    hybrid_pre = phase_prefill(cfg, params, tag="jamba prefill", prefix="jamba_")
    hybrid_dec = phase_decode_ab(cfg, params, "jamba decode")
    del params
    torch.cuda.empty_cache()

    for arch in ("llama3_8b", "mamba2_370m", MOE_ARCH, GEMMA_ARCH):
        out = serve.main(["--arch", arch, "--batch", "4", "--prompt-len", "12", "--gen", "20"])
        if not torch.isfinite(out["logits"]).all():
            raise AssertionError(f"serve entry point, {arch}: logits not finite")
        del out
        torch.cuda.empty_cache()
    log(f"[serve] ok; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    tr = phase_train()
    moe_tr = {f"moe_{k}": v for k, v in
              phase_train(MOE_TRAIN_ARCH, MOE_TRAIN_BATCH, tag="moe train").items()}
    gemma_tr = {f"gemma_{k}": v for k, v in
                phase_train(GEMMA_ARCH, 1, tag="gemma train", n_layers=GEMMA_TRAIN_LAYERS).items()}
    ssm_tr = {f"mamba_{k}": v for k, v in phase_train(SSM_TRAIN_ARCH, 1, tag="mamba train").items()}
    # each kernel's launches in each path that ran it (counts set to 0 just before the path)
    dense_train, moe_train = f"{tr['train_arch']} train", f"{moe_tr['moe_train_arch']} train"
    gemma_train = f"{gemma_tr['gemma_train_arch']} train ({gemma_tr['gemma_train_depth']})"
    paper_prefill = f"llama-80b prefill ({PAPER_LAYERS} of 96 layers)"
    ssm_train = f"{ssm_tr['mamba_train_arch']} train"
    hybrid_prefill = f"jamba-v0.1-52b prefill ({HYBRID_LAYERS} of 32 layers)"
    hybrid_decode = f"jamba-v0.1-52b decode ({HYBRID_LAYERS} of 32 layers)"
    kernels[0]["launches_by_path"] = {
        "llama3-8b prefill": pre["flash_launches"],
        "deepseek-moe-16b prefill": moe_pre["moe_flash_launches"],
        paper_prefill: paper_pre["llama80b_flash_launches"],
        hybrid_prefill: hybrid_pre["jamba_flash_launches"],
        dense_train: tr["train_launches"]["flash_attention"],
        moe_train: moe_tr["moe_train_launches"]["flash_attention"]}
    kernels[1]["launches_by_path"] = {
        dense_train: tr["train_launches"]["flash_attention_bwd"],
        moe_train: moe_tr["moe_train_launches"]["flash_attention_bwd"]}
    kernels[2]["launches_by_path"] = {
        "llama3-8b decode": dec["decode_launches"],
        "deepseek-moe-16b decode (a)": moe_dec["moe_decode_a_launches"],
        "deepseek-moe-16b decode (b)": moe_dec["moe_decode_b_launches"],
        hybrid_decode + " (a)": hybrid_dec["jamba_decode_a_launches"],
        hybrid_decode + " (b)": hybrid_dec["jamba_decode_b_launches"]}
    # the 256-wide instantiations: launched by the gemma-7b paths only
    kernels[0]["dh256"]["launches_by_path"] = {
        "gemma-7b prefill": gemma_pre["gemma_flash_launches"],
        gemma_train: gemma_tr["gemma_train_launches"]["flash_attention"]}
    kernels[1]["dh256"]["launches_by_path"] = {
        gemma_train: gemma_tr["gemma_train_launches"]["flash_attention_bwd"]}
    kernels[2]["dh256"]["launches_by_path"] = {
        "gemma-7b decode (a)": gemma_dec["gemma_decode_a_launches"],
        "gemma-7b decode (b)": gemma_dec["gemma_decode_b_launches"]}
    kernels[3]["launches_by_path"] = {"mamba2-370m prefill": mpre["ssd_launches"],
                                      ssm_train: ssm_tr["mamba_train_launches"]["ssd_scan"],
                                      hybrid_prefill: hybrid_pre["jamba_ssd_launches"]}
    kernels[4]["launches_by_path"] = {ssm_train: ssm_tr["mamba_train_launches"]["ssd_scan_bwd"]}
    kernels[4].update(launches=ssm_tr["mamba_train_launches"]["ssd_scan_bwd"],
                      launches_per_step=ssm_tr["mamba_train_launches_per_step"]["ssd_scan_bwd"])
    kernels[1].update(launches=tr["train_launches"]["flash_attention_bwd"],
                      launches_per_step=tr["train_launches_per_step"]["flash_attention_bwd"])
    log(f"[train] ok; whole run {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels, **pre, **dec, **mpre, **mdec, **moe_pre, **moe_dec,
                    **gemma_pre, **gemma_dec, **paper_pre, **hybrid_pre, **hybrid_dec, **tr,
                    **moe_tr, **gemma_tr, **ssm_tr, "card": smi}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
