#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of the repository.  Phases, in order; any failure raises
and the script exits non-zero without printing a result:

 1. device: name, count, and ``nvidia-smi`` name and power limit;
 2. build: the six CUDA kernels from ``src/repro_torch/kernels/csrc`` with
    nvcc (one process per source, started together), with registers, shared
    memory and spills from ``-Xptxas -v``; a spill in the bf16 flash kernel,
    in the flash backward's kernels, in any pass of the SSD scan or of its
    backward or in any 256-wide instantiation fails, as does a missing bf16
    wgmma flash, dk/dv or dq kernel (dh 64, 128 and 256; the forward with
    blocks of one and of two consumer warpgroups) or one whose registers at
    launch are not its plan's, or an SSD state or output pass without HGMMA
    (or with mma.sync's HMMA) in its SASS;
 3. kernels: each kernel against its plain version on the card at the main
    path's shapes and a few edge cases, to ``ref.tolerance_ratio`` <= 1 for
    the attention kernels (in bf16 one bf16 ulp of each element) and
    ``ref.ssd_tolerance_ratio`` <= 1 for the SSD scan (f32, 1e-5 + 1e-4 of
    each (batch, head)'s largest value); a planted fault (a KV tile, a cache
    split, a chunk's entering state, also at the first chunk of one of the
    SSD kernel's segments, an intra-chunk term dropped, or two SSD heads fed
    each other's x, emulated in the plain version) must fail the same check;
    times of kernel, plain version and, for attention,
    ``scaled_dot_product_attention`` (the library yardstick, never used by
    the port; no PyTorch call computes the SSD scan) with CUDA events around
    back-to-back calls, and the card's own time per call from torch.profiler,
    for the SSD scan also per pass and at a training step's forward shape;
    the flash backward kernel against ``ref.mha_bwd`` (dq, dk and dv, to
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
15. paligemma-3b (the VLM: 18 layers, 8 heads on one kv head at dh 256,
    GeGLU, tied vocab 257216) prefill at full width and depth, B=1, 256
    patches [1, 256, 1152] from a seeded generator and 3840 text tokens
    (S=4096): its 18 flash launches (the 256-wide instantiation at rep 8)
    each held against the plain version; the depth-2 logits at every text
    position against the plain versions', and two planted faults (the last
    KV tile dropped, the 256-row prefix block made causal) must not match;
16. paligemma-3b decode as phase 11 (text only from an empty cache, as the
    serve driver decodes it): every flash-decode launch of a step held,
    the depth-2 teacher-forced logits against the plain version's (a
    planted fault: the first cache slot dropped; shifting the kv heads is
    no fault with one kv head);
17. seamless-m4t-medium (the audio encoder-decoder: a 12-layer encoder over
    1024 frames, a 12-layer decoder of 16 heads on 16 at dh 64 with
    cross-attention) prefill at full width and depth, B=1, S=4096 over 1024
    frames: its 12 flash launches (the decoder's; the encoder's non-causal
    attention and the cross-attention are plain sdpa, as in the JAX
    package) each held; at depth 2 (2 encoder and 2 decoder layers) the
    logits against the plain versions', the last KV tile dropped must not
    match and the frames + 1 must move them;
18. seamless-m4t-medium decode as phase 11 over ``init_cross_state`` of
    1024 frames a sequence: the depth-2 teacher-forced logits against the
    plain version's and the prefill's with the same frames;
19. serve: ``repro_torch.launch.serve.main`` at full width, llama3-8b,
    mamba2-370m, deepseek-moe-16b, gemma-7b and paligemma-3b;
20. train: h2o-danube-3-4b at full width and depth (24 layers, bf16, random
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
21. train: granite-moe-1b-a400m (24 layers, 32 experts, top-8) the same way
    at B=2, S=4096, with the model-FLOP share over the active parameters,
    and the first step's ``moe_aux`` held to the aux of the plain forward on
    the same parameters;
22. train: gemma-7b at full width on 8 of its 28 layers (its whole training
    state does not fit the card), B=1, S=4096, the same way;
23. train: mamba2-370m at full width and depth (48 layers), B=1, S=4096, the
    same way: the SSD scan and its backward launch once per layer and step,
    each launch is held against its plain version, and at depth 2 the
    gradients with a planted fault in the backward (ddt without the decays'
    term) must not match; the model-FLOP share counts 6 N T only (the scan's
    FLOPs are not counted);
24. train: paligemma-3b at full width and depth, B=1, 3840 text tokens after
    256 patches, the same way (its model FLOPs: 3x the forward's, the patch
    projection, the prefix block and the logits of the text positions);
25. train: seamless-m4t-medium at full width and depth of both stacks, B=2,
    S=4096 over 1024 frames a sequence, the same way (its model FLOPs count
    the encoder and the cross-attention);
26. the rest of training: (a) mamba2-370m at full width and depth through
    ``repro_torch.launch.train.main`` (B=1, S=4096, lr 3e-3): 4 steps
    straight, then 2 steps with ``--ckpt`` (a temporary directory) and
    ``--resume`` to 4; the resumed last loss must be the straight run's
    within 1e-4 relative, and a restore with the optimizer's step reset to
    0 must not; bytes a save and the save and restore seconds; (b)
    h2o-danube-3-4b under remat "dots" as phase 20 (the flash forward
    launches twice a layer a step):
    its first loss equal to phase 20's within 1e-6, one step's gradients
    against remat "none"'s within 1e-3 per leaf, and a lower peak; (c)
    granite-moe-1b-a400m (B=2, S=4096) under HSDP with int8 error feedback
    on a pod axis of one: the first loss as plain FSDP's within 1e-6, the
    gradient norm moved by (0, 2 %], the error feedback non-zero and within
    half a scale of each leaf; the exchange's time and the error feedback's
    bytes; int8 codes over NCCL (a ring hop to the rank itself);
27. tensor and expert parallelism: (a) the training phases 20-26 ran
    through the model axis's code at model size 1 (phase 20's mesh has a
    model dim of one, the driver's too): every train step they made had a
    model axis of one that launched no collective, and each phase's launches
    a step (held there to the counts they had before the model axis) and
    step time are printed beside each other; (b) one full-width layer each
    of h2o-danube-3-4b (attention and MLP), granite-moe-1b-a400m (attention
    and its MoE, B=2), mamba2-370m (the SSD mixer) and paligemma-3b
    (attention: one query head on the replicated kv head at dh 256), S=4096:
    the whole layer's blocks, forward and backward through the kernels,
    against the sum of the shares of 8 model ranks run in turn at their
    local shapes through the same kernels (``SequentialModelAxis``, a
    stand-in for ``parallel.tensor.ModelAxis``; every launch of the shares
    held to its plain version as the training phase holds its launches):
    the output, the input's gradient and every leaf's gradient within
    MODEL_LIMIT relative RMS, 8 launches of each kernel of the block, and
    three planted faults that must fail (a rank's partial dropped;
    paligemma's replicated wk/wv gradients not summed over the axis, and
    summed 8 times); then each kernel at the local shapes against its plain
    version and timed beside its bound, the plain version and SDPA.  The
    model axis's collectives themselves run on gloo in the tests;
28. rail-sharded serving: (a) phase 19's driver runs served through a
    one-rank ``DeviceMesh`` and launched no rail or model-axis collective
    (the port's fabric and model axis counted) and each step launched the
    parent's kernels at capacity 32 (none); (b), right after phase 5 on its
    weights, llama3-8b context-sharded at world size 1 (one shard, offset
    0), B=1, a 32768-slot cache (4.3 GB of K/V) filled to 32000 slots, 16
    steps timed: the flash-decode stats variant must launch once a layer a
    step, each launch of one step is held to the plain stats
    (``ref.stats_tolerance_ratio``) and the logits to the batch-sharded
    path's (the decode kernel) on the same cache within MODEL_LIMIT; (c) one
    full-width llama3-8b attention block over a 32768-slot cache as 8 rail
    shards of 4096 slots run in turn at positions 20000 (shards 5-7 hold no
    valid slot) and 32767: each shard's ``context_local_stats`` through the
    stats kernel, the port's ``merge_decode_stats`` over the stacked shards,
    held to the plain whole-cache decode by ``ref.tolerance_ratio`` <= 1,
    with three planted faults that must read > 1 (a shard's stats dropped,
    the merge without its rescale, every shard placed and written at shard
    0's offset); (d) one full-width decode layer each of llama3-8b
    (attention, 4 query heads on 1 kv head a rank, B=8, C=4096, and the
    MLP), deepseek-moe-16b (MoE, EP), mamba2-370m (the mixer's decode over
    the conv channels and state of the rank's heads) and paligemma-3b
    (attention, one query head on the replicated kv head, dh 256) as the
    shares of 8 model ranks run in turn (``SequentialModelAxis``), summed
    and held to the whole layer within MODEL_LIMIT, a rank's partial dropped
    must fail; then the decode kernel at the attention shares' local shapes
    and the stats variant at (c)'s, timed beside the bound, the plain
    version and SDPA.
29. the pipeline (``parallel.pipeline``): h2o-danube-3-4b at full width
    and depth (24 periods), PIPE_MICRO microbatches of one sequence of
    PIPE_SEQ tokens (4 x 4096 do not fit: GPipe keeps every microbatch's
    activations); (a) ``make_pipeline_train_step`` on a one-rank pipe group
    over NCCL: 4 SGD steps timed, their losses, peak memory, and the flash
    forward and backward launches a step (one a layer a microbatch);
    (b) the gradients at the initial weights as PIPE_STAGES stages of 6
    periods run in turn (``pipeline.LocalPipe``, a local hand-off in place
    of the shift): loss and every gradient leaf bit-equal to (a)'s, and
    three planted faults of the hand-off (``pipe_faults``: a microbatch's
    activations lost, a cotangent not shifted back, a shift by +2) must move
    some leaf by more than PIPE_LIMIT relative RMS; (c) (a)'s gradients
    against ``lm_loss``'s (aux weight 0) over the whole batch through the
    same kernels, within PIPE_LIMIT relative RMS per leaf;
30. calibration: ``profiling.microbench.run_suite`` at the full
    configurations' shapes (``smoke=False``, 5 repeats): every kernel case
    through its CUDA kernel, its last output held to the plain version on
    the same inputs (``measure_case`` raises where a case did not launch
    its kernel once a call or disagrees: ``ref.tolerance_ratio``, or
    ``ref.ssd_tolerance_ratio``, at most 1), and a planted fault (a flash
    case's output without its last query row) that must raise; the
    depth-differenced step phases of llama3-8b, deepseek-moe-16b and
    mamba2-370m and the one-rank sharded train step, timed by their kernels'
    time (torch.profiler), with the wall time and the card's busy share
    printed beside it; no skipped record but the JAX package's by-design
    ones (CALIB_BY_DESIGN); the fitted table (achieved FLOP/s, effective
    MFU and HBM efficiency against ``PROFILES["h100"]``) printed, the
    artifact and table written under build/; and the step phase (llama3-8b
    at full width, 4 layers) must dispatch no ``aten.select_backward``: it
    differentiates one leaf a period, as the train step does;
31. weight-resident decode (``ServeSetup(weight_resident=True)``) on
    phase 5's llama3-8b weights, B=8, capacity 4096, 8 teacher-forced and 8
    greedy steps: (a) on the one-device mesh (1, 1), where the resident
    step runs every product over the rails' one rank (``RailShard`` on
    whole shards; its combines counted and required), its logits and
    caches bit-equal to the gathered step's, 32 flash-decode launches a
    step as there, ms a step (host clock), device ms a step (profiler) and
    the busy share of both; (b) the same steps as 8 rail ranks in turn
    (``SequentialRails``: every product from each rank's shard, the partial
    sums added in rank order, the output slices concatenated), teacher-forced
    on (a)'s tokens, held to (a) within MODEL_LIMIT, with two planted faults
    that must exceed it (one rank's partials dropped, the output slices
    gathered in another order); (c) the rail bytes a step at 8 rails of the
    resident path ((b)'s ranks) and of the gathered path (every sharded leaf
    gathered by the same ranks), each equal to ``rail_bytes_by_fsdp_dims``,
    and their ratio: a count of the ops each path runs at the fabric's ring
    counts, not traffic measured on the card (no fabric spans one card);
32. the control plane over the H100 calibration: (a) ``python -m
    repro_torch.launch.train`` on full-width h2o-danube-3-4b, mesh 1x1, 2
    steps, with ``--plane-report --ocs-latency 0.01``, as a subprocess on
    the card: exit 0 and the report printed; (b) llama3-8b's job on the
    16x16 and 2x16x16 meshes at OCS latencies of 1, 10, 50 and 100 ms:
    ``mesh_plane_profile``'s modeled step, its overhead over native EPS and
    its reconfigurations with the flat h100 MFU (equal to PLANE_PINNED, the
    JAX package's simulator's numbers) and with phase 30's fitted table
    (``SimParams(calibration=)``).
33. the decode backward (``csrc/decode_attention_bwd.cu``, one pass over
    the cache fed the forward's log-sum-exp and f32 output): (a) the kernel
    at llama3-8b's decode shape (B=8, a full 4096-slot cache, 32 heads on 8
    kv heads, dh 128) and paligemma-3b's (8 on one, dh 256), a ragged cache
    and f32 besides: dq, dk and dv held to the plain version's autograd by
    ``ref.grad_tolerance_ratio`` <= 1 through both routes to the residuals
    (the forward kernel's residual mode handed to the backward, and the
    backward's wrapper alone), two planted faults (the first split's dq
    partial dropped at the split the kernel takes, dk without the sum over
    a group's heads) that must read > 1, two calls bit-identical, masked
    slots exact zeros, the residual mode's rounded output the plain mode's
    bit for bit; the backward given the residuals timed beside its bound,
    the plain version and SDPA forward + backward, with its GB/s and the
    bytes of its dq partials, and the forward's residual mode beside the
    forward;
    (b) a decode step differentiated at full width on DECODE_GRAD_LAYERS
    of llama3-8b's and of paligemma-3b's layers (right after their decode
    phases): one forward and one backward launch a layer, every gradient
    (parameters and caches) within MODEL_LIMIT of the plain version's, a
    planted fault of the backward beyond it;
34. the dry-run (``launch.dryrun``): (a) DRYRUN_CELLS on the 16x16 and
    2x16x16 meshes on this machine's CPU (meta tensors over a fake process
    group), each through the dry-run's command line in a process of its
    own, all six at once, each status ok; (b) h2o-danube-3-4b training and
    llama3-8b prefill at B=1 S=4096 on a (1, 1) mesh, dry-run in this
    process (no process group outlives it) and then run on the card: the
    predicted peak over ``torch.cuda.max_memory_allocated``
    within FIT_BAND, the step no faster than the h100 roofline's bound;
35. the simulator: ``sim_points`` (the cost model at 2,048 GPUs, the
    planner's ``headline_points``, a small ``simulate_cluster`` and
    ``simulate_fleet``) equal to SIM_PINNED, the JAX package's numbers.

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
B=8 and a full 4096-slot cache), held to its plain version, with planted
faults that must fail the same check (the output's columns 128-255 zeroed,
S from the first 128 dims only; for the flash forward those of its design,
at every shape it runs: rows 64-127 of every 128-row q tile zeroed, the last
64-column panel zeroed, the last KV tile dropped).  And it runs the three
attention kernels at paligemma-3b's shapes (8 heads on one kv head, dh 256)
and seamless-m4t-medium's decoder's (16 on 16, dh 64): flash at B=1 S=4096,
its backward at the training step's B=1 and B=2, flash-decode at B=8 and a
full 4096-slot cache, each held to its plain version with a planted fault
that must fail the same check, and timed beside the bound, the plain
version and SDPA.

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
import os
import re
import shutil
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
# The bf16 flash forward's instantiations (csrc/flash_attention.cu): head-dim
# tiles 64, 128 and 256, each with blocks of one and of two consumer
# warpgroups (64- and 128-row q tiles).  Each must report the registers its
# plan names at launch (`setmaxnreg` hands the producer's to the consumers
# out of that allotment) and spill nothing.
FLASH_FWD_PLANS = tuple((dh, rows) for dh in (64, 128, 256) for rows in (64, 128))
NO_LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0, "decode_attention": 0,
               "decode_attention_bwd": 0, "decode_attention_stats": 0, "ssd_scan": 0,
               "ssd_scan_bwd": 0}
# The kernels of one flash_attention_bwd call (csrc/flash_attention_bwd.cu).
FLASH_BWD_PASSES = ("delta_kernel", "dkdv_kernel", "head_sum_kernel", "dq_kernel")
# The kernels of one decode_attention_bwd call (csrc/decode_attention_bwd.cu).
DECODE_BWD_PASSES = ("decode_bwd_kernel", "decode_bwd_dq_kernel")
# The bf16 flash-decode kernel's instantiations (csrc/decode_attention.cu,
# tma::decode_tma_kernel<head-dim tile, head groups>) and the decode shapes
# the script times it at, (B, C, H, KV, dh): llama3-8b, gemma-7b,
# paligemma-3b, the seamless decoder, the model-axis shares of llama3-8b and
# paligemma-3b, one rail shard (the stats variant) at 4096 and 32768 slots.
DECODE_FWD_PLANS = tuple((dh, hg) for dh in (64, 128, 256) for hg in (1, 2))
DECODE_SHAPES = ((8, 4096, 32, 8, 128), (8, 4096, 16, 16, 256), (8, 4096, 8, 1, 256),
                 (8, 4096, 16, 16, 64), (8, 4096, 4, 1, 128), (8, 4096, 1, 1, 256),
                 (1, 4096, 32, 8, 128), (1, 32768, 32, 8, 128))
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
# The CUDA kernels of one ssd_scan call (csrc/ssd_scan.cu), in launch order;
# the state and output passes run their products on `wgmma`.
SSD_PASSES = ("ssd_prep_kernel", "ssd_state_kernel", "ssd_combine_kernel", "ssd_output_kernel")
SSD_WGMMA_PASSES = ("ssd_state_kernel", "ssd_output_kernel")
# The CUDA kernels of one ssd_scan_bwd call (csrc/ssd_scan_bwd.cu), in launch order.
SSD_BWD_PASSES = ("ssd_bwd_local_kernel", "ssd_bwd_scan_kernel", "ssd_bwd_chunk_kernel",
                  "ssd_bwd_group_kernel", "ssd_bwd_da_kernel")
# SSM training (phase 19): mamba2-370m at full width and depth.  The hybrid
# family (phases 13 and 14): jamba-v0.1-52b at full width on HYBRID_LAYERS of
# its 32 (one period of the 1:7 pattern with its 4 MoE layers: 13.27 B
# parameters, 26.5 GB in bf16; all 32 layers, ~103 GB, do not fit the card).
SSM_TRAIN_ARCH, HYBRID_ARCH, HYBRID_LAYERS = "mamba2_370m", "jamba_v0_1_52b", 8
# The VLM and audio families (phases 15-18, 24 and 25), at full width and depth:
# paligemma-3b (2.51 B parameters; 8 heads on ONE kv head at dh 256, a prefix of
# 256 projected patches) and seamless-m4t-medium (0.98 B; a 12-layer encoder
# over 1024 frames, a 12-layer decoder of 16 heads on 16 at dh 64 with
# cross-attention), trained at B=1 and B=AUDIO_TRAIN_BATCH.
VLM_ARCH, AUDIO_ARCH, AUDIO_TRAIN_BATCH = "paligemma_3b", "seamless_m4t_medium", 2
VLM_ATTN, AUDIO_ATTN = (8, 1, 256), (16, 16, 64)  # heads, kv heads, head dim
# The rest of training (phase 26): a run resumed from its checkpoint ends at
# the uninterrupted run's loss within CKPT_RTOL; HSDP's int8 exchange moves
# the gradient norm by at most HSDP_GN_RTOL (the JAX package's tolerance for
# it, tests/test_train_step.py:60).  The checkpointed run takes the driver's
# AdamW (warmup 10) at CKPT_LR: at the driver's default 3e-4 four steps move
# mamba2-370m's loss by 5e-4 relative on an H100, and the control (the
# optimizer's step reset) read 1.3e-4, too near the limit to tell a fault.
CKPT_RTOL, HSDP_GN_RTOL, CKPT_LR = 1e-4, 0.02, 3e-3
# The pipeline (phase 29): h2o-danube-3-4b at full width and depth (24
# periods) as PIPE_STAGES stages of 6, PIPE_MICRO microbatches of one
# sequence of PIPE_SEQ tokens, SGD at PIPE_LR.  GPipe keeps every
# microbatch's activations until its backward: at 4 x 2048 the step peaks at
# 61.4 GiB on an H100 80GB (46 of them activations), so 4 x 4096 does not
# fit.  Its gradients are held to lm_loss's over the whole batch through the
# same kernels within PIPE_LIMIT relative RMS per leaf (bf16 gradients
# summed over the microbatches against one product over all their tokens),
# and the planted faults of the stages' hand-off must exceed it.
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ, PIPE_LR, PIPE_LIMIT = 4, 4, 2048, 0.1, MODEL_LIMIT
# Calibration (phase 30): the suite's timings and fitted table, in the JAX
# package's formats, under build/ (gitignored); the skips the JAX package
# makes by design, the only ones allowed.
CALIB_DIR = ROOT / "build"
CALIB_BY_DESIGN = ("non-positive depth difference", "non-positive step-minus-fwd")
# The control plane (phase 32): llama3-8b's training job on the paper's
# meshes, through ``sim.opus_sim.mesh_plane_profile`` at each OCS latency.
# Its flat-MFU numbers on the h100 profile, (modeled step s, overhead over
# native EPS, reconfigurations), are the JAX package's simulator's, pinned
# here and held to it on the CPU (tests/test_torch_plane.py).
PLANE_ARCH, PLANE_BATCH, PLANE_SEQ = "llama3_8b", 256, 4096
PLANE_MESHES = {"16x16": {"data": 16, "model": 16},
                "2x16x16": {"pod": 2, "data": 16, "model": 16}}
PLANE_LATENCIES = (0.001, 0.01, 0.05, 0.1)
PLANE_PINNED = {("16x16", lat): (0.509753, 0.000785, 0) for lat in PLANE_LATENCIES}
PLANE_PINNED.update({("2x16x16", lat): (0.295473, 0.001356, 0) for lat in PLANE_LATENCIES})


def log(*a):
    print(*a, flush=True)


def flash_tile(dh: int) -> int:
    """Keys per KV tile of the bf16 flash kernel at head dim ``dh``, from its
    library."""
    from repro_torch.kernels import flash_attention as fa
    return fa.KERNEL.lib().repro_flash_attention_kv_tile(1, dh)


def flash_q_tile(dh: int, b: int, s: int, h: int) -> int:
    """Query rows per block of the bf16 flash kernel at head dim ``dh`` and a
    call's B, S and H (64 where a grid of 64-row blocks fits one wave), from
    its library."""
    from repro_torch.kernels import flash_attention as fa
    return fa.KERNEL.lib().repro_flash_attention_q_tile(1, dh, b, s, h)


def last_tile_dropped(q, k, v, **kw):
    """A planted fault of a model's attention: the plain version with the
    last KV tile of the bf16 flash kernel (at k's head dim) dropped."""
    from repro_torch.kernels import ref
    return ref.mha(q, k, v, kv_valid_len=k.shape[1] - flash_tile(k.shape[-1]), **kw)


def decode_split(b: int, c: int, h: int, kv: int, dh: int) -> int:
    """Cache slots per split (one pass-1 block) of the bf16 flash-decode
    kernel at a call's shape, from its library's plan."""
    from repro_torch.kernels import decode_attention as da
    return da.KERNEL.lib().repro_decode_split(1, b, c, h, kv, dh)


def decode_tile(dh: int) -> int:
    """Cache slots of a tile of the bf16 flash-decode kernel (one TMA load of
    K and of V, the granularity of its mask) at head dim ``dh``."""
    from repro_torch.kernels import decode_attention as da
    return da.KERNEL.lib().repro_decode_plan(1, 1, dh, 0)


def decode_drops(b: int, c: int, h: int, kv: int, dh: int) -> list:
    """The slots that the planted faults of the bf16 flash-decode kernel's
    plan mask at a shape: [(label, first slot, end)] for one split from the
    middle of the cache (the whole second half where one split takes it)
    and one tile inside a split."""
    split, tile = decode_split(b, c, h, kv, dh), decode_tile(dh)
    lo = (c // 2 // tile + 1) * tile
    return [(f"one {split}-slot split dropped", c // 2, c // 2 + split),
            (f"one {tile}-slot tile dropped inside a split", lo, lo + tile)]


# the kernels of one flash-decode call, as torch.profiler names them
DECODE_KERNELS = ("decode_tma_kernel", "decode_partial_kernel", "decode_combine_kernel")


def is_decode_kernel(name: str) -> bool:
    return any(k in name for k in DECODE_KERNELS)


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
    scan the worse of y's and the final state's, for flash-decode's stats
    ``ref.stats_tolerance_ratio``: m, l, and acc / l as the output)."""
    from repro_torch.kernels import ops, ref
    mha, dec, ssd = ops.mha, ops.decode_attention, ops.ssd

    def checked_mha(q, k, v, **kw):
        out = mha(q, k, v, **kw)
        ratios.append(ref.tolerance_ratio(out, ref.mha(q, k, v, **kw)))
        return out

    def checked_dec(q, kc, vc, valid, **kw):
        out = dec(q, kc, vc, valid, **kw)
        want = ref.decode_attention(q, kc, vc, valid, **kw)
        ratios.append(ref.stats_tolerance_ratio(out, want, q.dtype) if kw.get("return_stats")
                      else ref.tolerance_ratio(out, want))
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


def sass_counts(kernel, opcodes) -> dict:
    """{function: {opcode: instructions}} in the SASS of ``kernel``'s built
    library (``cuobjdump -sass``, beside the nvcc that built it)."""
    from pathlib import Path

    from repro_torch.kernels import _build
    kernel.lib()
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(kernel._target())], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = dict.fromkeys(opcodes, 0)
        elif fn is not None:
            for op in opcodes:
                if re.search(rf"\b{op}\b", line):
                    out[fn][op] += 1
    return out


def phase_build():
    from repro_torch.kernels import _build, ops
    secs = _build.build_all(list(ops.KERNELS.values()))
    log(f"[build] all {len(ops.KERNELS)} kernels in {secs:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, k in ops.KERNELS.items():
        for fn, res in k.resources().items():
            log(f"[build] {name}: {fn}: {res}")
    fa_res = ops.KERNELS["flash_attention"].resources()
    fa_lib = ops.KERNELS["flash_attention"].lib()
    wg_fwd = {}
    for fn, res in fa_res.items():
        m = re.search(r"2wg16flash_fwd_kernelILi(\d+)ELi(\d)E", fn)
        if m:
            wg_fwd[(int(m[1]), 64 * int(m[2]))] = res
    if sorted(wg_fwd) != sorted(FLASH_FWD_PLANS):
        raise AssertionError(f"[build] bf16 wgmma flash forward instantiations (dh tile, q rows) "
                             f"in the ptxas log: {sorted(wg_fwd)}")
    for (dhp, rows), res in sorted(wg_fwd.items()):
        launch, producer, consumer, threads = (
            fa_lib.repro_flash_attention_regs(dhp, rows, role) for role in range(4))
        # a launch count other than the plan would leave the consumers
        # waiting for registers at setmaxnreg
        if res["registers"] != launch or res["spill_stores"]:
            raise AssertionError(f"[build] flash forward at dh {dhp}, {rows}-row blocks: {res}; "
                                 f"the plan is {launch} registers at launch and no spill")
        log(f"[build] flash forward at dh {dhp}, {rows}-row blocks: {threads} threads, "
            f"{res['registers']} registers a thread at "
            f"launch ({producer} for the producer warpgroup and {consumer} for each of "
            f"{rows // 64} consumer warpgroup(s) after setmaxnreg), {res['spill_stores']} B "
            f"spilled, {fa_lib.repro_flash_attention_smem_bytes(1, dhp, rows)} B of shared "
            f"memory, {flash_tile(dhp)}-key K/V tiles by TMA")
    # every 256-wide instantiation (flash forward, backward and decode, bf16 and f32)
    wide = {f"{name}: {fn}": res for name, k in ops.KERNELS.items()
            for fn, res in k.resources().items() if "Li256E" in fn}
    # forward 3 (f32, bf16 with one and two consumer warpgroups), backward
    # 4, decode pass 1: f32 3 bundle sizes, bf16 1 and 2 head groups; the
    # decode backward's one pass: 2 dtypes x 2 head paddings (8, 16)
    if len(wide) != 16:
        raise AssertionError(f"[build] 256-wide instantiations in the ptxas log: {sorted(wide)}")
    for fn, res in sorted(wide.items()):
        log(f"[build] dh 256: {fn[:110]}: {res['registers']} registers, {res['static_smem']} B "
            f"static shared memory, {res['spill_stores']} B spilled")
    spills = {fn: res for fn, res in wide.items() if res["spill_stores"]}
    if spills:
        raise AssertionError(f"[build] 256-wide instantiations spilling: {spills}")
    da_lib = ops.KERNELS["decode_attention"].lib()
    tma_fwd = {}
    for fn, res in ops.KERNELS["decode_attention"].resources().items():
        m = re.search(r"decode_tma_kernelILi(\d+)ELi(\d)E", fn)
        if m:
            tma_fwd[(int(m[1]), int(m[2]))] = res
    spills = {k: res for k, res in tma_fwd.items() if res["spill_stores"]}
    if sorted(tma_fwd) != sorted(DECODE_FWD_PLANS) or spills:
        raise AssertionError(f"[build] bf16 flash-decode instantiations (dh tile, head groups) "
                             f"in the ptxas log: {sorted(tma_fwd)}, spilling {spills}")
    for (dhp, hg), res in sorted(tma_fwd.items()):
        rep = 8 * hg
        tile, stages, threads, smem, per_sm = (da_lib.repro_decode_plan(1, rep, dhp, role)
                                               for role in range(5))
        log(f"[build] flash-decode bf16 at dh {dhp}, {hg} head group(s) of 8: {threads} "
            f"threads, {res['registers']} registers, {res['spill_stores']} B spilled, {smem} B "
            f"of shared memory ({per_sm} block(s) an SM), {stages} stages of {tile}-slot K/V "
            f"tiles by TMA")
    log("[build] flash-decode bf16 plan (B, C, H, KV, dh: slots a split x splits): " + "; ".join(
        f"{b}, {c}, {h}, {kv}, {dh}: {da_lib.repro_decode_split(1, b, c, h, kv, dh)} x "
        f"{da_lib.repro_decode_num_splits(1, b, c, h, kv, dh)}"
        for b, c, h, kv, dh in DECODE_SHAPES))
    dbwd = ops.KERNELS["decode_attention_bwd"].resources()
    missing = [k for k in DECODE_BWD_PASSES if not any(k in fn for fn in dbwd)]
    spills = {fn: res for fn, res in dbwd.items() if res["spill_stores"]}
    if missing or spills:
        raise AssertionError(f"[build] decode backward: passes missing from the ptxas log "
                             f"{missing}, spilling {spills}")
    if len(dbwd) != 14:  # 2 dtypes x 3 head-dim tiles x 2 head paddings, the dq sum x 2
        raise AssertionError(f"[build] decode backward instantiations: {sorted(dbwd)}")
    dbwd_lib = ops.KERNELS["decode_attention_bwd"].lib()
    regs = {}
    for fn, res in dbwd.items():  # decode_bwd_kernel<T, head-dim tile, padded heads>
        m = re.search(r"decode_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", fn)
        if m:
            regs[f"{'f32' if m[1] == 'f' else 'bf16'} {m[2]}/{m[3]}"] = res["registers"]
    log(f"[build] decode backward: all {len(DECODE_BWD_PASSES)} passes built ({len(dbwd)} "
        f"instantiations), no spills; registers (dtype tile/heads) " + ", ".join(
            f"{k} {v}" for k, v in sorted(regs.items())) + "; shared memory per block (bf16; "
        "rep 4 and 16 at dh 128, rep 8 at 256): " + ", ".join(
            str(dbwd_lib.repro_decode_bwd_smem_bytes(1, r, d))
            for r, d in ((4, 128), (16, 128), (8, 256))) + " B")
    ssd = ops.KERNELS["ssd_scan"].resources()
    missing = [k for k in SSD_PASSES if not any(k in fn for fn in ssd)]
    spills = {fn: res for fn, res in ssd.items() if res["spill_stores"]}
    if missing or spills:
        raise AssertionError(f"[build] ssd scan: passes missing from the ptxas log {missing}, "
                             f"spilling {spills}")
    # the passes that compute the state and y must run their products on
    # wgmma: HGMMA in the SASS of each instantiation (N tiles 32, 64, 128)
    hgmma = sass_counts(ops.KERNELS["ssd_scan"], ("HGMMA", "HMMA"))
    tc = {fn: c for fn, c in hgmma.items() if any(k in fn for k in SSD_WGMMA_PASSES)}
    if len(tc) != 2 * 3 or not all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in tc.values()):
        raise AssertionError(f"[build] ssd scan: state and output passes without HGMMA (or "
                             f"with mma.sync's HMMA) in their SASS: {tc}")
    log(f"[build] ssd scan: all {len(SSD_PASSES)} passes built, no spills; " + "; ".join(
        "{} at N tile {}: {} registers, {} HGMMA".format(
            *re.search(r"(state|output)_kernelILi(\d+)E", fn).groups(), ssd[fn]["registers"],
            c["HGMMA"]) for fn, c in sorted(tc.items()) if fn in ssd))
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
    tc_bwd = {fn: res for fn, res in bwd.items() if "2wg11dkdv_kernel" in fn
              or "2wg9dq_kernel" in fn}
    if len(tc_bwd) != 6:  # dk/dv and dq, each at dh 64, 128 and 256
        raise AssertionError(f"[build] flash backward: bf16 wgmma kernels in the ptxas "
                             f"log: {sorted(tc_bwd)}")
    bwd_lib = ops.KERNELS["flash_attention_bwd"].lib()
    for fn, res in sorted(tc_bwd.items()):
        dhp = int(re.search(r"ILi(\d+)E", fn).group(1))
        which = 0 if "dkdv" in fn else 1
        launch, producer, consumer, threads, blocks = (
            bwd_lib.repro_flash_attention_bwd_regs(which, dhp, role) for role in range(5))
        # setmaxnreg hands the producer warpgroup's registers to the consumers
        # out of the block's launch allotment: a launch count other than the
        # kernel's plan would leave the consumers waiting for registers
        if res["registers"] != launch:
            raise AssertionError(f"[build] flash backward {fn}: {res['registers']} registers "
                                 f"at launch, the kernel plans on {launch}")
        log(f"[build] flash backward {'dk/dv' if which == 0 else 'dq'} at dh {dhp}: "
            f"{threads} threads, {blocks} block(s) an SM, {res['registers']} registers a thread "
            f"at launch ({producer} for the producer warpgroup and {consumer} for each consumer "
            f"warpgroup after setmaxnreg), {res['spill_stores']} B spilled, "
            f"{bwd_lib.repro_flash_attention_bwd_smem_bytes(which, dhp)} B of shared memory, "
            f"{bwd_lib.repro_flash_attention_bwd_tile(3)} stages of "
            f"{bwd_lib.repro_flash_attention_bwd_tile(2) if which == 0 else bwd_lib.repro_flash_attention_bwd_dq_tile(dhp, 1)}"
            f"-row tiles by TMA")
    log(f"[build] flash backward: all {len(FLASH_BWD_PASSES)} kernels built, no spills; "
        f"{bwd_lib.repro_flash_attention_bwd_tile(0)}-key blocks (dk/dv), "
        f"{bwd_lib.repro_flash_attention_bwd_tile(1)}-row blocks (dq); paligemma-3b's 8 heads "
        f"on one kv head in {bwd_lib.repro_flash_attention_bwd_head_parts(1, 4096, 1, 8)} "
        f"parts, danube's 4 on each of 8 in "
        f"{bwd_lib.repro_flash_attention_bwd_head_parts(1, 4096, 8, 4)}")
    ssd_lib = ops.KERNELS["ssd_scan"].lib()
    log(f"[build] shared memory per block at dh=128: flash bf16 "
        f"{fa_lib.repro_flash_attention_smem_bytes(1, 128, 128)} B (128-row blocks, "
        f"{flash_tile(128)}-key tiles), f32 {fa_lib.repro_flash_attention_smem_bytes(0, 128, 64)} "
        f"B; decode pass 1 (rep=4) bf16 {da_lib.repro_decode_plan(1, 4, 128, 3)} B, f32 "
        f"{da_lib.repro_decode_plan(0, 4, 128, 3)} B; "
        f"ssd scan passes A, B, D: "
        f"{', '.join(str(ssd_lib.repro_ssd_scan_smem_bytes(i)) for i in (0, 1, 3))} B")
    log(f"[build] at dh=256: flash bf16 {fa_lib.repro_flash_attention_smem_bytes(1, 256, 128)} "
        f"B (128-row blocks, {flash_tile(256)}-key tiles, S formed once over all 256 columns), "
        f"f32 {fa_lib.repro_flash_attention_smem_bytes(0, 256, 64)} B; backward bf16 dk/dv "
        f"{bwd_lib.repro_flash_attention_bwd_smem_bytes(0, 256)} B, dq "
        f"{bwd_lib.repro_flash_attention_bwd_smem_bytes(1, 256)} B "
        f"({bwd_lib.repro_flash_attention_bwd_dq_tile(256, 0)}-row dq blocks, 64 rows a "
        f"warpgroup, {bwd_lib.repro_flash_attention_bwd_dq_tile(256, 1)}-key steps); "
        f"decode pass 1 (rep=1) bf16 {da_lib.repro_decode_plan(1, 1, 256, 3)} B, f32 "
        f"{da_lib.repro_decode_plan(0, 1, 256, 3)} B")


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
            (2, 1024, 32, 8, 64, bf16, None),
            (1, 4096, 1, 1, 256, bf16, None),     # a small grid: 64-row blocks
            (1, 4096, 4, 1, 120, bf16, 700)]:     # the same, windowed
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
    got = fa.flash_attention(q, k, v, causal=True)
    err, ratio = hold(f"[flash] main shape B={b} S={s} H={h} KV={kv} dh={dh} bf16 causal",
                      got, want)
    worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    ctrl = min(control(f"[flash] control: {label}", fault, want)
               for label, fault in flash_faults(q, k, v, got))
    del got
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_ratio = ref.tolerance_ratio(lib.transpose(1, 2), want)
    log(f"[flash] sdpa vs plain max_abs_err {max_err(lib.transpose(1, 2), want):.3g}, "
        f"{lib_ratio:.2f} of the tolerance (reported: SDPA rounds P to bf16 before P.V)")
    t = flash_times(q, k, v, "[flash]")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:36",
            "dh256": flash_at("[flash dh256]", 1, 4096, *GEMMA_ATTN, 21),
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
    causal q, k, v: CUDA events and device times and the bound. The FLOPs
    the kernel's tiles execute (``flash_executed_flops``: derived, not
    measured) go to the log only, never into the result."""
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
    bq, bk = flash_q_tile(dh, b, s, h), flash_tile(dh)
    executed = flash_executed_flops(b, s, h, dh)
    dev_ms = t["device_ms"] or t["ms"]
    log(f"{tag} {t['ms']:.3f} ms kernel, {t['plain_ms']:.3f} ms plain, {t['library_ms']:.3f} ms "
        f"sdpa (CUDA events; device time {t['device_ms']} / {t['plain_device_ms']} / "
        f"{t['library_device_ms']}), bound {t['bound_ms']:.4f} ms ({flops / 1e9:.1f} GFLOP "
        f"needed, {nbytes / 1e6:.1f} MB); {flops / dev_ms / 1e9:.1f} TFLOP/s needed, "
        f"{100 * t['bound_ms'] / dev_ms:.1f} % of the bound (device time)")
    log(f"{tag} derived from the kernel's {bq}-row blocks and {bk}-key tiles, S once and P.V "
        f"twice over the padded head dim, not measured: {executed / 1e9:.1f} GFLOP on the tensor "
        f"cores ({executed / flops:.2f}x the needed), {executed / dev_ms / 1e9:.1f} TFLOP/s at "
        f"the device time")
    return t


def flash_executed_flops(b, s, h, dh) -> int:
    """Derived, not measured: the tensor-core FLOPs of the bf16 flash forward
    at a causal shape with no window: every (q block, KV tile) pair its
    blocks visit (tiles from the library, dh padded to the kernel's 64, 128
    or 256), each 6 dh_pad FLOP a (query, key) pair: S once, P.V twice (P
    split into bf16 hi + lo)."""
    bq, bk = flash_q_tile(dh, b, s, h), flash_tile(dh)
    dhp = 64 if dh <= 64 else 128 if dh <= 128 else 256
    tiles = sum(-(-min(s, (i + 1) * bq) // bk) for i in range(-(-s // bq)))
    return 6 * b * h * tiles * bq * bk * dhp


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
        f"recomputes S and dP, P and dS are split hi + lo), "
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


def flash_at(tag: str, b, s, h, kv, dh, seed) -> dict:
    """The bf16 flash kernel at one model's prefill shape (causal): held to
    ``ref.mha``; planted faults of its design must fail the same check
    (``flash_faults``) and, at dh 256, S from the first 128 dims only; times
    beside the bound, the plain version and SDPA."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    shape = f"B={b} S={s} H={h} KV={kv} dh={dh} bf16 causal"
    q, k, v = flash_case(b, s, h, kv, dh, torch.bfloat16, seed=seed)
    want = ref.mha(q, k, v, causal=True)
    got = fa.flash_attention(q, k, v, causal=True)
    err, ratio = hold(f"{tag} {shape}", got, want)
    faults = flash_faults(q, k, v, got)
    if dh == 256:
        faults.append(("plain with S from the first 128 dims only",
                       ref.mha(upper_half_zeroed(q), k, v, causal=True, scale=dh ** -0.5)))
    ctrl = min(control(f"{tag} control: {label}", fault, want) for label, fault in faults)
    return {"shape": shape, "max_abs_err": err, "tolerance_ratio": ratio, "control_ratio": ctrl,
            **flash_times(q, k, v, tag)}


def flash_faults(q, k, v, got) -> list:
    """The planted faults of the bf16 flash forward's design at a causal
    call: the last KV tile dropped (the plain version), and the kernel's
    output with rows 64-127 of every 128-row q tile zeroed (a consumer
    warpgroup dropped) and with its last 64-column panel zeroed.  Tiles from
    the library.  Returns [(label, output)]."""
    import torch
    from repro_torch.kernels import ref
    tile = flash_tile(q.shape[-1])
    rows = got.clone()
    rows[:, torch.arange(got.shape[1], device=got.device) % 128 >= 64] = 0
    panel = got.clone()
    panel[..., (got.shape[-1] - 1) // 64 * 64:] = 0
    return [(f"plain with the last {tile}-key tile dropped",
             ref.mha(q, k, v, causal=True, kv_valid_len=k.shape[1] - tile)),
            ("the kernel's output with rows 64-127 of every 128-row q tile zeroed", rows),
            ("the kernel's output with its last 64-column panel zeroed", panel)]


def flash_bwd_at(tag: str, b, s, h, kv, dh, seed) -> dict:
    """The bf16 flash backward at one model's training shape (causal): the
    forward's o and lse, then dq, dk and dv held to ``ref.mha_bwd`` by
    ``ref.grad_tolerance_ratio``; the three planted faults of
    ``flash_bwd_faults`` and, at dh 256, those of its column split (each
    gradient's columns 128-255 zeroed; the gradients of attention whose S
    sees the first 128 dims only) must fail it; times beside the bound, the
    plain version and SDPA's backward."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    shape = f"B={b} S={s} H={h} KV={kv} dh={dh} bf16 causal"
    q, k, v = flash_case(b, s, h, kv, dh, torch.bfloat16, seed=seed)
    do = flash_case(b, s, h, kv, dh, torch.bfloat16, seed=seed + 10)[0]
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    o_w, lse_w = ref.mha_fwd_lse(q, k, v)
    hold(f"{tag} {shape}: forward o", o, o_w)
    lse_ratio = ref.lse_tolerance_ratio(lse, lse_w)
    log(f"{tag} forward lse {lse_ratio:.4f} of the tolerance")
    if not lse_ratio <= 1:
        raise AssertionError(f"{tag} the forward's lse disagrees with ref.mha_fwd_lse")
    got = fab.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.mha_bwd(q, k, v, o, lse, do)
    worst, worst_ratio = 0.0, 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, ratio = hold(f"{tag} {shape}: {name}", g, w, ref.grad_tolerance_ratio)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    faults = flash_bwd_faults(q, k, v, o, lse, do, want)
    if dh == 256:
        faults += [(f"the kernel's {name} with columns 128-255 zeroed", upper_half_zeroed(g), w)
                   for name, g, w in zip(("dq", "dk", "dv"), got, want)]
    del got
    ctrl = min(control(f"{tag} control: {label}", fault, w, ref.grad_tolerance_ratio)
               for label, fault, w in faults)
    del faults
    if dh == 256:
        qh = upper_half_zeroed(q)
        s_half = ref.mha_bwd(qh, k, v, *ref.mha_fwd_lse(qh, k, v, scale=dh ** -0.5), do,
                             scale=dh ** -0.5)
        s_ratio = max(ref.grad_tolerance_ratio(g, w) for g, w in zip(s_half, want))
        log(f"{tag} control: plain with S from the first 128 dims only: worst of dq, dk, dv "
            f"{s_ratio:.1f} x the tolerance (must exceed 1)")
        if not s_ratio > 1:
            raise AssertionError(f"{tag} the tolerance does not see S from 128 dims")
        ctrl = min(ctrl, s_ratio)
        del s_half
    del want
    return {"shape": shape, "max_abs_err": worst, "tolerance_ratio": worst_ratio,
            "control_ratio": ctrl, "forward_lse_tolerance_ratio": lse_ratio,
            **flash_bwd_times(q, k, v, o, lse, do, tag)}


def decode_at(tag: str, b, c, h, kv, dh, seed) -> dict:
    """The bf16 flash-decode kernel at one model's decode shape (a full cache
    of ``c`` slots): held to ``ref.decode_attention``; planted faults must
    fail the same check: one split and one tile of the kernel's plan at this
    shape dropped (``decode_drops``) and, at dh 256, the output's columns
    128-255 zeroed and S from the first 128 dims only; times beside the
    bound, the plain version and SDPA."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    shape = f"B={b} C={c} H={h} KV={kv} dh={dh} bf16, all slots valid"
    q, kc, vc, valid = decode_inputs(b, c, h, kv, dh, torch.bfloat16, "all", seed=seed)
    want = ref.decode_attention(q, kc, vc, valid)
    got = da.decode_attention(q, kc, vc, valid)
    err, ratio = hold(f"{tag} {shape}", got, want)
    log(f"{tag} plan: {decode_split(b, c, h, kv, dh)}-slot splits of {decode_tile(dh)}-slot "
        f"tiles")
    faults = []
    for label, lo, hi in decode_drops(b, c, h, kv, dh):
        dropped = valid.clone()
        dropped[:, lo:hi] = False
        faults.append((f"plain with {label}", ref.decode_attention(q, kc, vc, dropped)))
    if dh == 256:
        faults += [("the kernel's output with columns 128-255 zeroed", upper_half_zeroed(got)),
                   ("plain with S from the first 128 dims only",
                    ref.decode_attention(upper_half_zeroed(q), kc, vc, valid, scale=dh ** -0.5))]
    ctrl = min(control(f"{tag} control: {label}", fault, want) for label, fault in faults)
    return {"shape": shape, "max_abs_err": err, "tolerance_ratio": ratio, "control_ratio": ctrl,
            **decode_times(q, kc, vc, valid, tag)}


def decode_bwd_parts(q, kc, vc, valid, do, scale=None):
    """The plain backward of flash-decode, written out in f32: (q and do as
    [B,KV,R,dh], P and dS [B,KV,R,C], the scale)."""
    import torch
    from repro_torch.kernels import ref
    b, _, h, dh = q.shape
    kv = kc.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    qr = q.reshape(b, kv, h // kv, dh).float()
    dor = do.reshape(b, kv, h // kv, dh).float()
    s = torch.einsum("bgrd,bcgd->bgrc", qr, kc.float()) * scale
    p = torch.where(valid[:, None, None, :], s, ref.NEG_INF).softmax(-1)
    dp = torch.einsum("bgrd,bcgd->bgrc", dor, vc.float())
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return qr, dor, p, ds, scale


def decode_bwd_faults(q, kc, vc, valid, do, want, split: int):
    """Two planted faults of the decode backward, emulated from the plain
    version's P and dS: dq without the first ``split``-slot split's partial,
    and, where a kv head has more than one query head, dk from the first
    query head of each group only (the sum over the group's heads skipped).
    Returns [(label, gradient, the plain version's)]."""
    import torch
    qr, _, _, ds, scale = decode_bwd_parts(q, kc, vc, valid, do)
    part = torch.einsum("bgrc,bcgd->bgrd", ds[..., :split], kc[:, :split].float()) * scale
    dq = (want[0].float() - part.reshape(want[0].shape)).to(want[0].dtype)
    faults = [(f"dq without the first {split}-slot split's partial", dq, want[0])]
    if qr.shape[2] > 1:
        dk = (torch.einsum("bgc,bgd->bcgd", ds[:, :, 0], qr[:, :, 0]) * scale).to(want[1].dtype)
        faults.append(("dk from each group's first query head only", dk, want[1]))
    return faults


def phase_family_kernels(kernels: list) -> None:
    """The three attention kernels at the VLM's and the audio decoder's
    shapes: flash at their prefill (B=1, S=4096), its backward at their
    training step (B=1 and B=2, S=4096), flash-decode at B=8 and a full
    4096-slot cache; each entry of ``kernels`` gains a "paligemma" and a
    "seamless" entry."""
    for name, attn_shape, train_b, seed in (("paligemma", VLM_ATTN, 1, 41),
                                            ("seamless", AUDIO_ATTN, AUDIO_TRAIN_BATCH, 51)):
        kernels[0][name] = flash_at(f"[flash {name}]", 1, 4096, *attn_shape, seed)
        kernels[1][name] = flash_bwd_at(f"[flash bwd {name}]", train_b, 4096, *attn_shape,
                                        seed + 1)
        kernels[2][name] = decode_at(f"[decode {name}]", 8, 4096, *attn_shape, seed + 2)


def flash_bwd_faults(q, k, v, o, lse, do, want):
    """The planted faults of the backward, emulated in the plain version: one
    key tile's dk/dv dropped, one q tile's dq dropped, one q tile's share of
    every dk/dv dropped (its rows of do zeroed) and, where the dk/dv pass
    splits a group's query heads in parts, one part's share of dk and dv
    dropped (its heads' do zeroed).  Tiles and parts from the library.
    Returns [(label, gradient, the plain version's)]."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    lib = fab.KERNEL.lib()
    bk, bq, step = (lib.repro_flash_attention_bwd_tile(i) for i in range(3))
    b, s, h, _ = q.shape
    kv = k.shape[2]
    dk, dq = want[1].clone(), want[0].clone()
    dk[:, s // 2:s // 2 + bk] = 0
    dq[:, s // 2:s // 2 + bq] = 0
    do_f = do.clone()
    do_f[:, s // 2:s // 2 + step] = 0
    _, dk_q, _ = ref.mha_bwd(q, k, v, o, lse, do_f, causal=True)
    faults = [(f"one {bk}-key tile's dk dropped", dk, want[1]),
              (f"one {bq}-row tile's dq dropped", dq, want[0]),
              (f"one {step}-row q tile's share of every dk dropped", dk_q, want[1])]
    parts = lib.repro_flash_attention_bwd_head_parts(b, s, kv, h // kv)
    if parts > 1:
        per = h // kv // parts
        do_p = do.unflatten(2, (kv, h // kv)).clone()
        do_p[:, :, :, per:2 * per] = 0  # the second part of every group
        _, dk_p, dv_p = ref.mha_bwd(q, k, v, o, lse, do_p.flatten(2, 3), causal=True)
        faults += [(f"one of {parts} head parts' dk dropped", dk_p, want[1]),
                   (f"one of {parts} head parts' dv dropped", dv_p, want[2])]
    return faults


def flash_bwd_executed_flops(b, s, h, kv, dh) -> int:
    """Derived, not measured: the tensor-core FLOPs of every whole tile pair
    the bf16 backward kernels visit at a causal shape with no window (tiles
    from the library, dh padded to the kernel's 64, 128 or 256): 12 dh_pad a
    (query, key) pair in dk/dv (S^T and dP^T once, dv and dk each twice: P and
    dS split hi + lo) and 8 dh_pad in dq (S and dP, dq twice), the dq pass
    walking the key tiles of a whole block's rows with each of its
    warpgroups."""
    from repro_torch.kernels import flash_attention_bwd as fab
    lib = fab.KERNEL.lib()
    bk, bq_kv = lib.repro_flash_attention_bwd_tile(0), lib.repro_flash_attention_bwd_tile(2)
    rr, xr = (lib.repro_flash_attention_bwd_dq_tile(dh, i) for i in range(2))
    dhp = 64 if dh <= 64 else 128 if dh <= 128 else 256
    n_q = -(-s // bq_kv)
    kv_pairs = sum(n_q - (kt * bk) // bq_kv for kt in range(-(-s // bk))) * (h // kv)
    dq_pairs = sum(-(-min(s, (qt + 1) * rr) // xr) for qt in range(-(-s // rr))) * rr * xr
    return b * (kv * kv_pairs * bk * bq_kv * 12 + h * dq_pairs * 8) * dhp


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
            "replaces": "src/repro/kernels/flash_attention.py:140",
            "dh256": flash_bwd_at("[flash bwd dh256]", 1, 4096, *GEMMA_ATTN, 22),
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
    log(f"[decode] main shape plan: {decode_split(b, c, h, kv, dh)}-slot splits of "
        f"{decode_tile(dh)}-slot tiles")
    ctrl = float("inf")
    for label, lo, hi in decode_drops(b, c, h, kv, dh):
        dropped = valid.clone()
        dropped[:, lo:hi] = False
        ctrl = min(ctrl, control(f"[decode] control: plain with {label}",
                                 ref.decode_attention(q, kc, vc, dropped), want))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
    am = valid[:, None, None, :]
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, enable_gqa=True)
    lib_ratio = ref.tolerance_ratio(lib.transpose(1, 2), want)
    log(f"[decode] sdpa vs plain max_abs_err {max_err(lib.transpose(1, 2), want):.3g}, "
        f"{lib_ratio:.2f} of the tolerance (reported)")
    t = decode_times(q, kc, vc, valid, "[decode]")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:29",
            "dh256": decode_at("[decode dh256]", 8, 4096, *GEMMA_ATTN, 23),
            "max_abs_err": worst, "tolerance": "1e-5 + 2^-7 |plain| (bf16)",
            "tolerance_ratio": worst_ratio, "control_ratio": ctrl,
            "library_tolerance_ratio": lib_ratio, **t,
            "shape": f"B={b} C={c} H={h} KV={kv} dh={dh} bf16, all slots valid"}


def _first_periods(params, n: int):
    """The same weights cut to the first ``n`` periods (views, no copies), an
    encoder's stack too."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[:n]
    out = dict(params, layers=[cut(lp) for lp in params["layers"]])
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"],
                              layers=[cut(lp) for lp in params["encoder"]["layers"]])
    return out


def depth_cut(cfg, params, n: int) -> tuple:
    """(the configuration, the same weights) cut to ``n`` layers, an
    encoder-decoder's encoder to ``n`` layers too."""
    import dataclasses
    cut = cfg.replace(n_layers=n)
    if cfg.encoder is not None:
        cut = cut.replace(encoder=dataclasses.replace(cfg.encoder, n_layers=n))
    return cut, _first_periods(params, n)


def family_batch(cfg, b: int, s: int, gen) -> dict:
    """Tokens on the card from ``gen`` and, after them, a VLM's patches or an
    encoder-decoder's frames [B, n_tokens, d_embed] (f32 normal, as
    ``synth_batch`` makes them).  A VLM's ``s`` positions count its patches:
    its text is ``s`` less them."""
    import torch
    n_text = s - cfg.frontend.n_tokens if cfg.family == "vlm" else s
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, n_text), generator=gen,
                                     device="cuda")}
    extra = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
    if extra:
        batch[extra] = torch.randn((b, cfg.frontend.n_tokens, cfg.frontend.d_embed),
                                   generator=gen, device="cuda")
    return batch


@contextlib.contextmanager
def causal_prefix_sdpa():
    """A planted fault of the prefix-LM: the prefix block's bidirectional
    sdpa made causal (a swap only this script makes, as ``swapped_ops``).
    Only a VLM's prefix block calls ``sdpa`` without a mask on the flash
    path."""
    from repro_torch.models import attention as attn
    sdpa = attn.sdpa

    def causal(q, k, v, *, mask=None, scale=None):
        if mask is None:
            mask = attn.make_mask(q.shape[1], k.shape[1], causal=True, window=None,
                                  device=q.device)
        return sdpa(q, k, v, mask=mask, scale=scale)
    attn.sdpa = causal
    try:
        yield
    finally:
        attn.sdpa = sdpa


def first_slot_dropped_ops():
    """A planted fault of decode: every step's first cache slot masked off
    (where one kv head serves every query head, shifting the kv heads is no
    fault)."""
    from repro_torch.kernels import ref

    def dec(q, kc, vc, valid, **kw):
        valid = valid.clone()
        valid[:, 0] = False
        return ref.decode_attention(q, kc, vc, valid, **kw)
    return swapped_ops(mha=ref.mha, decode_attention=dec, ssd=ref.ssd_chunked)


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
    dropped = position_rel_rms(run(swapped_ops(mha=last_tile_dropped))[0][agree], want_a)
    log(f"[{tag}] depth 2, full width, {tokens.shape[1]} positions: routed (token, k) choices "
        f"through the kernels that the plain versions did not make {100 * flips:.4f} % (limit "
        f"{100 * MOE_FLIP_LIMIT:.0f} %); {n_agree} positions route alike at both layers; "
        f"worst relative RMS of the logits over those, kernels vs plain {rel:.3g} (limit "
        f"{MODEL_LIMIT}; over all positions {rel_all:.3g}, reported); controls over the same "
        f"positions: heads shifted {shifted:.3g}, last KV tile dropped {dropped:.3g} "
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
    faults = {}
    for key, ctx in (("chunks_independent", lambda: swapped_ops(ssd=ssd_chunks_independent)),
                     ("shifted_heads", shifted_heads_ops),
                     ("tile_dropped", lambda: swapped_ops(mha=last_tile_dropped))):
        with plain_ops(), ctx(), replayed_routing(r_got):
            faults[key] = position_rel_rms(logits(), want)
    log(f"[{tag}] {cfg8.n_layers} layers, full width, {tokens.shape[1]} positions, the plain "
        f"versions routed as the kernels routed: (token, k) choices of the plain router that "
        f"the kernels did not make {100 * flips:.4f} % (limit {100 * MOE_FLIP_LIMIT:.0f} %); "
        f"worst position's relative RMS of the logits, kernels vs plain {rel:.3g} (limit "
        f"{MODEL_LIMIT}); controls on the plain versions: every chunk's entering state "
        f"dropped {faults['chunks_independent']:.3g}, kv heads shifted "
        f"{faults['shifted_heads']:.3g} (each must exceed the limit), last KV tile "
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


def prefill_flops(cfg, s: int, logit_positions: int = 1) -> tuple:
    """(needed, executed) model FLOPs of a B=1 forward over ``s`` decoder
    positions (a VLM's patches among them): the projections, causal
    attention, dense FFNs, the logits of the last ``logit_positions``
    positions (a prefill's one) and, in an MoE model, the router, the routed
    experts (the K a token chooses; executed: every expert's buffer padded to
    its capacity) and shared experts; a Mamba-2 layer's in- and
    out-projections (its scan is not counted).  A VLM adds its patch
    projection and the pairs above the diagonal of its prefix block
    (executed: the whole block again, in the prefix's sdpa); an
    encoder-decoder its frame projection, its encoder's layers (non-causal
    attention over the frames) and each decoder layer's cross-attention (q
    and output projections, K/V projections of the encoder's output,
    attention over the frames).  Derived from the shapes, not measured."""
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.moe import moe_capacity
    d = cfg.d_model
    n_attn, n_ssm = n_mixers(cfg)
    n_moe = sum(cfg.layer_has_moe(i) for i in range(cfg.n_layers))
    common = ((cfg.n_layers - n_moe) * 2 * s * 3 * d * cfg.d_ff
              + 2 * d * padded_vocab(cfg) * logit_positions)
    prefix_extra = 0
    if n_attn:
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        common += n_attn * (2 * s * d * (2 * h + 2 * kv) * dh + 4 * h * dh * s * (s + 1) // 2)
    if cfg.frontend is not None:
        t = cfg.frontend.n_tokens
        common += 2 * t * cfg.frontend.d_embed * d
        if cfg.family == "vlm":
            common += n_attn * 4 * h * dh * t * (t - 1) // 2
            prefix_extra = n_attn * 4 * h * dh * t * t
        if cfg.encoder is not None:
            e = cfg.encoder
            eh, ekv, edh = e.n_heads, e.n_kv_heads, e.d_model // e.n_heads
            common += e.n_layers * (2 * t * e.d_model * (2 * eh + 2 * ekv) * edh
                                    + 4 * eh * edh * t * t + 2 * t * 3 * e.d_model * e.d_ff)
            common += n_attn * (2 * s * d * 2 * h * dh + 2 * t * d * 2 * kv * dh
                                + 4 * h * dh * s * t)
    if n_ssm:
        e = cfg.ssm.expand * d
        heads, gn = e // cfg.ssm.head_dim, cfg.ssm.n_groups * cfg.ssm.state_dim
        common += n_ssm * (2 * s * d * (2 * e + 2 * gn + heads) + 2 * s * e * d)
    if not n_moe:
        return common, common + prefix_extra
    m = cfg.moe
    de = m.d_expert if m.d_expert is not None else cfg.d_ff
    common += n_moe * (2 * s * d * m.n_experts + 2 * s * 3 * d * de * m.n_shared_experts)
    expert = 2 * 3 * d * de
    return (common + n_moe * s * m.top_k * expert,
            common + n_moe * m.n_experts * moe_capacity(m, s) * expert)


def phase_prefill(cfg, params, tag: str = "prefill", prefix: str = ""):
    """Prefill at B=1 S=4096 (a VLM: 256 patches and 3840 text tokens; an
    encoder-decoder: 4096 decoder tokens over 1024 frames); the result's keys
    start with ``prefix``.  Each decoder attention layer launches the flash
    kernel once, each Mamba-2 layer the SSD scan (an encoder's non-causal
    attention and the cross-attention are plain, as in the JAX package).
    The check of the logits is at depth 2 (a dense, VLM or encoder-decoder
    model, the encoder cut to 2 layers too; an MoE one with its routing
    recorded), or over one whole period of a hybrid's pattern (its faults:
    every chunk's entering state dropped, the last KV tile dropped)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import padded_vocab
    from repro_torch.serve.step import ServeSetup, make_prefill_step
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = family_batch(cfg, 1, 4096, gen)
    tokens = batch["tokens"]
    step = make_prefill_step(ServeSetup(cfg=cfg), (1, 1), params)
    n_attn, n_ssm = n_mixers(cfg)
    want_counts = {**NO_LAUNCHES, "flash_attention": n_attn, "ssd_scan": n_ssm}
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        if counts != want_counts:
            raise AssertionError(f"prefill launches {counts}, want {want_counts}")
    if logits.shape != (1, 1, padded_vocab(cfg)) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite/shaped")
    inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers B=1 S=4096 ({inputs}): {times[0]:.1f} ms "
        f"first, {times[1]:.1f} ms second; flash launches {counts['flash_attention']}"
        + (f", ssd launches {counts['ssd_scan']}" if n_ssm else ""))
    busy, dev = device_profile(lambda: step(params, batch), f"{tag} B=1 S=4096")
    if dev:
        needed, executed = prefill_flops(cfg, 4096)
        dev_ms = sum(dev.values())
        log(f"[{tag}] model FLOPs, derived from the shapes, not measured: {needed / 1e12:.2f} T "
            f"needed, {executed / 1e12:.2f} T executed"
            + (" (each expert's buffer padded to its capacity)" if cfg.moe else "")
            + ("; the SSD scan's FLOPs not counted" if n_ssm else "")
            + ("; the prefix block's sdpa again" if cfg.family == "vlm" else "")
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
        step(params, batch)
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

    # depth 2, full width: logits at every (text) position through the
    # kernels, the plain versions and planted faults
    cfg2, p2 = depth_cut(cfg, params, 2)
    if cfg.moe:
        out.update(moe_prefill_depth2(cfg2, p2, tokens, tag))
        return {prefix + k: v for k, v in out.items()}

    def all_logits(b=batch):
        return tf.lm_forward(p2, b, cfg2)[0]
    got = all_logits()
    with plain_ops():
        want = all_logits()
    rel = position_rel_rms(got, want)
    faults = {"tile_dropped": ("last KV tile dropped",
                               lambda: swapped_ops(mha=last_tile_dropped))}
    if cfg.n_kv_heads > 1:  # with one kv head, shifting the kv heads is the identity
        faults["shifted_heads"] = ("heads shifted", shifted_heads_ops)
    if cfg.family == "vlm":
        faults["prefix_causal"] = (f"the {cfg.frontend.n_tokens}-row prefix block causal",
                                   causal_prefix_sdpa)
    ctrl = {}
    for key, (_, ctx) in faults.items():
        with ctx():
            ctrl[key] = position_rel_rms(all_logits(), want)
    frames = None
    if cfg.encoder is not None:  # the encoder reaches the logits
        frames = position_rel_rms(all_logits(dict(batch, frames=batch["frames"] + 1.0)), got)
    del got
    log(f"[{tag}] depth 2{' (and 2 encoder layers)' if cfg.encoder else ''}, full width, all "
        f"{want.shape[1]} text positions, worst position's relative RMS of the logits: kernels "
        f"vs plain {rel:.3g} (limit {MODEL_LIMIT}); controls: "
        + ", ".join(f"{label} {ctrl[k]:.3g}" for k, (label, _) in faults.items())
        + " (each must exceed the limit)"
        + (f"; the frames + 1 against the kernels' own logits {frames:.3g} (must exceed the "
           f"limit: the encoder reaches the logits)" if frames is not None else ""))
    if not (rel <= MODEL_LIMIT < min(ctrl.values())
            and (frames is None or frames > MODEL_LIMIT)):
        raise AssertionError(f"depth-2 prefill: kernels {rel}, controls {ctrl}, frames {frames}")
    out.update({"prefill_depth2_rel_rms": rel, "prefill_depth2_frames_moved": frames,
                **{f"prefill_depth2_{k}": v for k, v in ctrl.items()}})
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


def decode_steps(cfg, step, params, state, first: int, n: int, tok, forced_tokens=None,
                 cross=None):
    """``n`` steps of ``step`` from position ``first``, teacher-forced on the
    columns of ``forced_tokens`` while they last, then greedy; each step must
    launch the flash-decode kernel once per (self-)attention layer.  ``state``
    is updated in place; an encoder-decoder's steps take ``cross``.  Returns
    (seconds, the logits of each step, decode launches)."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = []
    t0 = time.perf_counter()
    for i in range(n):
        if forced_tokens is not None and i < forced_tokens.shape[1]:
            tok = forced_tokens[:, i:i + 1]
        logits, _ = step(params, state, tok, first + i, cross)
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


def dense_decode_depth2(cfg, params, prompt, cap: int, tag: str, frames=None) -> tuple:
    """Depth 2, full width: the cache built token by token through the
    kernel must give the logits of every teacher-forced position that the
    plain version and the prefill give (an encoder-decoder's over the cross
    state of ``frames``, its encoder cut to 2 layers too; a VLM's text-only
    decode has no prefill to match: its prefill always has patches); a
    planted fault (heads shifted; with one kv head, the first cache slot
    dropped) must not.  Returns (vs plain, vs prefill or None, the fault's)."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import ServeSetup, init_serve_state
    cfg2, p2 = depth_cut(cfg, params, 2)
    b, n = prompt.shape
    cross = None
    if frames is not None:
        cross = tf.init_cross_state(p2, tf.encode(p2, frames, cfg2), cfg2)

    def forced_logits():
        st = init_serve_state(ServeSetup(cfg=cfg2), (1, 1), p2, b, cap)
        out = []
        for t in range(n):
            lg, st = tf.decode_step(p2, st, prompt[:, t:t + 1], t, cfg2, cross_state=cross)
            out.append(lg)
        return torch.cat(out, 1)
    got = forced_logits()
    with plain_ops():
        plain = forced_logits()
    fault = "heads shifted" if cfg.n_kv_heads > 1 else "first cache slot dropped"
    with (shifted_heads_ops() if cfg.n_kv_heads > 1 else first_slot_dropped_ops()):
        shifted = position_rel_rms(forced_logits(), plain)
    e_plain, e_pre = position_rel_rms(got, plain), None
    if cfg.family != "vlm":
        batch = {"tokens": prompt} if frames is None else {"tokens": prompt, "frames": frames}
        e_pre = position_rel_rms(got, tf.lm_forward(p2, batch, cfg2)[0])
    log(f"[{tag}] depth 2, full width, {b}x{n} positions, worst position's relative "
        f"RMS of the logits: kernel vs plain {e_plain:.3g}, vs prefill "
        f"{'none (text-only decode)' if e_pre is None else f'{e_pre:.3g}'} (limit "
        f"{MODEL_LIMIT}); control: {fault} {shifted:.3g} (must exceed the limit)")
    if not (e_plain <= MODEL_LIMIT and (e_pre or 0.0) <= MODEL_LIMIT < shifted):
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
    kernel_ms = sum(ms for key, ms in dev.items() if is_decode_kernel(key))
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


def decode_floor_ms(cfg, params, state, n_valid: int, cross=None) -> float:
    """The least device time of one decode step: every parameter read once
    (all of them: at one token a group every expert of an MoE layer gets a
    buffer) but an untied embedding table, of which a step gathers B rows (a
    tied one is read whole as the unembedding), and an encoder-decoder's
    encoder and frame projection, which decode does not run; the K/V of the
    ``n_valid`` valid slots of every attention layer's cache, the cross
    state, and every Mamba-2 layer's conv window and state, at the card's
    memory rate."""
    from repro_torch.tree import leaves
    unread = [params[k] for k in ("encoder", "frontend_proj") if k in params]
    if not cfg.tie_embeddings:
        unread.append(params["embed"])
    weights = sum(t.numel() * t.element_size() for t in leaves(params))
    weights -= sum(t.numel() * t.element_size() for t in leaves(unread))
    weights += sum(t.numel() * t.element_size() for t in leaves(cross or []))
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
    and each decode launch of one step held against the plain version.  An
    encoder-decoder decodes over ``init_cross_state`` of 1024 frames a
    sequence (a seeded draw after the prompt) through its whole encoder; a
    VLM decodes text only from an empty cache, as the serve driver does.
    Log lines start with ``[tag]``, result keys with its words joined by _."""
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
    frames = cross = None
    if cfg.encoder is not None:
        frames = torch.randn((b, cfg.frontend.n_tokens, cfg.frontend.d_embed), generator=gen,
                             device="cuda")
        cross = tf.init_cross_state(params, tf.encode(params, frames, cfg), cfg)
        log(f"[{tag}] cross state of {tuple(frames.shape)} frames through the "
            f"{cfg.encoder.n_layers}-layer encoder: {len(cross)} x "
            f"{tuple(cross[0]['k'].shape)} K and V")
    steps = n_forced + n_gen
    out, tok, deep = {}, None, None
    for label, first, n, forced in (("a", 0, steps, prompt), ("b", cap - 32, 16, None)):
        if label == "b":
            fill_cache(state, first, seed=5)
        secs, logits, launches = decode_steps(cfg, step, params, state, first, n, tok, forced,
                                              cross)
        tok = logits[-1].argmax(-1)
        if label == "a" and cfg.family != "vlm":
            batch = {"tokens": prompt} if frames is None else {"tokens": prompt, "frames": frames}
            want, _ = tf.lm_forward(params, batch, cfg)
            deep = position_rel_rms(torch.cat(logits[:n_forced], 1), want)
            del want
        filled = first + n + 1
        busy, dev = device_profile(lambda: decode_steps(cfg, step, params, state, first + n, 2,
                                                        tok, cross=cross),
                                   f"{tag} 2 steps B={b} cap={cap}, {filled} filled slots")
        dev_ms = sum(dev.values()) / 2 if dev else None
        kernel_ms = sum(ms for k_, ms in dev.items() if is_decode_kernel(k_)) / 2
        floor = decode_floor_ms(cfg, params, state, filled, cross)
        log(f"[{tag}] ({label}) {cfg.name} B={b} cap={cap}, from {first} filled slots: {n} "
            f"steps, {secs / n * 1e3:.2f} ms/step (host), {b * n / secs:.1f} tok/s; device "
            f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms/step (flash-decode "
            f"{kernel_ms:.3f} ms), floor {floor:.3f} ms/step (every weight and the valid K/V"
            f"{' and the cross state' if cross else ''} read once at "
            f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s); decode launches {launches}")
        out.update({f"{key}{label}_ms_per_step": secs / n * 1e3,
                    f"{key}{label}_tok_s": b * n / secs,
                    f"{key}{label}_device_ms_per_step": dev_ms,
                    f"{key}{label}_flash_decode_device_ms_per_step": kernel_ms,
                    f"{key}{label}_floor_ms": floor, f"{key}{label}_device_busy": busy,
                    f"{key}{label}_launches": launches, f"{key}{label}_steps": n})
    if deep is not None:
        log(f"[{tag}] {cfg.n_layers} layers, {b}x{n_forced} teacher-forced positions vs the "
            f"prefill of the prompt: worst position's relative RMS {deep:.3g} (reported, not "
            f"checked)")
    n_attn, n_ssm = n_mixers(cfg)
    if cfg.moe:  # a hybrid's check takes one whole period of its pattern
        out.update(moe_decode_depth2(cfg, params, prompt, cap,
                                     len(tf.period_spec(cfg)) if n_ssm else 2))
    else:
        e_plain, e_pre, fault = dense_decode_depth2(cfg, params, prompt, cap, tag, frames)
        fault_key = "shifted_heads" if cfg.n_kv_heads > 1 else "first_slot_dropped"
        out.update({f"{key}depth2_rel_rms": e_plain, f"{key}depth2_vs_prefill": e_pre,
                    f"{key}depth2_{fault_key}": fault})
    ratios = []
    with checked_ops(ratios):
        step(params, state, tok, cap - 32 + 18, cross)
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


def ssd_heads_swapped(x, dt, a, bm, cm, chunk, h_init=None):
    """A planted fault: the plain scan with heads 0 and 1 fed each other's x
    (one head of a block of the kernel reading its neighbour's x tile)."""
    from repro_torch.kernels import ref
    xs = x.clone()
    xs[:, :, [0, 1]] = x[:, :, [1, 0]]
    return ref.ssd_chunked(xs, dt, a, bm, cm, chunk, h_init=h_init)


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


def ssd_fwd_bound(b, s, h, p, g, n, chunk) -> tuple:
    """(FLOPs, bytes) the SSD scan needs, derived from the shapes: each input
    read once and each output written once (f32); the least operations, C
    B^T once per group and chunk (causal halves), the state read and the
    state update."""
    nc, L = -(-s // chunk), chunk
    nbytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * g * n + b * h * p * n + h)
    flops = b * nc * (g * L * (L + 1) * n + h * (L * (L + 1) * p + 4 * L * n * p))
    return flops, nbytes


def ssd_executed_flops(b, s, h, p, g, n, chunk) -> int:
    """Derived, not measured: the FLOPs the SSD kernel's wgmma tiles run on
    the tensor cores (csrc/ssd_scan.cu: a block of two heads of a group a
    chunk runs C B^T [64 x 64 x NT] once, and per head y's S C^T [64 x 64 x
    NT], X^T W^T [64 x 64 x 64] and the state update [64 x NT x 64] in pass
    D, on every chunk; pass B runs the state update again on the chunks of
    every segment but the last, none where the plan has one segment.  NT is
    the 32-, 64- or 128-wide tile of N, P and the chunk are padded to 64, and
    each product runs three times for 3xTF32.  A group of an odd number of
    heads runs its last block's second head too.  Reads the plan of the
    library built on this card."""
    from repro_torch.kernels import ssd_scan as tssd
    plan = tssd.plan(b, s, h, p, g, n, chunk)
    nt = 32 if n <= 32 else 64 if n <= 64 else 128
    heads = 2
    blocks = b * g * -(-(h // g) // heads)
    update = 64 * nt * 64
    per_chunk_d = 64 * 64 * nt + heads * (64 * 64 * nt + 64 * 64 * 64 + update)
    chunks_b = (plan.segments - 1) * plan.chunks_per_segment
    return 3 * 2 * blocks * (-(-s // chunk) * per_chunk_d + chunks_b * heads * update)


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
            (1, 4096, 128, 64, 1, 16, 64, False, False),    # jamba's mixer (N in a 32-wide tile)
            (1, 4096, 4, 64, 1, 128, 64, True, False),      # mamba's share on a model axis of 8
            (1, 2048, 6, 64, 2, 128, 64, False, False)]:    # 3 heads a group, 2 a block
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
                       ratio_fn=ref.ssd_tolerance_ratio),
               control("[ssd] control: plain with heads 0 and 1 fed each other's x (one head "
                       "of a block reading its neighbour's tile)",
                       ssd_heads_swapped(x, dt, a, bm, cm, chunk)[0], y_w,
                       ratio_fn=ref.ssd_tolerance_ratio))
    del y_w, st_w
    torch.cuda.empty_cache()
    t = timings(lambda: tssd.ssd_scan(x, dt, a, bm, cm, chunk),
                lambda: ref.ssd_chunked(x, dt, a, bm, cm, chunk), None, 12)
    passes = device_ms_by_kernel(lambda: tssd.ssd_scan(x, dt, a, bm, cm, chunk), 12)
    pass_ms = {k: sum(v for key, v in passes.items() if k in key) for k in SSD_PASSES}
    log("[ssd] device ms per call by pass: "
        + ", ".join(f"{k} {v:.4f}" for k, v in pass_ms.items()))
    flops, nbytes = ssd_fwd_bound(b, s, h, p, g, n, chunk)
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
    del x, dt, a, bm, cm
    torch.cuda.empty_cache()
    # beside it, a training step's forward: mamba2-370m at S=4096 (48 launches a step)
    tb, ts = 1, 4096
    x, dt, a, bm, cm, _ = ssd_inputs(tb, ts, h, p, g, n, seed=2)
    y_w, st_w = ref.ssd_chunked(x, dt, a, bm, cm, chunk)
    y, st = tssd.ssd_scan(x, dt, a, bm, cm, chunk)
    err, ratio = hold_ssd(f"[ssd] training forward B={tb} S={ts} H={h} P={p} G={g} N={n} "
                          f"chunk={chunk}, strided inputs "
                          f"({tssd.plan(tb, ts, h, p, g, n, chunk).segments} segments)",
                          y, st, y_w, st_w)
    worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    train = device_ms_by_kernel(lambda: tssd.ssd_scan(x, dt, a, bm, cm, chunk), 20)
    train_pass = {k: sum(v for key, v in train.items() if k in key) for k in SSD_PASSES}
    tflops, tbytes = ssd_fwd_bound(tb, ts, h, p, g, n, chunk)
    train_bound = bound(tflops, tbytes, PEAK_TF32_FLOPS)
    log(f"[ssd] training forward: {sum(train_pass.values()):.4f} ms device a call ("
        + ", ".join(f"{k} {v:.4f}" for k, v in train_pass.items())
        + f"); bound {train_bound['bound_ms']:.4f} ms ({train_bound['bound_by']})")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:31",
            "max_abs_err": worst, "tolerance": "1e-5 + 1e-4 max|plain| per (batch, head) (f32)",
            "tolerance_ratio": worst_ratio, "control_ratio": ctrl, **t,
            "pass_device_ms": pass_ms, "bound_ms": bound_ms,
            "train_forward_device_ms": sum(train_pass.values()),
            "train_forward_bound_ms": train_bound["bound_ms"],
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
    """(attention layers, Mamba-2 layers) of a configuration's decoder stack:
    the layers that launch the flash kernel and the SSD scan (an encoder's
    non-causal attention and the cross-attention are plain sdpa; their FLOPs
    are in ``prefill_flops``)."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    return kinds.count("attn"), kinds.count("mamba")


def active_params(cfg, n_params: int) -> int:
    """Parameters a token runs through: all of them for a dense model; for
    an MoE model less the routed experts it is not sent to (E - K of each
    MoE layer's E).  A model with a frontend (a VLM's patches, an
    encoder-decoder's frames) runs parts of itself over other positions:
    its training FLOPs come from ``prefill_flops`` instead."""
    if cfg.moe is None:
        return n_params
    m = cfg.moe
    de = m.d_expert if m.d_expert is not None else cfg.d_ff
    n_moe = sum(cfg.layer_has_moe(i) for i in range(cfg.n_layers))
    return n_params - n_moe * (m.n_experts - m.top_k) * 3 * cfg.d_model * de


def phase_train(arch: str = TRAIN_ARCH, batch_size: int = 1, tag: str = "train",
                n_layers: int = 0, seq: int = TRAIN_SEQ, remat: str = ""):
    """Training steps of ``arch`` at B=``batch_size``, ``seq`` text tokens a
    sequence (a VLM's patches and an encoder-decoder's frames besides, from
    ``synth_batch``), at full width and depth, or on its first ``n_layers``
    layers where given, under the configuration's remat policy or ``remat``;
    log lines start with ``[tag]``."""
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
    if remat:
        cfg = cfg.replace(remat=remat)
    depth = f"{cfg.n_layers} layers"
    if n_layers:
        depth = f"{n_layers} of {cfg.n_layers} layers: depth cut, full width"
        cfg = cfg.replace(n_layers=n_layers)
    launch_train.init_distributed(dev)
    mesh = launch_train.make_mesh(launch_train.parse_mesh("1x1"), dev)  # data 1, model 1
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
    batch = synth_batch(cfg, DataConfig(seq_len=seq, global_batch=batch_size), 0, device=dev)
    # "full" and "dots" both run the body's forward again in the backward
    fwd_runs = 2 if cfg.remat in ("full", "dots") else 1
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
    tokens = seq * batch_size
    s = seq
    n_active = active_params(cfg, n_params)
    if cfg.frontend is None:
        dense_flops = 6 * n_active * tokens
        # causal QK^T and PV, x3 for the backward
        attn_flops = (3 * 4 * n_attn * cfg.n_heads * cfg.resolved_head_dim * s * (s + 1) // 2
                      * batch_size if n_attn else 0)
        flops_text = (f"6 N T = {dense_flops / 1e12:.2f} T with N = {n_active} active of "
                      f"{n_params}, T = {tokens}; causal attention 12 L H dh S(S+1)/2 B = "
                      f"{attn_flops / 1e12:.3f} T")
    else:
        # a VLM's patches and an encoder-decoder's encoder and cross-attention:
        # 3x the forward's FLOPs with the logits of every text position
        positions = seq + (cfg.frontend.n_tokens if cfg.family == "vlm" else 0)
        dense_flops, attn_flops = 3 * prefill_flops(cfg, positions, seq)[0] * batch_size, 0
        flops_text = (f"3x the forward's, {dense_flops / 3 / batch_size / 1e12:.3f} T a "
                      f"sequence of {positions} decoder positions"
                      + (f" over {cfg.frontend.n_tokens} frames" if cfg.encoder else "")
                      + f" with the logits of its {seq} text positions, x B = {batch_size}")
    mfu = (dense_flops + attn_flops) / (step_ms / 1e3) / PEAK_BF16_FLOPS
    log(f"[{tag}] step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}; first "
        f"{times[0]:.1f} ms), {tokens / step_ms * 1e3:.1f} text tokens/s; model FLOPs "
        f"{(dense_flops + attn_flops) / 1e12:.2f} T a step ({flops_text}"
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
    ok = len(bwd) == n_attn and len(sbwd) == n_ssm and len(sfwd) == n_ssm * fwd_runs
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
    cfg2, p2 = depth_cut(cfg, params, 2)
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
            "train_batch": batch_size, "train_seq": seq, "train_moe_aux_step1": aux0,
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


def _timed(timed: list, fn):
    """``fn`` with the seconds of each call (device work included) appended
    to ``timed``."""
    import torch

    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        return out
    return run


def phase_checkpoint_resume() -> dict:
    """(a) mamba2-370m at full width and depth through ``launch.train.main``
    (B=1, S=TRAIN_SEQ, the driver's AdamW: lr CKPT_LR, warmup 10, a new
    ``synth_batch`` every step): 4 steps straight, then 2 steps with
    ``--ckpt D`` and 4 with ``--ckpt D --resume``; the resumed run's last
    loss must be the straight run's within CKPT_RTOL, and a restore with the
    optimizer's step reset to 0 (the control) must land beyond it."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import TrainSetup, make_train_step
    dev = torch.device("cuda")
    cfg = get_config(SSM_TRAIN_ARCH)
    args = ["--arch", SSM_TRAIN_ARCH, "--batch", "1", "--seq", str(TRAIN_SEQ), "--lr", str(CKPT_LR)]
    straight = launch_train.main(args + ["--steps", "4"])
    torch.cuda.empty_cache()
    saves, restores = [], []
    save, restore = ckpt.save, ckpt.restore
    ckpt.save, ckpt.restore = _timed(saves, save), _timed(restores, restore)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            d = os.path.join(tmp, "ck")
            ops.reset_launch_counts()
            launch_train.main(args + ["--steps", "2", "--ckpt", d])
            counts = ops.launch_counts()
            nbytes = sum(f.stat().st_size for f in Path(d).iterdir())
            # the control: the same restore with the optimizer's step reset to 0
            mesh = launch_train.make_mesh({"data": 1}, dev)
            setup = TrainSetup(cfg=cfg, opt=OptConfig(lr=CKPT_LR, warmup_steps=10))
            tpl = tf.init_lm(cfg, device="meta")
            params, opt, ef, extra = ckpt.restore(d, setup, mesh, tpl, dev)
            opt["step"] = 0
            step = make_train_step(setup, mesh, tpl)
            dc = DataConfig(seq_len=TRAIN_SEQ, global_batch=1)
            for i in range(extra["step"], 4):
                params, opt, ef, m = step(params, opt, ef, synth_batch(cfg, dc, i, device=dev))
            control = float(m["loss"])
            del params, opt, ef, step
            torch.cuda.empty_cache()
            ops.reset_launch_counts()
            resumed = launch_train.main(args + ["--steps", "4", "--ckpt", d, "--resume"])
            counts = {k: counts[k] + v for k, v in ops.launch_counts().items()}
    finally:
        ckpt.save, ckpt.restore = save, restore
    rel, rel_control = (abs(x - straight) / abs(straight) for x in (resumed, control))
    log(f"[ckpt] {cfg.name} through launch.train.main, B=1 S={TRAIN_SEQ}, lr {CKPT_LR}: 4 steps "
        f"straight, last "
        f"loss {straight:.6f}; 2 steps + --ckpt, then --resume to 4: {resumed:.6f} (relative "
        f"difference {rel:.3g}, limit {CKPT_RTOL}; bit-equal {resumed == straight}); control, "
        f"the optimizer's step reset to 0: {control:.6f} ({rel_control:.3g}, must exceed the "
        f"limit); {nbytes / 1e9:.3f} GB a save ({len(saves)} saves: "
        f"{', '.join(f'{t:.2f}' for t in saves)} s; {len(restores)} restores: "
        f"{', '.join(f'{t:.2f}' for t in restores)} s); launches {counts}")
    want = {**NO_LAUNCHES, "ssd_scan": 4 * cfg.n_layers, "ssd_scan_bwd": 4 * cfg.n_layers}
    if not (rel <= CKPT_RTOL < rel_control and counts == want):
        raise AssertionError(f"checkpoint resume: straight {straight}, resumed {resumed}, "
                             f"control {control}, launches {counts} (want {want})")
    return {"ckpt_arch": cfg.name, "ckpt_loss_straight": straight, "ckpt_loss_resumed": resumed,
            "ckpt_loss_control": control, "ckpt_bit_equal": resumed == straight,
            "ckpt_bytes": nbytes, "ckpt_save_s": saves, "ckpt_restore_s": restores,
            "ckpt_launches": counts}


def phase_remat_dots(tr: dict) -> dict:
    """(b) h2o-danube-3-4b at full width and depth under remat "dots": the
    training phase again (``phase_train``, whose flash forward now launches
    twice a layer a step), its first loss against remat "none"'s (``tr``,
    the training phase's) and its peak below it; then one step's gradients
    of both policies on the same parameters and batch, leaf by leaf."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.step import TrainSetup, init_sharded_state, make_train_step
    from repro_torch.tree import leaves
    dots = {f"dots_{k}": v for k, v in
            phase_train(TRAIN_ARCH, 1, tag="dots train", remat="dots").items()}
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    launch_train.init_distributed(dev)
    mesh = launch_train.make_mesh({"data": 1}, dev)
    params, _, _ = init_sharded_state(TrainSetup(cfg=cfg), mesh, seed=0, device=dev)
    batch = synth_batch(cfg, DataConfig(seq_len=TRAIN_SEQ, global_batch=1), 0, device=dev)
    grads = {}
    for remat in ("none", "dots"):
        c = cfg.replace(remat=remat)
        grads[remat] = make_train_step(TrainSetup(cfg=c), mesh, tf.init_lm(c, device="meta")
                                       ).grads_fn(params, batch)[0]
    rel = leaf_rel_rms(grads["dots"], grads["none"])
    bit_equal = all(torch.equal(a, b) for a, b in zip(leaves(grads["dots"]),
                                                      leaves(grads["none"])))
    del params, grads
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    loss_rel = abs(dots["dots_train_losses"][0] - tr["train_losses"][0]) / tr["train_losses"][0]
    worst = max(rel, key=rel.get)
    log(f"[dots] {cfg.name} remat 'dots' against 'none': step-1 loss "
        f"{dots['dots_train_losses'][0]:.6f} / {tr['train_losses'][0]:.6f} (relative "
        f"{loss_rel:.3g}, limit 1e-6); one step's gradients, worst leaf relative RMS "
        f"{rel[worst]:.3g} ({worst}; limit 1e-3), bit-equal {bit_equal}; peak "
        f"{dots['dots_train_peak_bytes'] / 2**30:.2f} GiB / {tr['train_peak_bytes'] / 2**30:.2f} "
        f"GiB; step {dots['dots_train_step_ms']:.1f} / {tr['train_step_ms']:.1f} ms")
    if not (loss_rel <= 1e-6 and rel[worst] <= 1e-3
            and dots["dots_train_peak_bytes"] < tr["train_peak_bytes"]):
        raise AssertionError(f"remat dots: loss {loss_rel}, gradients {rel[worst]}, peak "
                             f"{dots['dots_train_peak_bytes']} vs {tr['train_peak_bytes']}")
    return {**dots, "dots_loss_rel": loss_rel, "dots_grad_rel_rms": rel[worst],
            "dots_grads_bit_equal": bit_equal}


def phase_hsdp_compress() -> dict:
    """(c) granite-moe-1b-a400m at full width and depth, B=MOE_TRAIN_BATCH,
    S=TRAIN_SEQ: one step of plain FSDP, then HSDP with int8 error feedback
    on mesh {"pod": 1, "data": 1} (the exchange quantizes at one pod, as the
    JAX package's does).  The loss is the same; the gradient norm moves by
    more than 0 and at most HSDP_GN_RTOL; the error feedback is non-zero and
    within scale/2 of each leaf (f32 rounding: + 2^-16 scale).  At one pod
    the ring carries nothing, so a ring hop of int8 codes to this rank
    itself shows that NCCL carries them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fabric import _hops
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import TrainSetup, ef_init, init_sharded_state, make_train_step
    from repro_torch.tree import leaves
    dev = torch.device("cuda")
    cfg = get_config(MOE_TRAIN_ARCH)
    launch_train.init_distributed(dev)
    batch = synth_batch(cfg, DataConfig(seq_len=TRAIN_SEQ, global_batch=MOE_TRAIN_BATCH), 0,
                        device=dev)
    tpl = tf.init_lm(cfg, device="meta")
    opt_cfg = OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    runs = {}
    for label, axes, kw in (("fsdp", {"data": 1}, {}),
                            ("hsdp", {"pod": 1, "data": 1},
                             {"hsdp": True, "compress_pod_grads": True})):
        setup = TrainSetup(cfg=cfg, opt=opt_cfg, **kw)
        mesh = launch_train.make_mesh(axes, dev)
        params, opt, ef = init_sharded_state(setup, mesh, seed=0, device=dev)
        step = make_train_step(setup, mesh, tpl)
        if label == "hsdp":
            # the exchange alone on one step's gradients: its bound and its time
            grads, _ = step.grads_fn(params, batch)
            xs = [g.float() for g in leaves(grads)]  # x = g + ef, ef = 0
            step.pod_sync(grads, ef)
            over = max((e.abs().max() / (x.abs().max().clamp(min=1e-12) / 127.0)).item()
                       for x, e in zip(xs, leaves(ef)))
            nonzero = sum(int(e.count_nonzero()) for e in leaves(ef))
            del xs
            ms = time_ms(lambda: step.pod_sync(grads, ef), 5)
            dev_ms = device_ms(lambda: step.pod_sync(grads, ef), 5)
            del grads
            ef = ef_init(setup, params)
            torch.cuda.empty_cache()
            ops.reset_launch_counts()
        params, opt, ef, m = step(params, opt, ef, batch)
        runs[label] = (float(m["loss"]), float(m["grad_norm"]))
        if label == "hsdp":
            counts = ops.launch_counts()
            ef_bytes = sum(e.numel() * e.element_size() for e in leaves(ef))
            ef_nonzero_step = sum(int(e.count_nonzero()) for e in leaves(ef))
        del params, opt, ef, step
        torch.cuda.empty_cache()
    codes = torch.randint(-127, 128, (1 << 20,), dtype=torch.int8, device=dev)
    got = torch.empty_like(codes)
    _hops([(codes, 0, got, 0)], torch.distributed.group.WORLD)
    int8_hop = bool(torch.equal(got, codes))
    torch.distributed.destroy_process_group()
    loss_rel = abs(runs["hsdp"][0] - runs["fsdp"][0]) / runs["fsdp"][0]
    gn_rel = abs(runs["hsdp"][1] - runs["fsdp"][1]) / runs["fsdp"][1]
    log(f"[hsdp] {cfg.name} B={MOE_TRAIN_BATCH} S={TRAIN_SEQ}, HSDP + int8 error feedback on "
        f"mesh pod 1 x data 1 against FSDP: step-1 loss {runs['hsdp'][0]:.6f} / "
        f"{runs['fsdp'][0]:.6f} (relative {loss_rel:.3g}, limit 1e-6); grad_norm "
        f"{runs['hsdp'][1]:.6f} / {runs['fsdp'][1]:.6f} (relative {gn_rel:.4g}, must be in (0, "
        f"{HSDP_GN_RTOL}]); ef {ef_bytes / 1e9:.2f} GB, {nonzero} non-zero after the exchange "
        f"({ef_nonzero_step} after the step), worst |ef| / scale {over:.6f} (limit "
        f"{0.5 + 2 ** -16:.6f}); the exchange {ms:.2f} ms a step (events), "
        f"{dev_ms if dev_ms is None else f'{dev_ms:.2f}'} ms device; launches {counts}; a ring "
        f"hop of 1 MiB of int8 codes over NCCL to this rank, equal: {int8_hop}")
    if not (loss_rel <= 1e-6 and 0 < gn_rel <= HSDP_GN_RTOL and nonzero > 0
            and ef_nonzero_step > 0 and over <= 0.5 + 2 ** -16 and int8_hop):
        raise AssertionError(f"hsdp: runs {runs}, ef non-zero {nonzero}, |ef|/scale {over}")
    return {"hsdp_arch": cfg.name, "hsdp_loss": runs["hsdp"][0], "hsdp_fsdp_loss": runs["fsdp"][0],
            "hsdp_grad_norm": runs["hsdp"][1], "hsdp_fsdp_grad_norm": runs["fsdp"][1],
            "hsdp_grad_norm_rel": gn_rel, "hsdp_ef_bytes": ef_bytes, "hsdp_ef_nonzero": nonzero,
            "hsdp_ef_over_scale": over, "hsdp_exchange_ms": ms, "hsdp_exchange_device_ms": dev_ms,
            "hsdp_launches": counts, "hsdp_nccl_int8_hop": int8_hop}


def phase_rest_of_training(tr: dict) -> dict:
    """The rest of training: (a) checkpoint and resume, (b) remat "dots",
    (c) HSDP with int8 error feedback."""
    t0 = time.perf_counter()
    out = {**phase_checkpoint_resume(), **phase_remat_dots(tr), **phase_hsdp_compress()}
    out["rest_of_training_s"] = time.perf_counter() - t0
    log(f"[rest of training] ok in {out['rest_of_training_s']:.1f} s")
    return out

# Phase 27 (b): each rank's share of one full-width layer at the local shapes
# of a model axis of TP_SIZE ranks, the ranks in turn in one process.
# (configuration, the layer's blocks, batch).  At 8 ranks: danube's attention
# runs 4 query heads on 1 kv head at dh 120 and its MLP 1280 of 10240
# columns; granite's MoE 4 of 32 experts and its attention 2 heads on 1 kv
# head at dh 64; mamba2-370m's mixer 4 SSD heads on its one B/C group;
# paligemma's attention 1 query head on its one (replicated) kv head at dh 256.
TP_SIZE = 8
TP_LAYERS = (("h2o_danube_3_4b", ("attn", "mlp"), 1),
             ("granite_moe_1b_a400m", ("attn", "moe"), MOE_TRAIN_BATCH),
             ("mamba2_370m", ("ssm",), 1),
             ("paligemma_3b", ("attn",), 1))
# The sum of the shares against the whole layer: the relative RMS of the
# output, of the input's gradient and of each leaf's gradient, held to the
# limit the training phases hold depth-2 gradients to (MODEL_LIMIT).  Each
# rank's partial is rounded to bf16 before the sum, as the real axis's
# all-reduce sums it, and the input's gradient adds 3 M bf16 partials (q, k
# and v of each rank) where the whole layer adds 3: one bf16 ulp (2^-7) is
# no bound for that sum (it reads 0.0075 at 8 ranks on an H100).  A
# rank's partial dropped reads ~1/sqrt(M), a replicated kv leaf's gradient
# from one rank ~1 - 1/M, summed M times M - 1.
TP_LIMIT = MODEL_LIMIT


class SequentialModelAxis:
    """A stand-in for ``parallel.tensor.ModelAxis`` that runs the ranks of a
    model axis in turn in one process, on one autograd graph: ``copy`` and
    ``reduce`` are the identity (the caller adds the ranks' partials where
    ``reduce`` would, and autograd sums the gradients of what each rank read
    where ``copy``'s all-reduce would); ``gather_leaf`` concatenates every
    rank's shard of the leaf (views of one tensor).  A sum mid-pass
    (``all_sum``) cannot run in turn: the SSD mixer's share is composed by
    ``tp_layer_sum`` instead.  Planted faults of the gradients' collectives:
    ``unsummed`` (ids of replicated leaves whose partial gradients a rank
    other than 0 does not send: not summed over the axis), ``summed_m``
    (ids of leaves whose gradient reaches them M times over: summed over the
    axis once too often)."""

    def __init__(self, size: int, rank: int, shards: dict, unsummed=(), summed_m=()):
        self.size, self.rank, self.shards = size, rank, shards
        self.unsummed, self.summed_m = set(unsummed), set(summed_m)
        self.active, self.launches = True, 0

    def block(self, n: int):
        b = n // self.size
        return self.rank * b, (self.rank + 1) * b

    def copy(self, x):
        if id(x) in self.unsummed and self.rank > 0:
            return x.detach()
        return _scaled_grad(x, self.size) if id(x) in self.summed_m else x

    def reduce(self, x):
        return x

    def gather_leaf(self, x, dim: int):
        import torch
        parts, td = self.shards[id(x)]
        if td != dim:
            raise AssertionError(f"gather_leaf on dim {dim} of a leaf split on {td}")
        return torch.cat(parts, dim)

    def _in_one_pass(self, *a, **kw):
        raise AssertionError("the ranks run in turn: no collective can run mid-pass")
    all_sum = gather_last = max = gather = _in_one_pass


def _scaled_grad(x, k: int):
    """x, whose gradient is multiplied by ``k`` on its way back."""
    import torch

    class Scaled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return g * k
    return Scaled.apply(x)


class SequentialRails:
    """A stand-in for ``parallel.resident.Rails`` that runs ``n`` rail ranks
    in turn in one process (a card holds one rank): a stored leaf is the
    GLOBAL one, each rank's shard a view of it along its FSDP dim; each
    product runs once a rank on that rank's shard, the partial sums are
    added in rank order and the output slices concatenated.  ``sent`` counts
    the bytes each rank would send over a ring of ``n`` (``fabric``'s ring
    counts, not traffic).  Planted faults: ``drop`` leaves one rank's partial
    sums out; ``order`` gathers the ranks' output slices in another order."""

    def __init__(self, n: int, *, drop=None, order=None):
        self.n, self.drop = n, drop
        self.order = list(range(n)) if order is None else list(order)
        self.sent = 0

    def ranks(self):
        return list(range(self.n))

    def parts(self, leaf, dim: int):
        return list(leaf.chunk(self.n, dim))

    def rows(self) -> "_AllRows":
        return _AllRows(self)

    def reduce(self, partials):
        from repro_torch.fabric import all_reduce_bytes
        total = None
        for r, p in enumerate(partials):
            if r != self.drop:
                total = p if total is None else total + p
        self.sent += all_reduce_bytes(partials[0].numel(), partials[0].element_size(),
                                      (self.n,))
        return total

    def join(self, parts, dim: int):
        import torch
        from repro_torch.fabric import gather_bytes
        self.sent += gather_bytes(parts[0].numel() * parts[0].element_size(), (self.n,))
        return torch.cat([parts[i] for i in self.order], dim)

    def gather_leaf(self, leaf, dim: int):
        from repro_torch.fabric import gather_bytes
        self.sent += gather_bytes(leaf.numel() * leaf.element_size() // self.n, (self.n,))
        return leaf


class _AllRows:
    """``SequentialRails``' rows: its caches hold every rank's rows, so a
    mixer takes them all; ``gather`` counts what each rank would send of
    its 1/n of them."""

    def __init__(self, rails: SequentialRails):
        self.rails = rails

    def local(self, t):
        return t

    def gather(self, t):
        from repro_torch.fabric import gather_bytes
        self.rails.sent += gather_bytes(t.numel() * t.element_size() // self.rails.n,
                                        (self.rails.n,))
        return t


def tp_layer_leaves(cfg, kinds, seed: int) -> dict:
    """{block: {leaf: tensor}} of one full-width layer from ``seed``, bf16
    (the router and the SSM's conv, decay, skip and norm leaves f32), each a
    leaf that keeps its gradient."""
    import torch
    from repro_torch.models import transformer as tf
    gen = torch.Generator(device="cuda").manual_seed(seed)
    (lp,) = tf._init_stack(cfg.replace(n_layers=1), torch.bfloat16, gen, torch.device("cuda"),
                           cross=False)
    out = {"attn": lp["mixer"]} if "attn" in kinds else {"ssm": lp["mixer"]}
    if "mlp" in kinds or "moe" in kinds:
        out["mlp" if "mlp" in kinds else "moe"] = lp["ffn"]

    def leaf(t):
        return {k: leaf(v) for k, v in t.items()} if isinstance(t, dict) else \
            t[0].clone().requires_grad_()
    return {k: leaf(v) for k, v in out.items()}


def tp_shares(kind: str, full: dict, size: int, **faults) -> list:
    """[(this rank's leaves, its ``SequentialModelAxis``)] of one block,
    whose leaves may nest (MoE's shared experts): each leaf split on its TP
    dim by the sharding rules at ``size`` (views of the whole leaf), or the
    whole leaf where it is replicated over the axis.  ``faults`` name
    top-level leaves of ``full`` for the stand-in's faults."""
    from repro_torch.parallel import sharding as sh
    prefix = {"attn": "mixer/", "ssm": "mixer/", "mlp": "ffn/", "moe": "ffn/"}[kind]
    split, shards = {}, {}

    def walk(tree, path):
        for name, t in tree.items():
            if isinstance(t, dict):
                walk(t, f"{path}{name}/")
                continue
            td = sh.tp_dim(path + name, tuple(t.shape), size)
            if td is not None:
                split[id(t)] = t.chunk(size, td)
                for part in split[id(t)]:
                    shards[id(part)] = (split[id(t)], td)
    walk(full, prefix)

    def rank(tree, r):
        return {k: rank(t, r) if isinstance(t, dict) else split[id(t)][r] if id(t) in split
                else t for k, t in tree.items()}
    ids = {k: [id(full[n]) for n in v] for k, v in faults.items()}
    return [(rank(full, r), SequentialModelAxis(size, r, shards, **ids)) for r in range(size)]


def tp_block(kind: str, cfg, p, h, tp=None):
    """One block of the layer on its input h [B,S,D]: whole, or (attention
    and the MLP, given ``tp``) one rank's share."""
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.layers import mlp_apply
    import torch
    if kind == "attn":
        prefix = cfg.frontend.n_tokens if cfg.family == "vlm" else 0
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        return attn.attention(p, h, positions, cfg, causal=True, window=cfg.sliding_window,
                              prefix_len=prefix, tp=tp)
    if kind == "mlp":
        return mlp_apply(p, h, cfg.mlp_act, tp=tp)
    if kind == "moe":
        return moe_mod.moe_apply(p, h, cfg)[0]
    return ssm_mod.ssm_apply(p, h, cfg)


def tp_layer_sum(kind: str, cfg, shares: list, h, drop=None):
    """The block's output as the model axis computes it, from every rank's
    share run in turn: the partials summed where ``reduce`` would sum them
    (rank ``drop``'s left out: a planted fault).  The replicated parts run
    once, as one rank runs them: MoE's routing (``moe_route``, over the
    router gathered); the SSD mixer's sum of squares of the gated norm,
    whose all-reduce sits mid-pass, is summed over the ranks' shares
    between ``ssm_gated`` and ``gated_norm_out`` (``ssm_apply``'s own
    composition)."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.parallel import sharding as sh
    keep = [r for r in range(len(shares)) if r != drop]
    tp0, d = shares[0][1], cfg.d_model
    if kind == "attn":
        split = sh.model_dim("wq", (d, cfg.n_heads, cfg.resolved_head_dim), tp0) == 1
    elif kind == "mlp":
        split = sh.model_dim("w_gate", (d, cfg.d_ff), tp0) is not None
    else:
        split = moe_mod.expert_parallel(cfg, tp0) if kind == "moe" else \
            ssm_mod.shard_mixer(shares[0][0], cfg, tp0)[1]
    if not split:  # a block that runs replicated has no partials to sum
        raise AssertionError(f"{cfg.name} {kind}: does not split over {tp0.size} ranks")
    if kind in ("attn", "mlp"):
        return torch.stack([tp_block(kind, cfg, shares[r][0], h, shares[r][1])
                            for r in keep]).sum(0)
    if kind == "moe":
        route, _ = moe_mod.moe_route(shares[0][0], h, cfg, tp=shares[0][1])
        parts = [moe_mod.moe_experts(shares[r][0], h, route, cfg, shares[r][1]) for r in keep]
        return torch.stack(parts).sum(0).to(h.dtype)
    mixed = [ssm_mod.shard_mixer(p, cfg, tp)[0] for p, tp in shares]
    vs = [ssm_mod.ssm_gated(p, h, cfg) for p in mixed]
    ss = torch.stack([v.square().sum(-1, keepdim=True) for v in vs]).sum(0)
    d_inner = ssm_mod.ssm_dims(cfg)[0]
    return torch.stack([ssm_mod.gated_norm_out(mixed[r], vs[r], ss, d_inner, cfg.norm_eps,
                                               h.dtype) for r in keep]).sum(0)


def tp_grads(out, g, h, full: dict) -> dict:
    """{"out", "dx", leaf: gradient} of one run, the leaves' and h's
    gradients cleared after."""
    out.backward(g)
    res = {"out": out.detach(), "dx": h.grad.clone()}
    res.update({k: t.grad.clone() for k, t in full.items()})
    h.grad = None
    for t in full.values():
        t.grad = None
    return res


def tp_rel_rms(got: dict, want: dict) -> dict:
    return {k: ((got[k].float() - w.float()).pow(2).mean().sqrt()
                / w.float().pow(2).mean().sqrt().clamp(min=1e-30)).item()
            for k, w in want.items()}


def tp_local_kernels(kernels: list) -> None:
    """The kernels at the shares' local shapes, each held to its plain
    version with the planted faults of its kernel phase and timed beside
    its bound, the plain version and SDPA: flash forward and backward at
    danube's (B=1, 4 heads on 1 kv head, dh 120), granite's (B=2, 2 on 1,
    dh 64) and paligemma's (B=1, 1 on 1, dh 256); the SSD scan and its
    backward at mamba2-370m's (B=1, 4 heads on 1 group)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as tssd
    from repro_torch.kernels import ssd_scan_bwd as tssdb
    for name, (b, h, kv, dh), seed in (("danube", (1, 4, 1, 120), 61),
                                       ("granite", (MOE_TRAIN_BATCH, 2, 1, 64), 63),
                                       ("paligemma", (1, 1, 1, 256), 65)):
        kernels[0].setdefault("tp_local", {})[name] = flash_at(
            f"[tp flash {name}]", b, TRAIN_SEQ, h, kv, dh, seed)
        kernels[1].setdefault("tp_local", {})[name] = flash_bwd_at(
            f"[tp flash bwd {name}]", b, TRAIN_SEQ, h, kv, dh, seed + 1)
    b, s, h, p, g, n, chunk = 1, TRAIN_SEQ, 32 // TP_SIZE, 64, 1, 128, 64
    shape = f"B={b} S={s} H={h} P={p} G={g} N={n} chunk={chunk} f32, strided"
    x, dt, a, bm, cm, _ = ssd_inputs(b, s, h, p, g, n, seed=67)
    y_w, st_w = ref.ssd_chunked(x, dt, a, bm, cm, chunk)
    err, ratio = hold_ssd(f"[tp ssd] {shape}", *tssd.ssd_scan(x, dt, a, bm, cm, chunk),
                          y_w, st_w)
    at = s // chunk // 2
    ctrl = control(f"[tp ssd] control: plain with the state entering chunk {at} dropped",
                   ssd_drop_entering_state(x, dt, a, bm, cm, chunk, at)[0], y_w,
                   ratio_fn=ref.ssd_tolerance_ratio)
    t = timings(lambda: tssd.ssd_scan(x, dt, a, bm, cm, chunk),
                lambda: ref.ssd_chunked(x, dt, a, bm, cm, chunk), None, 12)
    t.update(bound(*ssd_fwd_bound(b, s, h, p, g, n, chunk), PEAK_TF32_FLOPS))
    log(f"[tp ssd] {t['ms']:.4f} ms kernel (device {t['device_ms']}), {t['plain_ms']:.3f} ms "
        f"plain; bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    kernels[3]["tp_local"] = {"mamba": {"shape": shape, "max_abs_err": err,
                                        "tolerance_ratio": ratio, "control_ratio": ctrl, **t}}
    gen = torch.Generator(device="cuda").manual_seed(68)
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
    dst = torch.randn((b, h, p, n), generator=gen, device="cuda")
    got = tssdb.ssd_scan_bwd(x, dt, a, bm, cm, chunk, dy, dst)
    want = ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dst)
    err, ratio = hold_ssd_bwd(f"[tp ssd bwd] {shape}", got, want)
    keep = ref.SSD_GRAD_KEEP
    ctrl = control(f"[tp ssd bwd] control: plain with dB from one head of each group of {h}, "
                   f"on db", ssd_bwd_one_head_per_group(x, dt, a, bm, cm, chunk, dy, dst,
                                                        None)[3], want[3],
                   ratio_fn=lambda f, w: ref.ssd_grad_tolerance_ratio(f, w, keep["db"]))
    del got, want
    t = timings(lambda: tssdb.ssd_scan_bwd(x, dt, a, bm, cm, chunk, dy, dst),
                lambda: ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dst), None, 12)
    t.update(bound(*ssd_bwd_bound(b, s, h, p, g, n, chunk, False), PEAK_TF32_FLOPS))
    log(f"[tp ssd bwd] {t['ms']:.4f} ms kernel (device {t['device_ms']}), {t['plain_ms']:.3f} "
        f"ms plain; bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    kernels[4]["tp_local"] = {"mamba": {"shape": shape, "max_abs_err": err,
                                        "tolerance_ratio": ratio, "control_ratio": ctrl, **t}}


def phase_tp_shares(kernels: list) -> dict:
    """Phase 27 (b): for each layer of ``TP_LAYERS`` at full width, the whole
    layer's blocks (forward and backward, through the kernels) against the
    sum of the TP_SIZE ranks' shares run in turn at their local shapes
    through the same kernels (``tp_layer_sum``), every kernel launch of the
    shares held to its plain version (``checked_train_ops``); the output,
    the input's and every leaf's gradient to TP_LIMIT; the planted faults
    (a rank's partial dropped; paligemma's replicated kv leaves' gradients
    not summed over the axis, and summed M times) must exceed it.  Then the
    kernels at the local shapes, timed (``tp_local_kernels``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    t0 = time.perf_counter()
    out = {"tp_size": TP_SIZE, "tp_launches": dict(NO_LAUNCHES), "tp_layers": {}}
    for arch, kinds, b in TP_LAYERS:
        cfg = get_config(arch)
        leaves_by_block = tp_layer_leaves(cfg, kinds, seed=27)
        for kind in kinds:
            full = leaves_by_block[kind]
            gen = torch.Generator(device="cuda").manual_seed(271)
            h = torch.randn((b, TRAIN_SEQ, cfg.d_model), generator=gen, device="cuda",
                            dtype=torch.bfloat16).requires_grad_()
            g = torch.randn((b, TRAIN_SEQ, cfg.d_model), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            whole = tp_grads(tp_block(kind, cfg, full, h), g, h, full)
            fwd, bwd, sfwd, sbwd = [], [], [], []
            ops.reset_launch_counts()
            with checked_train_ops(fwd, bwd, sfwd, sbwd):
                shared = tp_grads(tp_layer_sum(kind, cfg, tp_shares(kind, full, TP_SIZE), h),
                                  g, h, full)
            counts = ops.launch_counts()
            out["tp_launches"] = {k: out["tp_launches"][k] + v for k, v in counts.items()}
            rel = tp_rel_rms(shared, whole)
            del shared
            faults = {f"rank {TP_SIZE - 1}'s partial dropped": dict(drop=TP_SIZE - 1)}
            replicated = [n for n in ("wk", "wv") if kind == "attn"
                          and cfg.n_kv_heads % TP_SIZE and n in full]
            if replicated:
                faults["the replicated wk/wv's gradients not summed over the axis"] = dict(
                    faults=dict(unsummed=replicated))
                faults["the replicated wk/wv's gradients summed M times"] = dict(
                    faults=dict(summed_m=replicated))
            ctrl = {}
            for label, f in faults.items():
                run = tp_layer_sum(kind, cfg, tp_shares(kind, full, TP_SIZE, **f.get("faults", {})),
                                   h, drop=f.get("drop"))
                ctrl[label] = max(tp_rel_rms(tp_grads(run, g, h, full), whole).values())
            checks = {"flash forward o (scaled)": max((r[0] for r in fwd), default=None),
                      "flash backward head RMS": max((r[0] for r in bwd), default=None),
                      "ssd forward": max(sfwd, default=None),
                      "ssd backward (scaled)": max((r[0] for r in sbwd), default=None)}
            worst = max(rel, key=rel.get)
            tag = f"[tp] {cfg.name} {kind}"
            log(f"{tag}: {TP_SIZE} ranks' shares summed against the whole layer at B={b} "
                f"S={TRAIN_SEQ}: relative RMS worst {rel[worst]:.3g} ({worst}; out "
                f"{rel['out']:.3g}, dx {rel['dx']:.3g}; limit {TP_LIMIT:.4g}); launches {counts}; "
                f"each launch against its plain version: "
                + ", ".join(f"{k} {v:.3f}" for k, v in checks.items() if v is not None)
                + "; controls: " + ", ".join(f"{k} {v:.3g}" for k, v in ctrl.items()))
            want_launches = {**NO_LAUNCHES, **({"flash_attention": TP_SIZE,
                                                "flash_attention_bwd": TP_SIZE}
                                               if kind == "attn" else {}),
                             **({"ssd_scan": TP_SIZE, "ssd_scan_bwd": TP_SIZE}
                                if kind == "ssm" else {})}
            kernel_ok = all(v is None or v <= (ref.HEAD_RMS_LIMIT if "head" in k else 1)
                            for k, v in checks.items())
            if not (rel[worst] <= TP_LIMIT and min(ctrl.values()) > TP_LIMIT
                    and counts == want_launches and kernel_ok):
                raise AssertionError(f"{tag}: shares {rel}, controls {ctrl}, launches {counts} "
                                     f"(want {want_launches}), kernels {checks}")
            out["tp_layers"][f"{cfg.name} {kind}"] = {
                "batch": b, "rel_rms": rel, "controls": ctrl, "launches": counts,
                "kernel_ratios": checks}
            del full, h, g, whole
        del leaves_by_block
        torch.cuda.empty_cache()
    tp_local_kernels(kernels)
    out["tp_s"] = time.perf_counter() - t0
    log(f"[tp] phase 27 (b) ok in {out['tp_s']:.1f} s; launches at the local shapes "
        f"{out['tp_launches']}")
    return out


@contextlib.contextmanager
def recorded_steps(steps: list):
    """Every train step made inside, by the phases and by
    ``launch.train.main`` alike, appended to ``steps``."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train import step as st
    make = st.make_train_step

    def recording(*a, **kw):
        steps.append(make(*a, **kw))
        return steps[-1]
    st.make_train_step = launch_train.make_train_step = recording
    try:
        yield
    finally:
        st.make_train_step = launch_train.make_train_step = make


def phase_tp_at_one(runs: dict, steps: list) -> dict:
    """Phase 27 (a): the training phases ran through the model axis's code
    at model size 1.  Each step's launches a step were held to the same
    counts as before it in its phase; here every step made had a model axis
    of one that launched no collective, and each phase's launches a step and
    step time are printed for the parent's to be read beside them."""
    axes = [(s.model.size, s.model.launches) for s in steps]
    for tag, r in runs.items():
        log(f"[tp at 1] {tag}: launches a step {r['launches']}, step {r['step_ms']:.1f} ms")
    log(f"[tp at 1] {len(steps)} train steps made: model-axis sizes {sorted({a for a, _ in axes})},"
        f" model-axis collectives launched {sum(n for _, n in axes)}")
    if not steps or any(a != 1 or n for a, n in axes):
        raise AssertionError(f"phase 27 (a): model axes {axes}")
    return {"tp_at_one_steps": len(steps), "tp_at_one_collectives": 0,
            "tp_at_one_runs": runs}


# Phase 28: rail-sharded serving.  (b) llama3-8b's context-sharded decode at
# world size 1 on a CTX_CAP-slot cache filled to CTX_FILL slots (4.3 GB of
# bf16 K/V), CTX_STEPS steps timed; (c) one attention block's 32768-slot
# cache as RAIL_SHARDS rail shards run in turn, at RAIL_POSITIONS (at 20000
# shards 5-7 own no valid slot); (d) one full-width decode layer each as
# the shares of TP_SIZE model ranks, at B=SERVE_TP_BATCH on a
# SERVE_TP_CAP-slot cache holding SERVE_TP_POS tokens.
CTX_CAP, CTX_FILL, CTX_STEPS = 32768, 32000, 16
RAIL_SHARDS, RAIL_POSITIONS = 8, (20000, 32767)
SERVE_TP_LAYERS = (("llama3_8b", ("attn", "mlp")), (MOE_ARCH, ("moe",)),
                   ("mamba2_370m", ("ssm",)), (VLM_ARCH, ("attn",)))
SERVE_TP_BATCH, SERVE_TP_CAP, SERVE_TP_POS = 8, 4096, 4000
# the collectives of the port's fabric and model axis, counted in phase 28 (a)
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "batch_isend_irecv")


class _CountingDist:
    """``torch.distributed`` with the calls of ``COLLECTIVES`` counted."""

    def __init__(self, real, counts: dict):
        self._real, self._counts = real, counts

    def __getattr__(self, name):
        attr = getattr(self._real, name)
        if name not in COLLECTIVES:
            return attr

        def counted(*a, **kw):
            self._counts[name] = self._counts.get(name, 0) + 1
            return attr(*a, **kw)
        return counted


@contextlib.contextmanager
def counted_collectives(counts: dict):
    """Every collective that the rails' ``Fabric`` or the ``ModelAxis``
    launches inside, counted by name into ``counts``."""
    from repro_torch import fabric
    from repro_torch.parallel import tensor
    saved = fabric.dist, tensor.dist
    fabric.dist = tensor.dist = _CountingDist(saved[0], counts)
    try:
        yield counts
    finally:
        fabric.dist, tensor.dist = saved


@contextlib.contextmanager
def recorded_decode_steps(made: list):
    """Every decode step that ``launch.serve.main`` makes inside, with the
    type of its mesh, appended to ``made``."""
    from repro_torch.launch import serve as launch_serve
    make = launch_serve.make_decode_step

    def recording(setup, mesh, *a, **kw):
        made.append((type(mesh).__name__, make(setup, mesh, *a, **kw)))
        return made[-1][1]
    launch_serve.make_decode_step = recording
    try:
        yield
    finally:
        launch_serve.make_decode_step = make


def phase_serve_at_one(archs, made: list, collectives: dict, launches: dict) -> dict:
    """Phase 28 (a): phase 19's driver runs served through a one-rank
    ``DeviceMesh`` (its steps' rail fabric of one shard, no model axis),
    launched no rail or model-axis collective, and each launched a step what
    the parent's 1 x 1 path launches at its capacity of 32 slots: nothing
    (below DECODE_KERNEL_MIN_CAPACITY both take the plain sdpa)."""
    meshes = sorted({m for m, _ in made})
    shards = sorted({st.fabric.n_shards for _, st in made})
    models = sorted({0 if st.model is None else st.model.size for _, st in made})
    for arch in archs:
        log(f"[serve at 1] {arch}: launches a step {launches[arch]}")
    log(f"[serve at 1] {len(made)} decode steps made on {meshes}, rail shards {shards}, model "
        f"axes {models} (0: none); rail and model-axis collectives launched {collectives}")
    if (meshes != ["DeviceMesh"] or shards != [1] or models != [0] or collectives
            or any(v != NO_LAUNCHES for v in launches.values())):
        raise AssertionError(f"phase 28 (a): meshes {meshes}, shards {shards}, model axes "
                             f"{models}, collectives {collectives}, launches {launches}")
    return {"serve_at_one_steps": len(made), "serve_at_one_collectives": 0,
            "serve_at_one_launches_per_step": launches}


# Weight-resident decode (phase 31): the einsum each resident leaf of a dense
# decoder meets, and the one it meets tied (gemma's embedding as the head).
RESIDENT_EQS = {"wq": "bsd,dhk->bshk", "wk": "bsd,dhk->bshk", "wv": "bsd,dhk->bshk",
                "wo": "bqhd,hdk->bqk", "w_gate": "bsd,df->bsf", "w_up": "bsd,df->bsf",
                "w_down": "bsf,fd->bsd", "unembed": "bsd,dv->bsv"}


def rail_bytes_by_fsdp_dims(cfg, batch: int, n: int, resident: bool) -> int:
    """The bytes each rank sends over a ring of ``n`` rails (model axis 1) in
    one decode step of a dense decoder (attention and MLP) of ``batch``
    rows, by its leaves' FSDP dims (``parallel.sharding.fsdp_dim``) and the
    fabric's ring counts.  Gathered: every sharded leaf, (n - 1) shards.
    Resident: each product's activation, all-reduced where the leaf's FSDP
    letter is contracted, else its slices gathered; the embedding's lookup
    (all-reduced on its rows, gathered on its columns); the small leaves
    gathered; each attention block's outputs of the rank's rows gathered."""
    import torch

    from repro_torch.fabric import all_reduce_bytes, gather_bytes
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.resident import RESIDENT_LEAVES
    from repro_torch.train import step as st
    from repro_torch.tree import leaves
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: the count covers a dense decoder")
    tpl = tf.init_lm(cfg, device="meta")
    paths = sh._walk(tpl, lambda pstr, leaf, stacked: (pstr, leaf, stacked))
    fds, _ = st.meta_trees(tpl, rails=("data",), n_rails=n, model_size=1)
    el = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    total = 0
    for (pstr, leaf, stacked), fd in zip(leaves(paths), leaves(fds)):
        name = pstr.split("/")[-1]
        if fd is None or pstr.startswith("encoder") or name == "frontend_proj":
            continue
        periods = leaf.shape[0] if stacked else 1
        shape = leaf.shape[1:] if stacked else leaf.shape
        fd -= 1 if stacked else 0
        leaf_bytes = leaf.numel() // periods * leaf.element_size()
        if not resident or name not in RESIDENT_LEAVES:
            total += periods * gather_bytes(leaf_bytes // n, (n,))
            continue
        uses = [RESIDENT_EQS[name]] if name in RESIDENT_EQS else []
        if name == "embed":
            uses = ["lookup"] + (["bsd,vd->bsv"] if cfg.tie_embeddings else [])
        for eq in uses:
            if eq == "lookup":
                out, cut = batch * shape[1], fd == 1
            else:
                ins, outs = eq.split("->")
                ws = ins.split(",")[1]
                out = batch * math.prod(s for c, s in zip(ws, shape) if c in outs)
                cut = ws[fd] in outs
            total += periods * (gather_bytes(out // n * el, (n,)) if cut
                                else all_reduce_bytes(out, el, (n,)))
    n_attn = sum(kind == "attn" for kind, _ in tf.period_spec(cfg)) * tf.n_periods(cfg)
    rows = batch // n * cfg.n_heads * cfg.resolved_head_dim * el
    return total + (n_attn * gather_bytes(rows, (n,)) if resident else 0)


class StackedShards:
    """The rails of context-parallel decode as a leading dim of the stats:
    ``pmax`` and ``all_reduce`` over dim 0, in place of the fabric's
    collectives, for shards run in turn on one card."""

    @staticmethod
    def pmax(x):
        return x.amax(0, keepdim=True).expand_as(x)

    @staticmethod
    def all_reduce(x):
        return x.sum(0, keepdim=True).expand_as(x)


def phase_context_decode(cfg, params) -> dict:
    """Phase 28 (b): llama3-8b at full width and depth, B=1, context-sharded
    at world size 1 (one rail shard, offset 0) through ``make_decode_step`` on
    a one-rank ``DeviceMesh``: the stats variant launches once a layer a
    step, each launch of one step is held to the plain stats, and the logits
    to the batch-sharded path's (the decode kernel) on the same cache."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.serve.step import ServeSetup, init_serve_state, make_decode_step
    dev, b = torch.device("cuda"), 1
    t0 = time.perf_counter()
    launch_train.init_distributed(dev)
    try:
        mesh = launch_train.make_mesh({"data": 1, "model": 1}, dev)
        setup = ServeSetup(cfg=cfg, context_shard=True)
        state = init_serve_state(setup, mesh, params, b, CTX_CAP)
        step = make_decode_step(setup, mesh, params, batch=b, capacity=CTX_CAP)
        kv_gb = sum(c[k].numel() * c[k].element_size() for c in state for k in ("k", "v")) / 1e9
        fill_cache(state, CTX_FILL, seed=28)
        gen = torch.Generator(device="cuda").manual_seed(28)
        tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device="cuda")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        for i in range(CTX_STEPS):
            logits, _ = step(params, state, tok, CTX_FILL + i)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = ops.launch_counts()
        want = {**NO_LAUNCHES, "decode_attention_stats": cfg.n_layers * CTX_STEPS}
        if counts != want or not torch.isfinite(logits).all():
            raise AssertionError(f"context decode: launches {counts}, want {want}")
        pos = CTX_FILL + CTX_STEPS
        busy, devk = device_profile(lambda: step(params, state, tok, pos),
                                    f"context decode one step B={b} cap={CTX_CAP}, {pos + 1} "
                                    f"filled slots")
        stats_ms = sum(ms for k, ms in devk.items() if is_decode_kernel(k))
        ratios = []
        with checked_ops(ratios):
            got, _ = step(params, state, tok, pos)
        batch = make_decode_step(ServeSetup(cfg=cfg), mesh, params, batch=b, capacity=CTX_CAP)
        ops.reset_launch_counts()
        ref_logits, _ = batch(params, state, tok, pos)
        batch_counts = ops.launch_counts()
        rel = position_rel_rms(got, ref_logits)
    finally:
        torch.distributed.destroy_process_group()
    log(f"[serve ctx] {cfg.name} B={b}, context-sharded at world size 1, {CTX_CAP} slots "
        f"({kv_gb:.2f} GB of K/V) filled to {CTX_FILL}: {CTX_STEPS} steps in "
        f"{secs * 1e3:.1f} ms, {secs / CTX_STEPS * 1e3:.2f} ms/step; launches {counts}; device "
        f"busy {busy}, stats kernels {stats_ms:.3f} ms of a step; each stats launch of one step "
        f"against the plain stats: worst {max(ratios):.3f} of the tolerance over {len(ratios)}; "
        f"logits against the batch-sharded path's (launches {batch_counts}) on the same cache: "
        f"worst position's relative RMS {rel:.3g} (limit {MODEL_LIMIT})")
    if (len(ratios) != cfg.n_layers or not max(ratios) <= 1 or not rel <= MODEL_LIMIT
            or batch_counts != {**NO_LAUNCHES, "decode_attention": cfg.n_layers}):
        raise AssertionError(f"context decode: stats ratios {ratios}, logits {rel}, batch-sharded "
                             f"launches {batch_counts}")
    return {"ctx_stats_launches": counts["decode_attention_stats"], "ctx_steps": CTX_STEPS,
            "ctx_ms_per_step": secs / CTX_STEPS * 1e3, "ctx_kv_gb": kv_gb,
            "ctx_device_busy": busy, "ctx_stats_device_ms_per_step": stats_ms,
            "ctx_stats_worst_ratio": max(ratios), "ctx_vs_batch_sharded_rel_rms": rel,
            "ctx_s": time.perf_counter() - t0}


def rail_shard_caches(k, v, pos: int, n: int, index_of=lambda i: i) -> list:
    """The caches of ``n`` rail shards of a whole cache k, v [B,C,KV,dh]
    holding positions 0 .. pos - 1: each shard's slots placed where
    ``attention.context_slot`` puts them for shard ``index_of(i)``."""
    import torch
    from repro_torch.models import attention as attn
    b, c, kv, dh = k.shape
    local, glob = c // n, torch.arange(c, device=k.device)
    out = []
    for i in range(n):
        owned, slot = attn.context_slot(glob, local, index_of(i), n, None)
        src, dst = glob[owned], slot[owned]
        sc = {"k": k.new_zeros((b, local, kv, dh)), "v": v.new_zeros((b, local, kv, dh)),
              "slot_pos": torch.full((local,), -1, dtype=torch.int32, device=k.device)}
        sc["k"][:, dst], sc["v"][:, dst] = k[:, src], v[:, src]
        sc["slot_pos"][dst] = torch.where(src < pos, src, -1).to(torch.int32)
        out.append(sc)
    return out


def phase_rail_shards(cfg, params) -> dict:
    """Phase 28 (c): one full-width llama3-8b attention block (layer 0 of
    phase 4's weights) at B=1 over a CTX_CAP-slot cache as RAIL_SHARDS
    shards, run in turn: each shard's ``context_local_stats`` through the
    stats kernel (every launch held to the plain stats), the port's
    ``merge_decode_stats`` over the stacked shards (``StackedShards`` for
    pmax and all_reduce), held to the plain whole-cache decode by
    ``ref.tolerance_ratio``; three planted faults must read > 1."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    p = tf._period(params["layers"][0], 0)["mixer"]
    b, n, c = 1, RAIL_SHARDS, CTX_CAP
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(280)
    x = torch.randn((b, 1, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, c, kv, dh), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, c, kv, dh), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for pos in RAIL_POSITIONS:
        tag = f"[serve rails] pos {pos}"
        with torch.no_grad():
            q, k_new, v_new = attn.decode_qkv(p, x, pos, cfg)
        wk, wv = k.clone(), v.clone()
        wk[:, pos], wv[:, pos] = k_new[:, 0], v_new[:, 0]
        valid = (torch.arange(c, device="cuda") <= pos)[None, :]
        want = ref.decode_attention(q, wk, wv, valid)

        def merged(index_of=lambda i: i, drop=None, rescale=True):
            stats = [attn.context_local_stats(q, k_new, v_new, pos, sc, index_of(i), n, None)
                     for i, sc in enumerate(rail_shard_caches(k, v, pos, n, index_of))]
            acc, m, l = (torch.stack([t for i, t in enumerate(ts) if i != drop])
                         for ts in zip(*stats))
            if not rescale:  # a planted fault: the split-K merge without exp(m - m_g)
                o = (acc.sum(0) / l.sum(0)[..., None]).flatten(-3, -2).unsqueeze(-3)
            else:
                o = attn.merge_decode_stats(acc, m, l, StackedShards)[0]
            return o.to(q.dtype), m
        ratios = []
        ops.reset_launch_counts()
        with checked_ops(ratios):
            got, m = merged()
        counts = ops.launch_counts()
        empty = [bool((m[i] <= ref.NEG_INF / 2).all()) for i in range(n)]
        err, ratio = hold(f"{tag}: {n} shards of {c // n} slots merged against the plain "
                          f"whole-cache decode (shards without a valid slot: "
                          f"{[i for i, e in enumerate(empty) if e]})", got, want)
        live = [i for i, e in enumerate(empty) if not e]
        ctrl = {"a shard's stats dropped": control(f"{tag} control: shard {live[1]}'s stats "
                                                   f"dropped", merged(drop=live[1])[0], want),
                "merged without the rescale": control(f"{tag} control: merged without "
                                                      f"exp(m - m_g)",
                                                      merged(rescale=False)[0], want),
                "the owner's offset ignored": control(f"{tag} control: every shard placed and "
                                                      f"written at shard 0's offset",
                                                      merged(index_of=lambda i: 0)[0], want)}
        want_empty = [i * (c // n) > pos for i in range(n)]
        if (counts != {**NO_LAUNCHES, "decode_attention_stats": n} or empty != want_empty
                or not max(ratios) <= 1):
            raise AssertionError(f"{tag}: launches {counts}, empty shards {empty} (want "
                                 f"{want_empty}), stats ratios {ratios}")
        log(f"{tag}: each shard's stats launch against the plain stats: worst "
            f"{max(ratios):.3f} of the tolerance")
        out[pos] = {"max_abs_err": err, "tolerance_ratio": ratio, "stats_worst_ratio": max(ratios),
                    "empty_shards": [i for i, e in enumerate(empty) if e], "controls": ctrl}
    secs = time.perf_counter() - t0
    log(f"[serve rails] ok in {secs:.1f} s")
    return {"rails": out, "rails_s": secs}


def serve_block_sum(kind: str, cfg, full: dict, x, pos: int, cache, drop=None):
    """(the whole block's decode output, the sum of TP_SIZE ranks' shares,
    the sum without rank ``drop``): attention and the MLP through their
    ``tp=`` path, MoE through ``moe_apply(tp=)`` (the routing replicated,
    the router gathered), the SSD mixer as ``ssm_decode`` composes it (its
    norm's sum of squares summed over the shares between
    ``ssm_decode_gated`` and ``gated_norm_out``).  Each rank's cache is
    this rank's part of ``cache`` (its kv heads, or its conv channels and
    SSD heads), cut before the whole block writes it."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.layers import mlp_apply
    shares = tp_shares(kind, full, TP_SIZE)
    parts = []
    if kind == "attn":
        caches = [{k: cache[k][:, :, attn.kv_heads(cfg, tp, x.device)].clone()
                   if k != "slot_pos" else cache[k].clone() for k in cache} for _, tp in shares]
        whole, _ = attn.decode_attention(full, x, pos, cache, cfg, window=cfg.sliding_window)
        parts = [attn.decode_attention(p, x, pos, c, cfg, window=cfg.sliding_window, tp=tp)[0]
                 for (p, tp), c in zip(shares, caches)]
    elif kind == "mlp":
        whole = mlp_apply(full, x, cfg.mlp_act)
        parts = [mlp_apply(p, x, cfg.mlp_act, tp=tp) for p, tp in shares]
    elif kind == "moe":
        whole = moe_mod.moe_apply(full, x, cfg)[0]
        parts = [moe_mod.moe_apply(p, x, cfg, tp=tp)[0] for p, tp in shares]
    else:
        hl = ssm_mod.ssm_dims(cfg)[1] // TP_SIZE
        caches = [{"conv": cache["conv"][..., ssm_mod.mixer_columns(cfg, TP_SIZE, r,
                                                                    x.device)["conv_w"]],
                   "state": cache["state"][:, r * hl:(r + 1) * hl].clone()}
                  for r in range(TP_SIZE)]
        whole, _ = ssm_mod.ssm_decode(full, x, cache, cfg)
        mixed = [ssm_mod.shard_mixer(p, cfg, tp)[0] for p, tp in shares]
        vs = [ssm_mod.ssm_decode_gated(m, x, c, cfg) for m, c in zip(mixed, caches)]
        ss = torch.stack([v.square().sum(-1, keepdim=True) for v in vs]).sum(0)
        d_inner = ssm_mod.ssm_dims(cfg)[0]
        parts = [ssm_mod.gated_norm_out(m, v, ss, d_inner, cfg.norm_eps, x.dtype)
                 for m, v in zip(mixed, vs)]
        state = torch.cat([c["state"] for c in caches], 1)
        rel = tp_rel_rms({"state": state}, {"state": cache["state"]})["state"]
        log(f"[serve tp] {cfg.name} ssm: the ranks' new states against the whole's heads: "
            f"relative RMS {rel:.3g} (limit {MODEL_LIMIT})")
        if not rel <= MODEL_LIMIT:
            raise AssertionError(f"{cfg.name} ssm: the ranks' states are not the whole's heads")
    parts = torch.stack([t.float() for t in parts])
    keep = [r for r in range(TP_SIZE) if r != drop]
    return whole, parts.sum(0), parts[keep].sum(0)


def phase_serve_model_axis(kernels: list) -> dict:
    """Phase 28 (d): one full-width decode layer each of ``SERVE_TP_LAYERS``
    as TP_SIZE model ranks' shares run in turn at their local shapes
    (``SequentialModelAxis``), summed and held to the whole layer within
    MODEL_LIMIT relative RMS, a rank's partial dropped must fail; every
    decode launch of the shares held to its plain version.  Then the decode
    kernel at the attention shares' local shapes and the stats variant at
    phase 28 (c)'s, timed beside the bound, the plain version and SDPA."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    b, c, pos = SERVE_TP_BATCH, SERVE_TP_CAP, SERVE_TP_POS
    out = {"serve_tp_layers": {}}
    for arch, kinds in SERVE_TP_LAYERS:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(282)
        with torch.no_grad():
            (lp,) = tf._init_stack(cfg.replace(n_layers=1), torch.bfloat16, gen,
                                   torch.device("cuda"), cross=False)
        blocks = {"attn": lp["mixer"], "ssm": lp["mixer"], "mlp": lp.get("ffn"),
                  "moe": lp.get("ffn")}

        def first(t):
            return {k: first(v) for k, v in t.items()} if isinstance(t, dict) else t[0]
        x = torch.randn((b, 1, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
        for kind in kinds:
            full = first(blocks[kind])
            cache = None
            if kind == "attn":
                kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
                cache = {n: torch.randn((b, c, kv, dh), generator=gen, device="cuda")
                         .to(torch.bfloat16) for n in ("k", "v")}
                cache["slot_pos"] = torch.where(torch.arange(c, device="cuda") < pos,
                                                torch.arange(c, device="cuda"), -1).int()
            elif kind == "ssm":
                cache = ssm_mod.init_ssm_cache(cfg, b, "cuda")
                for t in cache.values():
                    t.normal_(generator=gen)
            ratios = []
            ops.reset_launch_counts()
            with torch.no_grad(), checked_ops(ratios):
                whole, summed, dropped = serve_block_sum(kind, cfg, full, x, pos, cache,
                                                         drop=TP_SIZE - 1)
            counts = ops.launch_counts()
            rel = tp_rel_rms({"out": summed}, {"out": whole})["out"]
            ctrl = tp_rel_rms({"out": dropped}, {"out": whole})["out"]
            want = {**NO_LAUNCHES, **({"decode_attention": 1 + TP_SIZE} if kind == "attn"
                                      else {})}
            tag = f"[serve tp] {cfg.name} {kind}"
            log(f"{tag}: {TP_SIZE} ranks' shares summed against the whole layer at B={b}"
                f"{f' C={c} pos {pos}' if kind == 'attn' else ''}: relative RMS {rel:.3g} "
                f"(limit {MODEL_LIMIT}); control: rank {TP_SIZE - 1}'s partial dropped "
                f"{ctrl:.3g}; launches {counts}"
                + (f"; each decode launch against its plain version: worst "
                   f"{max(ratios):.3f}" if ratios else ""))
            if not (rel <= MODEL_LIMIT < ctrl and counts == want
                    and (not ratios or max(ratios) <= 1)):
                raise AssertionError(f"{tag}: shares {rel}, control {ctrl}, launches {counts} "
                                     f"(want {want}), decode ratios {ratios}")
            out["serve_tp_layers"][f"{cfg.name} {kind}"] = {
                "batch": b, "rel_rms": rel, "control": ctrl, "launches": counts,
                "decode_worst_ratio": max(ratios) if ratios else None}
            del full, cache, whole, summed, dropped
        del lp, blocks
        torch.cuda.empty_cache()
    llama, pali = get_config("llama3_8b"), get_config(VLM_ARCH)
    kernels[2]["serve_tp_local"] = {
        name: decode_at(f"[serve tp decode {name}]", b, c, cfg.n_heads // TP_SIZE,
                        max(cfg.n_kv_heads // TP_SIZE, 1), cfg.resolved_head_dim, seed)
        for name, cfg, seed in (("llama3-8b", llama, 283), ("paligemma-3b", pali, 284))}
    kernels[5].update(stats_at("[stats]", 1, CTX_CAP // RAIL_SHARDS, llama.n_heads,
                               llama.n_kv_heads, llama.resolved_head_dim, 285))
    out["serve_tp_s"] = time.perf_counter() - t0
    log(f"[serve tp] phase 28 (d) ok in {out['serve_tp_s']:.1f} s")
    return out


def stats_at(tag: str, b, c, h, kv, dh, seed) -> dict:
    """The flash-decode stats variant at one rail shard's shape (bf16, all
    slots valid): held to ``ref.decode_attention(return_stats=True)`` by
    ``ref.stats_tolerance_ratio``, also with its first split empty; a split
    or a tile of the kernel's plan dropped must fail; times beside the
    bound, the plain version and SDPA
    (the normalised output: no PyTorch call returns the unnormalised
    stats)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    shape = f"B={b} C={c} H={h} KV={kv} dh={dh} bf16, all slots valid"
    q, kc, vc, valid = decode_inputs(b, c, h, kv, dh, torch.bfloat16, "all", seed=seed)
    want = ref.decode_attention(q, kc, vc, valid, return_stats=True)
    got = da.decode_attention_stats(q, kc, vc, valid)
    ratio = ref.stats_tolerance_ratio(got, want, q.dtype)
    err = max(max_err(g, w) for g, w in zip(got, want))
    split = decode_split(b, c, h, kv, dh)
    first_empty = valid.clone()
    first_empty[:, :split] = False
    ratio_empty = ref.stats_tolerance_ratio(
        da.decode_attention_stats(q, kc, vc, first_empty),
        ref.decode_attention(q, kc, vc, first_empty, return_stats=True), q.dtype)
    ctrls = {}
    for label, lo, hi in decode_drops(b, c, h, kv, dh):
        dropped = valid.clone()
        dropped[:, lo:hi] = False
        ctrls[label] = ref.stats_tolerance_ratio(
            got, ref.decode_attention(q, kc, vc, dropped, return_stats=True), q.dtype)
    ctrl = min(ctrls.values())
    log(f"{tag} {shape}: max_abs_err {err:.3g} (acc, m, l), {ratio:.3f} of the tolerance; "
        f"first {split}-slot split empty {ratio_empty:.3f}; controls: plain with " + ", ".join(
            f"{label} {r:.1f}" for label, r in ctrls.items()) + " (each must exceed 1)")
    if not (ratio <= 1 and ratio_empty <= 1 and ctrl > 1):
        raise AssertionError(f"{tag}: stats {ratio}, empty split {ratio_empty}, control {ctrl}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
    am = valid[:, None, None, :]
    t = timings(lambda: da.decode_attention_stats(q, kc, vc, valid),
                lambda: ref.decode_attention(q, kc, vc, valid, return_stats=True),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                                       enable_gqa=True), 40)
    n_valid = int(valid.sum().item())
    nbytes = 2 * n_valid * kv * dh * 2 + 2 * b * h * dh + 4 * b * h * (dh + 2) + b * c
    t.update(bound(4 * n_valid * h * dh, nbytes))
    log(f"{tag} {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms plain, {t['library_ms']:.4f} ms "
        f"sdpa (CUDA events; device time {t['device_ms']} / {t['plain_device_ms']} / "
        f"{t['library_device_ms']}), bound {t['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB)")
    return {"shape": shape, "max_abs_err": err, "tolerance_ratio": ratio,
            "empty_split_ratio": ratio_empty, "control_ratio": ctrl, **t}


def pipe_faults(n: int) -> dict:
    """``LocalPipe`` hand-offs, each with a planted fault: microbatch 0's
    activations lost on the way from stage 0 to stage 1; stage 1 keeping
    its own input cotangent instead of receiving stage 2's; every forward
    hand-off two stages on instead of one."""
    import torch
    from repro_torch.parallel.pipeline import LocalPipe

    class Faulty(LocalPipe):
        def __init__(self, fault: str):
            super().__init__(n)
            self.fault, self.ticks = fault, 0

        def shift(self, xs, delta):
            if delta > 0:
                self.ticks += 1
                if self.fault == "shift_by_two":
                    return super().shift(xs, 2)
            out = super().shift(xs, delta)
            if self.fault == "microbatch_dropped" and delta > 0 and self.ticks == 2:
                out[1] = torch.zeros_like(out[1])
            if self.fault == "cotangent_not_shifted" and delta < 0:
                out[1] = xs[1]
            return out
    return {f: Faulty(f) for f in ("microbatch_dropped", "cotangent_not_shifted",
                                   "shift_by_two")}


def stages_joined(grads: list) -> dict:
    """{path: tensor} of the whole tree from the stages' trees in stage
    order: the layer leaves' rows concatenated, the others stage 0's."""
    import torch
    from repro_torch import bridge
    flats = [bridge.flatten(g) for g in grads]
    return {p: torch.cat([f[p] for f in flats]) if p.startswith("layers") else v
            for p, v in flats[0].items()}


def phase_pipeline() -> dict:
    """Phase 29: the GPipe pipeline on h2o-danube-3-4b (see the docstring)."""
    import statistics

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import pipeline
    from repro_torch.train.step import autograd_leaves
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    launch_train.init_distributed(dev)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
    step = pipeline.make_pipeline_train_step(cfg, mesh, pipe_axis="pipe", n_micro=PIPE_MICRO,
                                             lr=PIPE_LR)
    params = tf.init_lm(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (PIPE_MICRO, PIPE_SEQ), generator=gen,
                              device=dev) for k in ("tokens", "targets")}
    tag = (f"[pipeline] {cfg.name} {cfg.n_layers} layers, {PIPE_MICRO} microbatches of 1 x "
           f"{PIPE_SEQ}")
    # (a)'s gradients at the initial parameters: what (b) and (c) are held to
    grads_a, loss_a = step.grads_fn(params, batch)
    want = stages_joined([grads_a])
    del grads_a
    # (b) the stages in turn, a local hand-off in place of the shift
    trees = [pipeline.stage_params(params, s, PIPE_STAGES) for s in range(PIPE_STAGES)]

    def local(pipe):
        grads, loss = pipeline.pipeline_grads(trees, batch, cfg, pipe=pipe, n_micro=PIPE_MICRO)
        return loss[0], stages_joined(grads)
    loss_b, got = local(pipeline.LocalPipe(PIPE_STAGES))
    unequal = [p for p, w in want.items() if not torch.equal(got[p], w)]
    worst_b = max(leaf_rel_rms(got, want).values())
    del got
    log(f"{tag} (b) {PIPE_STAGES} stages in turn: loss {float(loss_b):.6f} against (a)'s "
        f"{float(loss_a):.6f} ({'bit-equal' if torch.equal(loss_b, loss_a) else 'differs'}); "
        f"{len(want) - len(unequal)} of {len(want)} gradient leaves bit-equal (worst relative "
        f"RMS {worst_b:.3g})")
    if unequal or not torch.equal(loss_b, loss_a):
        raise AssertionError(f"phase 29 (b): loss {float(loss_b)} against {float(loss_a)}, "
                             f"leaves not bit-equal {unequal[:5]}")
    faults = {}
    for name, pipe in pipe_faults(PIPE_STAGES).items():
        _, got = local(pipe)
        faults[name] = max(leaf_rel_rms(got, want).values())
        del got
    log(f"{tag} (b) planted faults, worst leaf's relative RMS (must exceed {PIPE_LIMIT}; nan "
        "or inf: gradients no longer finite): " + ", ".join(f"{k} {v:.3g}"
                                                          for k, v in faults.items()))
    if any(math.isfinite(v) and v <= PIPE_LIMIT for v in faults.values()):
        raise AssertionError(f"phase 29 (b): a planted fault passed: {faults}")
    del trees
    # (c) against lm_loss (aux weight 0) over the whole batch, the same kernels
    gbuf = tree_map(torch.zeros_like, params)
    loss_c, _ = tf.lm_loss(autograd_leaves(params, gbuf), batch, cfg, aux_weight=0.0)
    loss_c.backward()
    rel_c = leaf_rel_rms(stages_joined([gbuf]), want)
    worst_c = max(rel_c, key=rel_c.get)
    del gbuf, want
    log(f"{tag} (c) against lm_loss over the whole batch: loss {float(loss_c):.6f} (|diff| "
        f"{abs(float(loss_c) - float(loss_a)):.3g}); worst leaf {worst_c} {rel_c[worst_c]:.4g} "
        f"relative RMS, median {statistics.median(rel_c.values()):.4g} (limit {PIPE_LIMIT})")
    if not all(math.isfinite(v) and v <= PIPE_LIMIT for v in rel_c.values()) or \
            not abs(float(loss_c) - float(loss_a)) <= 1e-3:
        raise AssertionError(f"phase 29 (c): {worst_c} {rel_c[worst_c]}, loss {float(loss_c)} "
                             f"against {float(loss_a)}")
    # (a) the step through its entry point, timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    ops.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    want_launches = n_mixers(cfg)[0] * PIPE_MICRO
    step_ms = statistics.median(times[1:])
    tokens = PIPE_MICRO * PIPE_SEQ
    log(f"{tag} (a) one-rank pipe group over NCCL: losses {[round(x, 4) for x in losses]} (SGD "
        f"lr {PIPE_LR}); step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}; first "
        f"{times[0]:.1f}), {tokens / step_ms * 1e3:.0f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB; flash launches a step {per_step['flash_attention']:g} forward, "
        f"{per_step['flash_attention_bwd']:g} backward (expected {want_launches} each)")
    if losses[0] != float(loss_a) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 29 (a): losses {losses}, grads_fn's {float(loss_a)}")
    if per_step["flash_attention"] != want_launches or \
            per_step["flash_attention_bwd"] != want_launches:
        raise AssertionError(f"phase 29 (a): launches a step {per_step}")
    busy, dev = device_profile(lambda: step(params, batch), f"{tag} (a) one step", top=10)
    del params
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    out = {"pipe_arch": cfg.name, "pipe_micro": PIPE_MICRO, "pipe_seq": PIPE_SEQ,
           "pipe_stages_b": PIPE_STAGES, "pipe_losses": losses, "pipe_step_ms": step_ms,
           "pipe_step_times_ms": times, "pipe_tokens_per_s": tokens / step_ms * 1e3,
           "pipe_peak_gib": peak / 2**30, "pipe_launches": launches, "pipe_busy": busy,
           "pipe_device_ms": sum(dev.values()) if dev else None,
           "pipe_launches_per_step": per_step, "pipe_b_bit_equal": True,
           "pipe_b_worst_rel_rms": worst_b, "pipe_fault_rel_rms": faults,
           "pipe_c_worst_leaf": worst_c, "pipe_c_worst_rel_rms": rel_c[worst_c],
           "pipe_c_median_rel_rms": statistics.median(rel_c.values()),
           "pipe_c_loss_diff": abs(float(loss_c) - float(loss_a)),
           "pipe_s": time.perf_counter() - t_phase}
    log(f"[pipeline] phase 29 ok in {out['pipe_s']:.1f} s")
    return out


def phase_calibration() -> dict:
    """Phase 30: the calibration suite at the full configurations' shapes on
    the card (see the docstring)."""
    import torch
    from repro_torch.analysis.calibrate import CalibrationTable
    from repro_torch.kernels import ops
    from repro_torch.launch.calibrate import table_lines
    from repro_torch.profiling import microbench as mb
    t_phase = time.perf_counter()
    cases = mb.kernel_cases(smoke=False)

    def phase_times(msg: str):
        if msg.startswith("phase"):
            log(f"[calib] {msg}")
    ops.reset_launch_counts()
    art = mb.run_suite(device="cuda", smoke=False, repeats=5, target_gpu="h100",
                       progress=phase_times)
    launches = ops.launch_counts()
    skipped = [(r.key, r.shape_class, r.skip_reason) for r in art.records if r.skipped]
    bad = [s for s in skipped if s[2] not in CALIB_BY_DESIGN]
    for key, (dev_s, wall_s) in art.provenance["phase_seconds"].items():
        log(f"[calib] {key}: kernels {dev_s * 1e3:.4f} ms, wall {wall_s * 1e3:.4f} ms, "
            f"busy {100 * dev_s / wall_s:.1f} %")
    log(f"[calib] kernel cases' worst tolerance ratio against the plain versions: "
        f"{art.provenance['max_tolerance_ratio']}")
    # planted fault: one flash case whose output loses its last query row
    case = next(c for c in cases if c.key == "flash_attention")

    def dropped_row(device, make=case.make):
        fn, args = make(device)

        def dropped(*a):
            out = fn(*a).clone()
            out[:, -1] = 0.0
            return out
        return dropped, args
    planted = mb.BenchCase(case.key, case.shape_class, case.shape, dropped_row, case.plain,
                           case.ratio)
    try:
        mb.measure_case(planted, "cuda", repeats=1, warmup=0, trim=0)
    except RuntimeError as e:
        if "disagrees" not in str(e):
            raise
        log(f"[calib] planted fault (last query row dropped) {case.shape}: raised: {e}")
    else:
        raise AssertionError("phase 30: a flash case without its last query row passed "
                             "measure_case's check")
    # the step phase differentiates one leaf a period: no zero-filled stack
    from repro_torch.configs import get_config
    fn, args = mb.step_phase(get_config("llama3_8b"), 4, device="cuda")
    with mb.OpRecord() as rec:
        fn(*args)
    torch.cuda.synchronize()
    n_select = rec.ops["aten.select_backward"]
    log(f"[calib] step phase, llama3-8b at 4 layers: {sum(rec.ops.values())} aten ops, "
        f"{n_select} aten.select_backward, {rec.allocated / 2**30:.2f} GiB allocated")
    if n_select:
        raise AssertionError(f"phase 30: the step phase ran {n_select} select_backward")
    del fn, args
    CALIB_DIR.mkdir(exist_ok=True)
    art.save(str(CALIB_DIR / "CALIB_h100_timings.json"))
    table = CalibrationTable.fit(art)
    table.save(str(CALIB_DIR / "CALIB_h100_table.json"))
    for line in table_lines(table):
        log(f"[calib] {line}")
    log(f"[calib] {len(art.records)} records ({sum(r.valid for r in art.records)} valid), "
        f"{len(cases)} kernel cases; skipped by design {skipped}; launches {launches}; "
        f"-> {CALIB_DIR}/CALIB_h100_{{timings,table}}.json")
    if bad:
        raise AssertionError(f"phase 30: skips {bad} beside the by-design ones")
    out = {"calib_records": len(art.records), "calib_valid": sum(r.valid for r in art.records),
           "calib_skipped": skipped, "calib_launches": launches,
           "calib_max_tolerance_ratio": art.provenance["max_tolerance_ratio"],
           "calib_provenance": art.provenance,
           "calib_samples": [[r.key, r.shape_class, r.shape, r.flops, r.bytes_accessed,
                              r.t_mean_s, r.t_min_s] for r in art.records],
           "calib_table": [[e.key, e.shape_class, e.n_samples, e.achieved_flops_per_s,
                            e.eff_mfu, e.eff_hbm, e.rms_rel_err] for e in table.entries],
           "calib_step_select_backward": n_select,
           "calib_s": time.perf_counter() - t_phase}
    log(f"[calib] phase 30 ok in {out['calib_s']:.1f} s")
    return out


RESIDENT_RAILS = 8  # phase 31 (b) and (c): rail ranks run in turn


def phase_resident_decode(cfg, params) -> dict:
    """Phase 31: weight-resident decode at full width (see the docstring)."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import resident as res
    from repro_torch.serve.step import (ServeSetup, init_serve_state, make_decode_step,
                                        resident_decode_step)
    from repro_torch.train import step as st
    t_phase = time.perf_counter()
    b, cap, n_forced, n_gen = 8, 4096, 8, 8
    steps, n_attn = n_forced + n_gen, n_mixers(cfg)[0]
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (b, n_forced), generator=gen, device="cuda")

    # (a) the one-device mesh: the resident step's products over one rail rank
    runs = {}
    for label, resident in (("gathered", False), ("resident", True)):
        setup = ServeSetup(cfg=cfg, weight_resident=resident)
        step = make_decode_step(setup, (1, 1), params, batch=b, capacity=cap)
        state = init_serve_state(setup, (1, 1), params, b, cap)
        secs, out, launches = decode_steps(cfg, step, params, state, 0, steps, None,
                                           forced_tokens=prompt)
        combines = step.rails.combines if resident else None
        tok = out[-1].argmax(-1)
        dev = device_ms(lambda: step(params, state, tok, steps), 3)
        runs[label] = {"logits": torch.cat(out, 1), "state": state, "launches": launches,
                       "ms": secs / steps * 1e3, "device_ms": dev,
                       "launches_per_step": launches / steps,
                       "combines_per_step": None if combines is None else combines / steps}
    a, g = runs["resident"], runs["gathered"]
    logits_equal = torch.equal(a["logits"], g["logits"])
    caches_equal = all(torch.equal(x, y) for ca, cg in zip(a["state"], g["state"])
                       for x, y in zip(ca.values(), cg.values()))
    for label, r in runs.items():
        busy = r["device_ms"] / r["ms"] if r["device_ms"] else None
        r["busy"] = busy
        log(f"[resident] (a) {label} step on (1, 1), llama3-8b B={b} cap={cap}: "
            f"{r['ms']:.2f} ms a step (host), {r['device_ms']} ms device a step, busy "
            f"{'not measured' if busy is None else f'{100 * busy:.1f} %'}; flash-decode "
            f"launches a step {r['launches_per_step']:g}; rail combines a step "
            f"{r['combines_per_step']}")
    log(f"[resident] (a) logits bit-equal {logits_equal}, caches bit-equal {caches_equal}")
    if not (logits_equal and caches_equal and a["launches_per_step"] == n_attn
            == g["launches_per_step"] and a["combines_per_step"]):
        raise AssertionError("phase 31 (a): the resident step on (1, 1) is not the "
                             "gathered step's, or ran no product over the rails")

    # (b) 8 rail ranks in turn, teacher-forced on (a)'s tokens
    fd, _ = st.meta_trees(params, rails=("data",), n_rails=RESIDENT_RAILS, model_size=1)
    fd_top, fd_stacks = st._split_stacks(fd)
    forced = torch.cat([prompt] + [a["logits"][:, i:i + 1].argmax(-1)
                                   for i in range(n_forced - 1, steps - 1)], 1)

    def rails_run(rails, n: int):
        step = resident_decode_step(cfg, rails, fd_top, fd_stacks, rows=rails.rows())
        state = tf.init_decode_state(cfg, b, cap, "cuda")
        secs, out, launches = decode_steps(cfg, step, params, state, 0, n, None,
                                           forced_tokens=forced[:, :n])
        return torch.cat(out, 1), secs / n * 1e3, launches
    got, ms_b, launches_b = rails_run(SequentialRails(RESIDENT_RAILS), steps)
    e_b = position_rel_rms(got, a["logits"])
    n_fault = 2
    faults = {"rank 3's partial sums dropped": SequentialRails(RESIDENT_RAILS, drop=3),
              "output slices gathered in another order": SequentialRails(
                  RESIDENT_RAILS, order=[1, 0] + list(range(2, RESIDENT_RAILS)))}
    fault_err = {k: position_rel_rms(rails_run(r, n_fault)[0], a["logits"][:, :n_fault])
                 for k, r in faults.items()}
    log(f"[resident] (b) {RESIDENT_RAILS} rail ranks in turn, {cfg.n_layers} layers, "
        f"{steps} steps teacher-forced on (a)'s tokens ({ms_b:.1f} ms a step, {launches_b} "
        f"flash-decode launches): worst "
        f"position's relative RMS of the logits against (a) {e_b:.4g} (limit {MODEL_LIMIT}); "
        f"planted faults (must exceed it): "
        + ", ".join(f"{k} {v:.3g}" for k, v in fault_err.items()))
    if not (e_b <= MODEL_LIMIT and min(fault_err.values()) > MODEL_LIMIT):
        raise AssertionError(f"phase 31 (b): {e_b}, faults {fault_err}")

    # (c) the bytes a step each path would send over 8 rails (a count of its ops)
    rails = SequentialRails(RESIDENT_RAILS)
    step = resident_decode_step(cfg, rails, fd_top, fd_stacks, rows=rails.rows())
    state = tf.init_decode_state(cfg, b, cap, "cuda")
    step(params, state, prompt[:, :1], 0)
    gathered = SequentialRails(RESIDENT_RAILS)
    top = {k: params[k] for k in ("embed", "unembed", "final_norm") if k in params}
    gp = dict(res.place(top, {k: fd_top[k] for k in top}, gathered, resident=False),
              layers=params["layers"])
    with torch.no_grad():
        tf.decode_step(gp, tf.init_decode_state(cfg, b, cap, "cuda"), prompt[:, :1], 0, cfg,
                       layer_param_fn=lambda per: res.place(per, fd_stacks["layers"], gathered,
                                                            dim_off=-1, resident=False))
    want = {True: rail_bytes_by_fsdp_dims(cfg, b, RESIDENT_RAILS, True),
            False: rail_bytes_by_fsdp_dims(cfg, b, RESIDENT_RAILS, False)}
    log(f"[resident] (c) rail bytes a step (one token a row, B={b}) each rank would send at "
        f"{RESIDENT_RAILS} rails: resident {rails.sent} (by the FSDP dims {want[True]}), "
        f"gathered {gathered.sent} (by the FSDP dims {want[False]}); gathered / resident "
        f"{gathered.sent / rails.sent:.1f}")
    if rails.sent != want[True] or gathered.sent != want[False]:
        raise AssertionError("phase 31 (c): a path's rail bytes differ from its count")
    out = {"resident_ms_per_step": a["ms"], "resident_device_ms_per_step": a["device_ms"],
           "resident_busy": a["busy"], "resident_gathered_ms_per_step": g["ms"],
           "resident_gathered_device_ms_per_step": g["device_ms"],
           "resident_decode_launches": a["launches"],
           "resident_launches_per_step": a["launches_per_step"],
           "resident_combines_per_step": a["combines_per_step"],
           "resident_rails_decode_launches": launches_b,
           "resident_rails_rel_rms": e_b, "resident_rails_ms_per_step": ms_b,
           "resident_faults": fault_err, "resident_rail_bytes": rails.sent,
           "gathered_rail_bytes": gathered.sent, "resident_s": time.perf_counter() - t_phase}
    log(f"[resident] phase 31 ok in {out['resident_s']:.1f} s")
    return out


def plane_point(cfg, axes: dict, ocs: float, table):
    """(modeled step s, overhead over native EPS, reconfigurations) of
    ``cfg``'s training job on a mesh of ``axes`` at OCS latency ``ocs``, as
    ``sim.opus_sim.mesh_plane_profile`` maps it (TP the model axis, FSDP
    data x pod) on the h100 profile, under the calibration ``table`` (None:
    the flat MFU)."""
    from repro_torch.core import phases as ph
    from repro_torch.sim.opus_sim import SimParams, simulate
    from repro_torch.sim.workload import build
    tp, dp = axes.get("model", 1), axes.get("data", 1) * axes.get("pod", 1)
    job = ph.JobConfig(model=cfg, tp=tp, fsdp=dp, global_batch=max(PLANE_BATCH, dp),
                       seq_len=PLANE_SEQ)
    wl = build(job, "h100")
    native = simulate(wl, SimParams(mode="native", calibration=table)).step_time
    r = simulate(wl, SimParams(mode="opus_prov", ocs_latency=ocs, calibration=table))
    return r.step_time, r.step_time / native - 1, r.n_reconfigs


def phase_plane(smi: str) -> dict:
    """Phase 32: the control plane over the H100 calibration (see the
    docstring)."""
    import torch
    from repro_torch.analysis.calibrate import CalibrationTable
    from repro_torch.configs import get_config
    from repro_torch.sim.opus_sim import mesh_plane_profile
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--mesh",
           "1x1", "--steps", "2", "--batch", "1", "--seq", "1024", "--plane-report",
           "--ocs-latency", "0.01"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    report = res.stdout[res.stdout.find("control plane report"):]
    for line in res.stdout.strip().splitlines():
        log(f"[plane] (a) {line}")
    if res.returncode != 0 or not report.startswith(
            "control plane report (TP=1 FSDP=1, OCS 10 ms):"):
        raise AssertionError(f"phase 32 (a): the driver exited {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    cfg = get_config(PLANE_ARCH)
    table = CalibrationTable.load(str(CALIB_DIR / "CALIB_h100_table.json"))
    points = {}
    for mesh, axes in PLANE_MESHES.items():
        for ocs in PLANE_LATENCIES:
            p = mesh_plane_profile(cfg, axes, global_batch=PLANE_BATCH, seq_len=PLANE_SEQ,
                                   gpu="h100", ocs_latency=ocs)
            flat = (p["modeled_step_s"], p["overhead_vs_native"], p["n_reconfigs"])
            mine = plane_point(cfg, axes, ocs, None)
            fitted = plane_point(cfg, axes, ocs, table)
            log(f"[plane] (b) {PLANE_ARCH} {mesh} OCS {ocs * 1e3:g} ms: flat h100 MFU: step "
                f"{flat[0]} s, {100 * flat[1]:.4f} % over native EPS, {flat[2]} reconfigs; "
                f"H100 fitted table: step {fitted[0]:.6f} s, {100 * fitted[1]:.4f} % over "
                f"native EPS, {fitted[2]} reconfigs ({smi})")
            if flat != PLANE_PINNED[mesh, ocs] or (round(mine[0], 6), round(mine[1], 6),
                                                   mine[2]) != flat:
                raise AssertionError(f"phase 32 (b) {mesh} {ocs}: {flat} / {mine}, pinned "
                                     f"{PLANE_PINNED[mesh, ocs]}")
            points[f"{mesh} {ocs}"] = {"flat": flat, "fitted": fitted}
    out = {"plane_report": report.strip().splitlines(), "plane_points": points,
           "plane_s": time.perf_counter() - t_phase}
    log(f"[plane] phase 32 ok in {out['plane_s']:.1f} s")
    return out


# The decode backward (phase 33): the cache filled to DECODE_GRAD_FILLED of
# its 4096 slots (random K/V, as a prefill leaves it), one decode step at
# full width on DECODE_GRAD_LAYERS of the model's layers, its loss a fixed
# random cotangent against the logits; gradients of every parameter leaf and
# of the caches through the kernels held to those through the plain version
# within MODEL_LIMIT relative RMS per leaf.
DECODE_GRAD_LAYERS, DECODE_GRAD_FILLED = 2, 4064


def decode_bwd_times(q, kc, vc, valid, do, tag: str) -> dict:
    """The decode backward kernel given the forward's residuals (made once by
    the forward kernel's residual mode, not timed with it), its plain
    version and the library's yardstick (``scaled_dot_product_attention``
    with one query and the boolean mask, forward then backward through
    autograd): CUDA events and device times, and the bound: K and V of the
    valid slots read once, dK and dV of every slot written once (q, do and
    dq beside them), or ten FLOPs a (valid slot, head, dim) at the bf16
    peak; the three-pass kernel before it had the same count, so the two
    compare.  Beside it the bytes of the dq partials (written once, read
    once) and the forward kernel's device time with and without its
    residuals."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_bwd as dab
    from repro_torch.kernels import ref
    b, c, kv, dh = kc.shape
    h, es = q.shape[2], kc.element_size()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, kc, vc))
    dot, am = do.transpose(1, 2).contiguous(), valid[:, None, None, :]
    _, lse, o32 = da.decode_attention(q, kc, vc, valid, residuals=True)

    def library():
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)
    t = timings(lambda: dab.decode_attention_bwd(q, kc, vc, valid, do, lse=lse, o=o32),
                lambda: ref.decode_attention_bwd(q, kc, vc, valid, do), library, 40)
    n_valid = int(valid.sum().item())
    nbytes = 2 * n_valid * kv * dh * es + 2 * b * c * kv * dh * es + 3 * b * h * dh * es + b * c
    t.update(bound(10 * n_valid * h * dh, nbytes))
    lib = dab.KERNEL.lib()
    split = lib.repro_decode_bwd_split(b, c, kv, dh)
    nsplit = lib.repro_decode_bwd_num_splits(b, c, kv, dh)
    t.update(split=split, dq_partial_bytes=b * kv * nsplit * (h // kv) * dh * 4,
             fwd_device_ms=device_ms(lambda: da.decode_attention(q, kc, vc, valid), 40),
             fwd_residuals_device_ms=device_ms(
                 lambda: da.decode_attention(q, kc, vc, valid, residuals=True), 40))
    dev_ms = t["device_ms"] or t["ms"]
    log(f"{tag} {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms plain, {t['library_ms']:.4f} ms "
        f"sdpa forward + backward (CUDA events; device time {t['device_ms']} / "
        f"{t['plain_device_ms']} / {t['library_device_ms']}), bound {t['bound_ms']:.4f} ms "
        f"({nbytes / 1e6:.1f} MB); {nbytes / dev_ms / 1e6:.0f} GB/s achieved, "
        f"{100 * t['bound_ms'] / dev_ms:.1f} % of the bound (device time); {split}-slot splits, "
        f"{b * kv * nsplit} blocks, dq partials {t['dq_partial_bytes'] / 1e6:.2f} MB written "
        f"and read; forward {t['fwd_device_ms']} ms device, with its residuals "
        f"{t['fwd_residuals_device_ms']} ms")
    return t


def decode_bwd_at(tag: str, b, c, h, kv, dh, dtype, kind, seed, timed: bool = False) -> dict:
    """The decode backward kernel at one shape, through both routes to the
    forward's residuals (``ops.decode_attention``'s autograd, whose forward
    kernel keeps them, and the backward's wrapper alone): dq, dk and dv held
    to the plain version's autograd by ``ref.grad_tolerance_ratio``; its
    planted faults (``decode_bwd_faults``) must fail the same check; a
    second call on the same inputs must give bit-identical gradients (no
    atomics); the forward's rounded output with residuals must be the plain
    mode's bit for bit."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_bwd as dab
    from repro_torch.kernels import ops, ref
    q, kc, vc, valid = decode_inputs(b, c, h, kv, dh, dtype, kind, seed=seed)
    do = decode_inputs(b, 1, h, kv, dh, dtype, "all", seed=seed + 100)[0]
    out, lse, o32 = da.decode_attention(q, kc, vc, valid, residuals=True)
    if not torch.equal(out, da.decode_attention(q, kc, vc, valid)):
        raise AssertionError(f"{tag}: the forward's output with residuals differs")
    ins = [t.clone().requires_grad_() for t in (q, kc, vc)]
    ops.decode_attention(*ins, valid).backward(do)
    routes = {"autograd": tuple(t.grad for t in ins),
              "wrapper": dab.decode_attention_bwd(q, kc, vc, valid, do)}
    want = ref.decode_attention_bwd(q, kc, vc, valid, do)
    shape = f"B={b} C={c} H={h} KV={kv} dh={dh} {dtype} mask={kind}"
    worst, worst_ratio = 0.0, 0.0
    for route, got in routes.items():
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, ratio = hold(f"{tag} {shape} ({route}): {name}", g, w,
                              ref.grad_tolerance_ratio)
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    got = dab.decode_attention_bwd(q, kc, vc, valid, do, lse=lse, o=o32)
    again = dab.decode_attention_bwd(q, kc, vc, valid, do, lse=lse, o=o32)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{tag} {shape}: two calls gave different gradients")
    masked = ~valid
    if got[1][masked].any() or got[2][masked].any():
        raise AssertionError(f"{tag} {shape}: a masked slot's dk or dv is not zero")
    faults = decode_bwd_faults(q, kc, vc, valid, do, want,
                               dab.KERNEL.lib().repro_decode_bwd_split(b, c, kv, dh))
    ctrl = min(control(f"{tag} control: {label}", f, w, ref.grad_tolerance_ratio)
               for label, f, w in faults)
    out = {"shape": shape, "max_abs_err": worst, "tolerance_ratio": worst_ratio,
           "control_ratio": ctrl}
    if timed:
        out.update(decode_bwd_times(q, kc, vc, valid, do, tag))
    return out


def phase_decode_bwd_kernel() -> dict:
    """Phase 33 (a): the decode backward kernel at llama3-8b's decode shape
    (B=8, a full 4096-slot cache, 32 heads on 8 kv heads, dh 128) and
    paligemma-3b's (8 heads on one kv head, dh 256), bf16, timed; a ragged
    cache in bf16, a ragged mask in f32 and mistral-large-123b's 96 heads on
    8 kv heads (12 a group, not a power of two: the kernel's block pads the
    group to 16 heads, which must add nothing) besides."""
    import torch
    bf16 = torch.bfloat16
    t_phase = time.perf_counter()
    main = decode_bwd_at("[decode bwd]", 8, 4096, 32, 8, 128, bf16, "all", 61, timed=True)
    vlm = decode_bwd_at("[decode bwd paligemma]", 8, 4096, *VLM_ATTN, bf16, "all", 62,
                        timed=True)
    edges = [decode_bwd_at("[decode bwd]", 8, 4100, 32, 8, 128, bf16, "holes", 63),
             decode_bwd_at("[decode bwd]", 8, 4096, 32, 8, 128, torch.float32, "prefix", 64),
             decode_bwd_at("[decode bwd mistral-large]", 8, 4096, 96, 8, 128, bf16, "holes",
                           65)]
    log(f"[decode bwd] phase 33 (a) ok in {time.perf_counter() - t_phase:.1f} s")
    return {"name": "decode_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention_bwd.cu",
            "replaces": "src/repro/kernels/decode_attention.py:75",
            "tolerance": "dq, dk, dv: 1e-5 + 2^-7 |plain| (bf16), 1e-4 (f32)",
            **main, "max_abs_err": max(r["max_abs_err"] for r in (main, *edges)),
            "tolerance_ratio": max(r["tolerance_ratio"] for r in (main, *edges)),
            "paligemma": vlm, "edges": edges}


def decode_grad_run(cfg2, leaves, caches, state0, token, pos: int, seed: int):
    """One decode step at ``pos`` through ``tf.decode_step`` with gradients:
    ``leaves`` the parameter leaves (``train.step.period_leaves``),
    ``caches`` one {"k", "v"} leaf pair a period position (stacked over the
    periods), the state's other entries from ``state0``; returns
    {name: gradient} of every leaf and cache for the loss sum(g * logits),
    g standard normal from ``seed``."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.tree import leaves as tree_leaves
    n = tf.n_periods(cfg2)
    state = []
    for c0, leaf in zip(state0, caches):
        # one tensor a period: each period writes its slot into its own tensor
        state.append({"k": [leaf["k"][p].clone() for p in range(n)],
                      "v": [leaf["v"][p].clone() for p in range(n)],
                      "slot_pos": c0["slot_pos"].clone()})
    with torch.enable_grad():
        logits, _ = tf.decode_step(leaves, state, token, pos, cfg2)
        gen = torch.Generator(device=logits.device).manual_seed(seed)
        g = torch.randn(logits.shape, generator=gen, device=logits.device)
        loss = (logits.float() * g).sum()
        params = tree_leaves(leaves)
        kv = [t for c in caches for t in (c["k"], c["v"])]
        grads = torch.autograd.grad(loss, params + kv, allow_unused=True)
    names = [f"param {i}" for i in range(len(params))] + \
        [f"cache {i // 2} {'kv'[i % 2]}" for i in range(len(kv))]
    # a leaf decode never reads (one the prefill alone needs) has no gradient
    return {k: g for k, g in zip(names, grads) if g is not None}


def decode_grad_rel_rms(got: dict, want: dict) -> dict:
    """{name: RMS of (got - want) over the RMS of want}; a leaf whose plain
    gradient is all zero must be zero in ``got`` too."""
    if got.keys() != want.keys():
        raise AssertionError(f"gradients of {sorted(got)} against {sorted(want)}")
    out = {}
    for k, w in want.items():
        w, d = w.float(), got[k].float() - w.float()
        rms = w.pow(2).mean().sqrt().item()
        out[k] = (d.pow(2).mean().sqrt().item() / rms) if rms else (
            0.0 if not d.any() else float("inf"))
    return out


def phase_decode_grad(cfg, params, tag: str) -> dict:
    """Phase 33 (b): a decode step differentiated at full width (see
    DECODE_GRAD_LAYERS): through the kernels (the flash-decode forward and
    the decode backward, each launched once a layer), through the plain
    version, and through a planted fault of the backward (dk from each
    group's first query head only)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.step import ServeSetup, init_serve_state
    from repro_torch.train.step import period_leaves
    t_phase = time.perf_counter()
    cfg2, p2 = depth_cut(cfg, params, DECODE_GRAD_LAYERS)
    b, cap, pos = 8, 4096, DECODE_GRAD_FILLED
    state0 = init_serve_state(ServeSetup(cfg=cfg2), (1, 1), p2, b, cap)
    fill_cache(state0, pos, seed=71)
    caches = [{k: c[k].detach().clone().requires_grad_() for k in ("k", "v")} for c in state0]
    leaves = period_leaves(p2)
    gen = torch.Generator(device="cuda").manual_seed(72)
    token = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device="cuda")

    def run():
        return decode_grad_run(cfg2, leaves, caches, state0, token, pos, seed=73)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    kernel_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    want_counts = {**NO_LAUNCHES, "decode_attention": DECODE_GRAD_LAYERS,
                   "decode_attention_bwd": DECODE_GRAD_LAYERS}
    if counts != want_counts:
        raise AssertionError(f"[{tag}] launches {counts}, want {want_counts}")
    with swapped_ops(decode_attention=ref.decode_attention):
        t0 = time.perf_counter()
        want = run()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3

    def faulty_bwd(q, kc, vc, valid, do, scale=None, lse=None, o=None):
        w = ref.decode_attention_bwd(q, kc, vc, valid, do, scale=scale, lse=lse, o=o)
        return w[0], decode_bwd_faults(q, kc, vc, valid, do, w, 1)[1][1], w[2]
    with swapped_ops(decode_attention_bwd=faulty_bwd):
        fault = decode_grad_rel_rms(run(), want)
    rel = decode_grad_rel_rms(got, want)
    worst, worst_fault = max(rel.values()), max(fault.values())
    log(f"[{tag}] decode step differentiated, {DECODE_GRAD_LAYERS} of {cfg.n_layers} layers at "
        f"full width, B={b}, {pos} of {cap} slots filled: {len(rel)} gradients (every "
        f"parameter leaf, the caches); worst relative RMS against the plain version "
        f"{worst:.3g} ({max(rel, key=rel.get)}; limit {MODEL_LIMIT}); control: dk from each "
        f"group's first query head {worst_fault:.3g} (must exceed the limit); launches "
        f"{counts['decode_attention']} forward, {counts['decode_attention_bwd']} backward; "
        f"forward + backward {kernel_ms:.1f} ms through the kernels, {plain_ms:.1f} ms plain "
        f"(host clock, first call); in {time.perf_counter() - t_phase:.1f} s")
    if not worst <= MODEL_LIMIT < worst_fault:
        raise AssertionError(f"[{tag}] gradients {rel}, control {fault}")
    return {f"{tag}_rel_rms": worst, f"{tag}_control": worst_fault,
            f"{tag}_launches": counts["decode_attention_bwd"], f"{tag}_ms": kernel_ms,
            f"{tag}_plain_ms": plain_ms, f"{tag}_s": time.perf_counter() - t_phase}


# The dry-run (phase 34): (a) one cell of each shape kind on the paper's
# meshes, on this machine's CPU (meta tensors over a fake process group),
# each cell a ``python -m repro_torch.launch.dryrun`` process of its own and
# all of them at once (one core each, so (a) takes about its slowest cell);
# (b) two cells that fit one card on a (1, 1) mesh, whose predicted peak
# bytes (the dry-run's memory fit) must lie within FIT_BAND of what the card
# allocates running the same step (torch.cuda.max_memory_allocated).
DRYRUN_CELLS = (("h2o_danube_3_4b", "train_4k"), ("mamba2_370m", "prefill_32k"),
                ("yi_9b", "decode_32k"))
FIT_BAND = (0.75, 1.25)


def phase_dryrun(smi: str) -> dict:
    """Phase 34 (see the docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import init_distributed, make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import ServeSetup, make_prefill_step
    from repro_torch.train.step import TrainSetup, init_sharded_state, make_train_step
    t_phase = time.perf_counter()
    out = dryrun_cells()

    # (b) the fit against the card: each cell dry-run, then run for real
    fits = {}
    for arch, shape in (("h2o_danube_3_4b", ShapeConfig("train_1x4k", 4096, 1, "train")),
                        ("llama3_8b", ShapeConfig("prefill_1x4k", 4096, 1, "prefill"))):
        rec = dryrun.cell_record(arch, shape, {"data": 1, "model": 1})
        if torch.distributed.is_initialized():
            raise AssertionError("phase 34: a process group outlived the dry-run's cell")
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(81)
        tokens = torch.randint(0, cfg.vocab_size, (1, shape.seq_len + 1), generator=gen,
                               device="cuda")
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        if shape.kind == "train":
            device = torch.device("cuda")
            init_distributed(device)
            try:
                mesh = make_mesh({"data": 1, "model": 1}, device)
                setup = TrainSetup(cfg=cfg.replace(remat="full"))
                params, opt, ef = init_sharded_state(setup, mesh, seed=0, device=device)
                step = make_train_step(setup, mesh, tf.init_lm(setup.cfg, device="meta"))
                batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
                run_step = lambda: step(params, opt, ef, batch)  # noqa: E731
                times = real_fit_steps(run_step)
            finally:
                torch.distributed.destroy_process_group()
        else:
            params = tf.init_lm(cfg, seed=0, device="cuda")
            step = make_prefill_step(ServeSetup(cfg=cfg), (1, 1), params)
            batch = {"tokens": tokens[:, :-1]}
            times = real_fit_steps(lambda: step(params, batch))
        peak = torch.cuda.max_memory_allocated() - base
        del params, step
        torch.cuda.empty_cache()
        fit = rec["memory_analysis"]["peak_size"]
        bound_ms = rec["roofline"]["step_bound"] * 1e3
        ratio = fit / peak
        step_ms = min(times)
        log(f"[dryrun] (b) {arch} {shape.name} on (1, 1): predicted peak {fit / 2**30:.3f} GiB, "
            f"the card's max_memory_allocated {peak / 2**30:.3f} GiB: ratio {ratio:.4f} (band "
            f"{FIT_BAND}); step {step_ms:.1f} ms (fastest of {len(times)}) against the h100 "
            f"roofline's step bound {bound_ms:.2f} ms ({rec['roofline']['bottleneck']}-bound; "
            f"{smi})")
        if not FIT_BAND[0] <= ratio <= FIT_BAND[1] or step_ms < bound_ms:
            raise AssertionError(f"phase 34 (b) {arch}: fit {fit} against {peak}, step "
                                 f"{step_ms} ms against the bound {bound_ms} ms")
        fits[f"{arch} {shape.name}"] = {"predicted_peak_bytes": fit, "card_peak_bytes": peak,
                                        "ratio": ratio, "step_ms": step_ms,
                                        "step_bound_ms": bound_ms}
    out.update(dryrun_fits=fits, dryrun_s=time.perf_counter() - t_phase)
    log(f"[dryrun] phase 34 ok in {out['dryrun_s']:.1f} s")
    return out


def dryrun_cells() -> dict:
    """Phase 34 (a): each of DRYRUN_CELLS on 16x16 and 2x16x16 through the
    dry-run's command line, one process a cell, all at once; every cell
    must exit 0 with status ok.  Returns their records' numbers."""
    t0 = time.perf_counter()
    out = {"dryrun_cells": {}}
    cells_dir = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(cells_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    runs = []
    try:
        for mesh in ("16x16", "2x16x16"):
            for arch, shape in DRYRUN_CELLS:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape, "--out", str(cells_dir)]
                cmd += ["--multi-pod"] if mesh == "2x16x16" else []
                runs.append((mesh, arch, shape, subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        for mesh, arch, shape, proc in runs:
            said, _ = proc.communicate(timeout=300)
            cell = f"{arch}__{shape}__{mesh}__photonic"
            path = cells_dir / f"{cell}.json"
            rec = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
            if proc.returncode != 0 or rec["status"] != "ok":
                raise AssertionError(f"phase 34 (a) {cell}: exit {proc.returncode}, status "
                                     f"{rec['status']}: {said.strip()[-2000:]}")
            r = rec["roofline"]
            log(f"[dryrun] (a) {cell}: {rec['status']} (build {rec['t_build_s']} s, step "
                f"{rec['t_step_s']} s on the CPU); {rec['corrected_flops'] / 1e12:.2f} TFLOP "
                f"a rank, rail bytes {r['rail_bytes'] / 1e9:.3f} GB, scale-up "
                f"{r['scaleup_bytes'] / 1e9:.3f} GB, fit "
                f"{rec['memory_analysis']['peak_size'] / 2**30:.2f} GiB; h100 roofline "
                f"{r['bottleneck']}-bound, step bound {r['step_bound'] * 1e3:.2f} ms")
            out["dryrun_cells"][cell] = {k: rec[k] for k in (
                "status", "corrected_flops", "collectives", "memory_analysis", "roofline")}
    finally:
        for *_, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["dryrun_cells_s"] = time.perf_counter() - t0
    log(f"[dryrun] (a) {len(runs)} cells in {out['dryrun_cells_s']:.1f} s")
    return out


def real_fit_steps(fn, n: int = 3) -> list:
    """ms of each of ``n`` calls of ``fn`` (host clock, synchronized), the
    peak memory counted from the first."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


# The simulator (phase 35): the paper's cost and power comparison at 2,048
# GPUs, the planner's two scale points, a cluster of four 448-GPU jobs and a
# serving fleet of llama-80b replicas over OCS and packet rails, pinned to
# the JAX package's numbers (held to it on the CPU by
# tests/test_torch_sim_rest.py, which runs ``sim_points`` on both packages).
SIM_PINNED = {
    "bill": {"power_ratio": 24.180000000000003, "cost_ratio": 4.266666666666667},
    "headline": {
        "single_job_100k": {"n_gpus": 100000, "engine": "event", "modeled_step_s": 13.650094,
                            "overhead_vs_native": 0.004346, "n_reconfigs": 6,
                            "n_ports_programmed": 112500},
        "week_trace_256": {"n_jobs": 256, "n_done": 256, "n_rejected": 0, "makespan_days": 7.2939,
                           "mean_queueing_delay_s": 927.6953, "max_queueing_delay_s": 7809.1521,
                           "peak_utilization": 1.0, "mean_overhead_vs_native": 0.082435,
                           "n_reconfig_events": 18907520, "n_queued_programs": 79}},
    "cluster": {"n_jobs": 4, "n_done": 4, "total_gpus": 1792, "makespan": 29.596462034713234,
                "mean_overhead_vs_native": 0.09109031156667019,
                "peak_utilization": 0.8888888888888888},
    "fleet": {
        "crossbar_ocs": {"n_requests": 911, "n_completed": 911, "throughput_rps": 15.19008,
                         "p99_ttft_s": 0.884969, "peak_replicas": 19, "peak_gpus": 1216,
                         "network_power_w": 1266.67, "rps_per_net_kw": 11.992168},
        "packet": {"n_requests": 911, "n_completed": 911, "throughput_rps": 15.19008,
                   "p99_ttft_s": 0.872376, "peak_replicas": 19, "peak_gpus": 1216,
                   "network_power_w": 30628.0, "rps_per_net_kw": 0.495954}}}


def sim_points(m) -> dict:
    """Phase 35's numbers from the simulator modules in ``m`` (a namespace
    with ``costmodel``, ``opus_sim``, ``planner``, ``cluster``, ``serving``,
    ``traces``, ``phases`` and ``get_config``); the planner's wall clocks
    left out."""
    eps = m.opus_sim.SimParams(mode="native").fabric_spec()
    ocs = m.opus_sim.SimParams(mode="opus_prov", ocs_latency=0.01).fabric_spec()
    bill = m.costmodel.compare(2048, 8, eps, ocs=ocs)
    head = m.planner.headline_points()
    for point in head.values():
        point.pop("wall_s")
    specs = m.cluster.catalog_jobs(4, 64, mean_gap=2.0)
    cl = m.cluster.simulate_cluster(specs, m.cluster.ClusterParams(n_ports=288,
                                                                   ocs_latency=0.01)).summary()
    job = m.phases.JobConfig(model=m.get_config("llama_80b"), tp=8, fsdp=8, pp=1,
                             global_batch=64, seq_len=4096, n_microbatch=1)
    pre = m.serving.PoolSpec(job, min_replicas=8, max_replicas=16, ref_prompt_tokens=2048)
    dec = m.serving.PoolSpec(job, min_replicas=3, max_replicas=8, batch_slots=16)
    trace = m.traces.TraceParams(duration_s=60.0, base_rate=14.0, diurnal_amp=0.4,
                                 diurnal_period_s=60.0, bursts=((20.0, 10.0, 1.5),), seed=3)
    fleet = {}
    for backend in ("crossbar_ocs", "packet"):
        f = m.serving.simulate_fleet(m.serving.FleetParams(n_ports=2048, backend=backend,
                                                           ocs_latency=0.01),
                                     pre, dec, trace).summary()
        fleet[backend] = {k: f[k] for k in ("n_requests", "n_completed", "throughput_rps",
                                            "p99_ttft_s", "peak_replicas", "peak_gpus",
                                            "network_power_w", "rps_per_net_kw")}
    return {"bill": {k: bill[k] for k in ("power_ratio", "cost_ratio")}, "headline": head,
            "cluster": {k: cl[k] for k in ("n_jobs", "n_done", "total_gpus", "makespan",
                                           "mean_overhead_vs_native", "peak_utilization")},
            "fleet": fleet}


def phase_sim(smi: str) -> dict:
    """Phase 35 (see the docstring)."""
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.core import phases
    from repro_torch.sim import cluster, costmodel, opus_sim, planner, serving, traces
    t_phase = time.perf_counter()
    got = sim_points(SimpleNamespace(costmodel=costmodel, opus_sim=opus_sim, planner=planner,
                                     cluster=cluster, serving=serving, traces=traces,
                                     phases=phases, get_config=get_config))
    bill, ocs, pkt = got["bill"], got["fleet"]["crossbar_ocs"], got["fleet"]["packet"]
    log(f"[sim] 2,048 GPUs, 8-GPU domains, 400G rails: OCS rails draw {bill['power_ratio']:.2f}x "
        f"less power and cost {bill['cost_ratio']:.2f}x less than the packet fabric")
    for name, point in got["headline"].items():
        log(f"[sim] planner {name}: {point}")
    log(f"[sim] cluster of 4 jobs: {got['cluster']}")
    log(f"[sim] fleet: OCS {ocs}; packet {pkt}")
    if not same_numbers(got, SIM_PINNED):
        raise AssertionError(f"phase 35: {got} against the pinned {SIM_PINNED}")
    out = {"sim_points": got, "sim_s": time.perf_counter() - t_phase}
    log(f"[sim] phase 35 ok: every number equal to the JAX package's (pinned), in "
        f"{out['sim_s']:.1f} s")
    return out


def same_numbers(a, b) -> bool:
    """Equal records, floats to 1e-12 relative (another machine's libm)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_numbers(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
    return a == b and type(a) is type(b)


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
    phase_family_kernels(kernels)
    kernels.append({"name": "decode_attention_stats", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                    "replaces": "src/repro/kernels/decode_attention.py:29",
                    "tolerance": "ref.stats_tolerance_ratio: m and l 1e-5 + 1e-4 |plain|, "
                                 "acc / l 1e-5 + 2^-7 |plain| (bf16)"})
    kernels.append(phase_decode_bwd_kernel())  # phase 33 (a)

    cfg = get_config("llama3_8b")
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] llama3-8b {tf.param_count(params) / 1e9:.3f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    pre = phase_prefill(cfg, params)
    dec = phase_decode(cfg, params)
    # phase 28 (b) and (c) on the same weights
    ctx = phase_context_decode(cfg, params)
    rails = phase_rail_shards(cfg, params)
    resident = phase_resident_decode(cfg, params)
    dgrad = phase_decode_grad(cfg, params, "decode grad")  # phase 33 (b)
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

    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] {cfg.name} {tf.param_count(params) / 1e9:.3f} B params bf16 ({cfg.n_layers} "
        f"layers, {cfg.n_heads} heads on {cfg.n_kv_heads} kv head at dh "
        f"{cfg.resolved_head_dim}, GeGLU, tied vocab {cfg.vocab_size}, a prefix of "
        f"{cfg.frontend.n_tokens} patches of {cfg.frontend.d_embed}) in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    vlm_pre = phase_prefill(cfg, params, tag="paligemma prefill", prefix="paligemma_")
    vlm_dec = phase_decode_ab(cfg, params, "paligemma decode")
    vlm_dgrad = phase_decode_grad(cfg, params, "paligemma decode grad")  # phase 33 (b)
    del params
    torch.cuda.empty_cache()

    cfg = get_config(AUDIO_ARCH)
    t0 = time.perf_counter()
    params = tf.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] {cfg.name} {tf.param_count(params) / 1e9:.3f} B params bf16 "
        f"({cfg.encoder.n_layers}-layer encoder over {cfg.frontend.n_tokens} frames of "
        f"{cfg.frontend.d_embed}, {cfg.n_layers}-layer decoder with cross-attention, "
        f"{cfg.n_heads} heads on {cfg.n_kv_heads} kv heads at dh {cfg.resolved_head_dim}) in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    audio_pre = phase_prefill(cfg, params, tag="seamless prefill", prefix="seamless_")
    audio_dec = phase_decode_ab(cfg, params, "seamless decode")
    del params
    torch.cuda.empty_cache()

    from repro_torch.kernels import ops
    serve_archs = ("llama3_8b", "mamba2_370m", MOE_ARCH, GEMMA_ARCH, VLM_ARCH)
    made, collectives, serve_launches = [], {}, {}
    with counted_collectives(collectives), recorded_decode_steps(made):
        for arch in serve_archs:
            ops.reset_launch_counts()
            out = serve.main(["--arch", arch, "--batch", "4", "--prompt-len", "12",
                              "--gen", "20"])
            serve_launches[arch] = {k: n / 32 for k, n in ops.launch_counts().items()}
            if not torch.isfinite(out["logits"]).all():
                raise AssertionError(f"serve entry point, {arch}: logits not finite")
            del out
            torch.cuda.empty_cache()
    log(f"[serve] ok; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    at_one_serve = phase_serve_at_one(serve_archs, made, collectives, serve_launches)

    steps = []
    with recorded_steps(steps):
        tr = phase_train()
        moe_tr = {f"moe_{k}": v for k, v in
                  phase_train(MOE_TRAIN_ARCH, MOE_TRAIN_BATCH, tag="moe train").items()}
        gemma_tr = {f"gemma_{k}": v for k, v in phase_train(
            GEMMA_ARCH, 1, tag="gemma train", n_layers=GEMMA_TRAIN_LAYERS).items()}
        ssm_tr = {f"mamba_{k}": v for k, v in
                  phase_train(SSM_TRAIN_ARCH, 1, tag="mamba train").items()}
        n_patches = get_config(VLM_ARCH).frontend.n_tokens
        vlm_tr = {f"paligemma_{k}": v for k, v in phase_train(
            VLM_ARCH, 1, tag="paligemma train", seq=TRAIN_SEQ - n_patches).items()}
        audio_tr = {f"seamless_{k}": v for k, v in
                    phase_train(AUDIO_ARCH, AUDIO_TRAIN_BATCH, tag="seamless train").items()}
        rest = phase_rest_of_training(tr)
    # phase 27: (a) the training phases above at model size 1; (b) the shares
    # of a model axis of TP_SIZE at full width
    at_one = phase_tp_at_one({
        f"{r[p + 'train_arch']} train{' (remat dots)' if p == 'dots_' else ''}": {
            "launches": r[p + "train_launches_per_step"], "step_ms": r[p + "train_step_ms"]}
        for p, r in (("", tr), ("moe_", moe_tr), ("gemma_", gemma_tr), ("mamba_", ssm_tr),
                     ("paligemma_", vlm_tr), ("seamless_", audio_tr), ("dots_", rest))}, steps)
    tp = {**at_one, **phase_tp_shares(kernels)}
    serve_tp = phase_serve_model_axis(kernels)
    pipe = phase_pipeline()
    calib = phase_calibration()
    plane = phase_plane(smi)
    dry = phase_dryrun(smi)
    sim = phase_sim(smi)
    # each kernel's launches in each path that ran it (counts set to 0 just before the path)
    dense_train, moe_train = f"{tr['train_arch']} train", f"{moe_tr['moe_train_arch']} train"
    gemma_train = f"{gemma_tr['gemma_train_arch']} train ({gemma_tr['gemma_train_depth']})"
    paper_prefill = f"llama-80b prefill ({PAPER_LAYERS} of 96 layers)"
    ssm_train = f"{ssm_tr['mamba_train_arch']} train"
    hybrid_prefill = f"jamba-v0.1-52b prefill ({HYBRID_LAYERS} of 32 layers)"
    hybrid_decode = f"jamba-v0.1-52b decode ({HYBRID_LAYERS} of 32 layers)"
    vlm_train = f"{vlm_tr['paligemma_train_arch']} train"
    audio_train = f"{audio_tr['seamless_train_arch']} train"
    dots_train = f"{tr['train_arch']} train, remat dots"
    hsdp_train = f"{rest['hsdp_arch']} train, HSDP + int8 error feedback (one step)"
    ckpt_train = f"{rest['ckpt_arch']} train through the driver, checkpoint and resume"
    kernels[0]["launches_by_path"] = {
        "llama3-8b prefill": pre["flash_launches"],
        "deepseek-moe-16b prefill": moe_pre["moe_flash_launches"],
        paper_prefill: paper_pre["llama80b_flash_launches"],
        hybrid_prefill: hybrid_pre["jamba_flash_launches"],
        "seamless-m4t-medium prefill": audio_pre["seamless_flash_launches"],
        dense_train: tr["train_launches"]["flash_attention"],
        moe_train: moe_tr["moe_train_launches"]["flash_attention"],
        audio_train: audio_tr["seamless_train_launches"]["flash_attention"],
        dots_train: rest["dots_train_launches"]["flash_attention"],
        hsdp_train: rest["hsdp_launches"]["flash_attention"]}
    kernels[1]["launches_by_path"] = {
        dense_train: tr["train_launches"]["flash_attention_bwd"],
        moe_train: moe_tr["moe_train_launches"]["flash_attention_bwd"],
        audio_train: audio_tr["seamless_train_launches"]["flash_attention_bwd"],
        dots_train: rest["dots_train_launches"]["flash_attention_bwd"],
        hsdp_train: rest["hsdp_launches"]["flash_attention_bwd"]}
    kernels[2]["launches_by_path"] = {
        "llama3-8b decode": dec["decode_launches"],
        "llama3-8b weight-resident decode, one rail rank (phase 31 (a))":
            resident["resident_decode_launches"],
        f"llama3-8b weight-resident decode, {RESIDENT_RAILS} rail ranks in turn (phase 31 (b))":
            resident["resident_rails_decode_launches"],
        "deepseek-moe-16b decode (a)": moe_dec["moe_decode_a_launches"],
        "deepseek-moe-16b decode (b)": moe_dec["moe_decode_b_launches"],
        hybrid_decode + " (a)": hybrid_dec["jamba_decode_a_launches"],
        hybrid_decode + " (b)": hybrid_dec["jamba_decode_b_launches"],
        "seamless-m4t-medium decode (a)": audio_dec["seamless_decode_a_launches"],
        "seamless-m4t-medium decode (b)": audio_dec["seamless_decode_b_launches"]}
    # the 256-wide instantiations: launched by the gemma-7b and paligemma-3b paths
    kernels[0]["dh256"]["launches_by_path"] = {
        "gemma-7b prefill": gemma_pre["gemma_flash_launches"],
        "paligemma-3b prefill": vlm_pre["paligemma_flash_launches"],
        gemma_train: gemma_tr["gemma_train_launches"]["flash_attention"],
        vlm_train: vlm_tr["paligemma_train_launches"]["flash_attention"]}
    kernels[1]["dh256"]["launches_by_path"] = {
        gemma_train: gemma_tr["gemma_train_launches"]["flash_attention_bwd"],
        vlm_train: vlm_tr["paligemma_train_launches"]["flash_attention_bwd"]}
    kernels[2]["dh256"]["launches_by_path"] = {
        "gemma-7b decode (a)": gemma_dec["gemma_decode_a_launches"],
        "gemma-7b decode (b)": gemma_dec["gemma_decode_b_launches"],
        "paligemma-3b decode (a)": vlm_dec["paligemma_decode_a_launches"],
        "paligemma-3b decode (b)": vlm_dec["paligemma_decode_b_launches"]}
    kernels[3]["launches_by_path"] = {"mamba2-370m prefill": mpre["ssd_launches"],
                                      ssm_train: ssm_tr["mamba_train_launches"]["ssd_scan"],
                                      hybrid_prefill: hybrid_pre["jamba_ssd_launches"],
                                      ckpt_train: rest["ckpt_launches"]["ssd_scan"]}
    kernels[4]["launches_by_path"] = {ssm_train: ssm_tr["mamba_train_launches"]["ssd_scan_bwd"],
                                      ckpt_train: rest["ckpt_launches"]["ssd_scan_bwd"]}
    tp_path = f"phase 27 shares of {TP_SIZE} model ranks, four full-width layers"
    for kernel in kernels:
        if tp["tp_launches"][kernel["name"]]:
            kernel["launches_by_path"][tp_path] = tp["tp_launches"][kernel["name"]]
    kernels[4].update(launches=ssm_tr["mamba_train_launches"]["ssd_scan_bwd"],
                      launches_per_step=ssm_tr["mamba_train_launches_per_step"]["ssd_scan_bwd"])
    kernels[1].update(launches=tr["train_launches"]["flash_attention_bwd"],
                      launches_per_step=tr["train_launches_per_step"]["flash_attention_bwd"])
    ctx_path = f"llama3-8b context-sharded decode, {CTX_CAP} slots"
    kernels[5].update(launches=ctx["ctx_stats_launches"],
                      launches_per_step=ctx["ctx_stats_launches"] / ctx["ctx_steps"],
                      launches_by_path={ctx_path: ctx["ctx_stats_launches"]})
    kernels[2]["launches_by_path"][f"phase 28 (d) shares of {TP_SIZE} model ranks"] = sum(
        r["launches"]["decode_attention"] for r in serve_tp["serve_tp_layers"].values())
    pipe_path = (f"{pipe['pipe_arch']} pipeline, {PIPE_MICRO} microbatches of 1 x {PIPE_SEQ}, "
                 f"{TRAIN_STEPS} steps (phase 29 (a))")
    for kernel in kernels:
        for path, counts in ((pipe_path, pipe["pipe_launches"]),
                             ("calibration suite (phase 30)", calib["calib_launches"])):
            if counts[kernel["name"]]:
                kernel["launches_by_path"][path] = counts[kernel["name"]]
    grad_path = f"a decode step differentiated ({DECODE_GRAD_LAYERS} layers, phase 33 (b))"
    kernels[6].update(launches=dgrad["decode grad_launches"], launches_by_path={
        f"llama3-8b {grad_path}": dgrad["decode grad_launches"],
        f"paligemma-3b {grad_path}": vlm_dgrad["paligemma decode grad_launches"]})
    kernels[6]["paligemma"]["launches"] = vlm_dgrad["paligemma decode grad_launches"]
    # the differentiated steps' forward launches (one a layer, as the backward's)
    kernels[2]["launches_by_path"][f"llama3-8b {grad_path}"] = dgrad["decode grad_launches"]
    kernels[2]["dh256"]["launches_by_path"][f"paligemma-3b {grad_path}"] = \
        vlm_dgrad["paligemma decode grad_launches"]
    log(f"[train] ok; whole run {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels, **pre, **dec, **mpre, **mdec, **moe_pre, **moe_dec,
                    **gemma_pre, **gemma_dec, **paper_pre, **hybrid_pre, **hybrid_dec,
                    **vlm_pre, **vlm_dec, **audio_pre, **audio_dec, **tr, **moe_tr, **gemma_tr,
                    **ssm_tr, **vlm_tr, **audio_tr, **rest, **tp, **at_one_serve, **ctx,
                    **rails, **serve_tp, **pipe, **calib, **resident, **plane, **dgrad,
                    **vlm_dgrad, **dry, **sim, "card": smi},
                   default=str))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
