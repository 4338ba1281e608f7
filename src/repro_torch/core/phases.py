"""Parallelism phases: Table-1 traffic model, Fig-3 schedule generation,
phase tables, Eq-5 window counts.

A *phase* is a contiguous interval during which all scale-out communication
belongs to one parallelism dimension (paper §4.1).  The schedule generator
reproduces Fig 3: a 1F1B pipeline over PP ways where each way's forward
runs per-layer FSDP AllGathers (overlapped with compute), PP Send/Recv
crosses ways at microbatch boundaries, backward emits per-layer
ReduceScatters (+ re-gather AllGathers), and the optimizer step issues
short synchronization AllReduces (<1 MB class, Fig 4b).

Symmetric dims get digit ids 1..9 in topo_id order (DP/FSDP=1, CP=2, EP=3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig

# digit assignment for symmetric dims (paper Fig 8: PP=0, then 1,2,...)
SYM_DIGITS = {"fsdp": 1, "dp": 1, "cp": 2, "ep": 3}

BYTES = {"bfloat16": 2, "float32": 4}


@dataclass(frozen=True)
class JobConfig:
    """A training job's parallelism placement (paper Table 2 style)."""

    model: ModelConfig
    tp: int = 1
    fsdp: int = 1           # FSDP/DP degree (scale-out)
    pp: int = 1
    cp: int = 1
    ep: int = 1
    global_batch: int = 16
    seq_len: int = 8192
    n_microbatch: Optional[int] = None  # default: = pp (paper Table 2)
    zero3: bool = True      # FSDP (AG/RS) vs plain DP (bwd AR only)

    @property
    def microbatches(self) -> int:
        return self.n_microbatch if self.n_microbatch else self.pp

    @property
    def n_gpus(self) -> int:
        return self.tp * self.fsdp * self.pp * self.cp * self.ep

    @property
    def layers_per_stage(self) -> int:
        return max(1, self.model.n_layers // self.pp)


@dataclass(frozen=True)
class CommOp:
    """One communication operation as seen by the shim (paper §4.1)."""

    uid: int
    dim: str                # "fsdp" | "dp" | "pp" | "cp" | "ep" | "tp" | "mgmt"
    kind: str               # all_gather | reduce_scatter | all_reduce | send_recv | all_to_all
    way: int                # pipeline stage (asym way); -1 = all ways
    microbatch: int
    bytes_per_gpu: float
    scale: str              # "scale_out" | "scale_up" | "mgmt"
    compute_before: float = 0.0  # seconds of compute between prev op and this
    # circuit-round matching this op runs on (DESIGN.md §13): 0 = the
    # canonical shift-1 ring (every op before per-collective scheduling);
    # v>0 = shift-v round of a round-robin all-to-all; v<0 = XOR round of
    # recursive halving/doubling at distance -v
    variant: int = 0


# ---------------------------------------------------------------------------
# Table 1 traffic volumes (per GPU, per occurrence)
# ---------------------------------------------------------------------------


def param_bytes(model: ModelConfig, dtype_bytes: int = 2) -> float:
    """Approximate parameter bytes (dense path; MoE adds expert weights)."""
    d, f, v, L = model.d_model, model.d_ff, model.vocab_size, model.n_layers
    dh = model.resolved_head_dim if model.n_heads else 0
    attn = d * dh * (model.n_heads + 2 * model.n_kv_heads) + \
        model.n_heads * dh * d
    mlp = 3 * d * f
    if model.moe:
        de = model.moe.d_expert or f
        mlp = model.moe.n_experts * 3 * d * de / 1.0 + \
            model.moe.n_shared_experts * 3 * d * de
        mlp = mlp / model.moe.moe_every + (3 * d * f if model.moe.moe_every > 1 else 0)
    emb = v * d * (1 if model.tie_embeddings else 2)
    return float((L * (attn + mlp) + emb) * dtype_bytes)


def layer_param_bytes(job: JobConfig) -> float:
    return param_bytes(job.model) / max(job.model.n_layers, 1)


def fsdp_ag_bytes(job: JobConfig) -> float:
    """Per-layer forward AllGather, bytes received per GPU (ring)."""
    lp = layer_param_bytes(job) / (job.tp)          # TP-sharded already
    return lp * (job.fsdp - 1) / job.fsdp


def fsdp_rs_bytes(job: JobConfig) -> float:
    """Per-layer backward ReduceScatter (grads in f32 -> 2x param bytes)."""
    return 2.0 * fsdp_ag_bytes(job)


def dp_ar_bytes(job: JobConfig) -> float:
    """Plain-DP per-model gradient AllReduce (2(n-1)/n * grad bytes)."""
    gb = 2.0 * param_bytes(job.model) / (job.tp * job.pp)
    return gb * 2.0 * (job.fsdp - 1) / job.fsdp


def pp_send_bytes(job: JobConfig) -> float:
    """Activation Send/Recv per microbatch boundary."""
    mb_tokens = job.global_batch // job.fsdp // job.microbatches * job.seq_len
    return float(mb_tokens * job.model.d_model * 2 / job.tp)


def mgmt_ar_bytes(job: JobConfig) -> float:
    """Optimizer-step synchronization AllReduce (<1 MB class, Fig 4b)."""
    return 64e3


def ep_a2a_bytes(job: JobConfig) -> float:
    """Per-layer EP all-to-all (MoE dispatch or combine), DIRECT bytes
    received per GPU: each GPU exchanges its top_k-routed activations
    with the other ep-1 experts' hosts ((ep-1)/ep of the routed bytes
    leave the GPU).  This is the packet-fabric cost; a circuit fabric
    pays the scheduler-dependent execution cost on top (ring forwarding
    multiplies it by ep, per-collective rounds keep it direct —
    repro_torch.core.scheduler)."""
    moe = job.model.moe
    assert moe is not None and job.ep > 1, (job.model.name, job.ep)
    mb_tokens = job.global_batch // job.fsdp // job.microbatches * job.seq_len
    act = mb_tokens * job.model.d_model * BYTES["bfloat16"] / job.tp
    return float(act * moe.top_k * (job.ep - 1) / job.ep)


# ---------------------------------------------------------------------------
# Fig-3 schedule generation (1F1B)
# ---------------------------------------------------------------------------


def one_f_one_b(pp: int, m: int) -> List[List[Tuple[int, str, int]]]:
    """Dependency-exact 1F1B schedule, grouped by tick.

    Returns ticks; each tick is [(way, "fwd"/"bwd", microbatch), ...].
    Rules: fwd(s,m) needs fwd(s-1,m); bwd(s,m) needs bwd(s+1,m) and
    fwd(s,m); each stage runs one op per tick, preferring bwd once its
    warm-up (pp - s in-flight forwards) is filled (1F1B).
    """
    fwd_done = [[False] * m for _ in range(pp)]
    bwd_done = [[False] * m for _ in range(pp)]
    next_fwd = [0] * pp
    next_bwd = [0] * pp
    ticks: List[List[Tuple[int, str, int]]] = []
    total = 2 * pp * m
    done = 0
    while done < total:
        tick: List[Tuple[int, str, int]] = []
        for s in range(pp):
            can_fwd = (next_fwd[s] < m
                       and (s == 0 or fwd_done[s - 1][next_fwd[s]]))
            can_bwd = (next_bwd[s] < m and fwd_done[s][next_bwd[s]]
                       and (s == pp - 1 or bwd_done[s + 1][next_bwd[s]]))
            inflight = next_fwd[s] - next_bwd[s]
            prefer_bwd = can_bwd and (inflight >= min(pp - s, m)
                                      or next_fwd[s] >= m)
            if prefer_bwd:
                tick.append((s, "bwd", next_bwd[s]))
            elif can_fwd:
                tick.append((s, "fwd", next_fwd[s]))
            elif can_bwd:
                tick.append((s, "bwd", next_bwd[s]))
        for s, k, mb in tick:  # commit after scheduling the whole tick
            if k == "fwd":
                fwd_done[s][mb] = True
                next_fwd[s] += 1
            else:
                bwd_done[s][mb] = True
                next_bwd[s] += 1
            done += 1
        assert tick, "1F1B deadlock"
        ticks.append(tick)
    return ticks


def iteration_schedule(job: JobConfig, *, t_fwd_layer: float = 0.0,
                       t_bwd_layer: float = 0.0) -> List[CommOp]:
    """Scale-out CommOp sequence of one training iteration (Fig 3).

    Per tick, rail traffic is emitted in dependency order:
      [PP grad-sends feeding this tick's backwards]  -> asym phase
      [per-layer FSDP AG/RS of this tick's fwd/bwd]  -> sym phase
      [PP activation sends of this tick's forwards]  -> asym phase
    Adjacent PP sub-phases across tick boundaries merge (same dim), which
    is what produces the paper's 6 reconfigurations/step for Table-2
    Configs 1-2 (PP=2, M=2).
    compute_before carries the compute time preceding each op.
    """
    ops: List[CommOp] = []
    uid = 0
    L = job.layers_per_stage
    m = job.microbatches

    def emit(dim, kind, way, mb, nbytes, compute):
        nonlocal uid
        scale = "scale_out"
        if dim == "tp":
            scale = "scale_up"
        if dim == "mgmt":
            scale = "mgmt"
        ops.append(CommOp(uid, dim, kind, way, mb, nbytes, scale, compute))
        uid += 1

    for tick in one_f_one_b(job.pp, m):
        fwds = [(s, mb) for s, k, mb in tick if k == "fwd"]
        bwds = [(s, mb) for s, k, mb in tick if k == "bwd"]
        # (1) Send/Recv feeding this tick's consumers: the transfer
        # completes right before the consumer starts (dependency order),
        # so adjacent sends of the same tick batch into ONE asym phase —
        # this is what yields 6 reconfigs/step for Table-2 Configs 1-2.
        # the producing stage finishes its last layer's compute AFTER its
        # last per-layer collective: that trailing compute is the idle
        # window (§3.2) in which provisioning hides the reconfiguration.
        # When no per-layer FSDP collectives exist (plain DP / fsdp=1) the
        # whole stage's compute rides on the Send/Recv instead.
        overlapped = job.zero3 and job.fsdp > 1
        c_fwd = t_fwd_layer if overlapped else t_fwd_layer * L
        c_bwd = t_bwd_layer if overlapped else t_bwd_layer * L
        for i, (s, mb) in enumerate(bwds):  # grad enables bwd(s, mb)
            if job.pp > 1 and s < job.pp - 1:
                emit("pp", "send_recv", s, mb, pp_send_bytes(job),
                     c_bwd if i == 0 else 0.0)
        for i, (s, mb) in enumerate(fwds):  # activation enables fwd(s, mb)
            if job.pp > 1 and s > 0:
                emit("pp", "send_recv", s - 1, mb, pp_send_bytes(job),
                     c_fwd if (i == 0 and not bwds) else 0.0)
        # (2) symmetric traffic of this tick's compute.  An EP-sharded
        # MoE layer (job.ep > 1) exchanges its routed activations over
        # the rails twice per MoE layer (dispatch + combine), interleaved
        # with the layer's FSDP collectives — the fsdp<->ep digit
        # alternation per-collective scheduling (§13) feeds on.
        moe = job.model.moe
        moe_every = moe.moe_every if (job.ep > 1 and moe is not None) else 0
        for s, mb in fwds:
            if job.cp > 1:
                emit("cp", "all_gather", s, mb,
                     pp_send_bytes(job) * job.cp, 0.0)
            for layer in range(L):
                if job.zero3 and job.fsdp > 1:
                    # per-layer AG overlapped with compute
                    emit("fsdp", "all_gather", s, mb, fsdp_ag_bytes(job),
                         t_fwd_layer)
                if moe_every and layer % moe_every == 0:
                    emit("ep", "all_to_all", s, mb, ep_a2a_bytes(job), 0.0)
                    emit("ep", "all_to_all", s, mb, ep_a2a_bytes(job), 0.0)
        for s, mb in bwds:
            for layer in range(L):
                if job.zero3 and job.fsdp > 1:
                    # re-gather + reduce-scatter per layer
                    emit("fsdp", "all_gather", s, mb, fsdp_ag_bytes(job),
                         t_bwd_layer / 2)
                    emit("fsdp", "reduce_scatter", s, mb,
                         fsdp_rs_bytes(job), t_bwd_layer / 2)
                if moe_every and layer % moe_every == 0:
                    # gradients of combine + dispatch retrace the rails
                    emit("ep", "all_to_all", s, mb, ep_a2a_bytes(job), 0.0)
                    emit("ep", "all_to_all", s, mb, ep_a2a_bytes(job), 0.0)
            if not job.zero3 and job.fsdp > 1 and mb == m - 1:
                emit("dp", "all_reduce", s, mb, dp_ar_bytes(job),
                     t_bwd_layer * L)
    # optimizer step: short sync ARs (mgmt-class but rail-visible, Fig 4b);
    # a PP-only job (fsdp == 1) has no scale-out sync group at all
    if job.fsdp > 1:
        for _ in range(2):
            emit("dp" if not job.zero3 else "fsdp", "all_reduce", -1, m - 1,
                 mgmt_ar_bytes(job), 0.0)
    return ops


# ---------------------------------------------------------------------------
# serving-step schedules (DESIGN.md §11; shapes from repro_torch/serve/step.py)
# ---------------------------------------------------------------------------

SERVE_KINDS = ("prefill", "decode")

# weight-resident decode reduces activation partials once per projection
# (qkv / attn-out / ffn-up / ffn-down) — see serve.step._make_resident_...
DECODE_PROJECTIONS = 4


def decode_ar_bytes(job: JobConfig, batch_slots: int) -> float:
    """Per-layer rail bytes of one weight-resident decode step: one
    [B, 1, d_model] ring AllReduce per projection (2(n-1)/n factor),
    batched into a single per-layer op (same total bytes, fewer events).
    """
    act = batch_slots * job.model.d_model * BYTES["bfloat16"]
    ring = 2.0 * (job.fsdp - 1) / job.fsdp
    return float(DECODE_PROJECTIONS * act * ring)


def serving_schedule(job: JobConfig, kind: str, *, batch_slots: int = 1,
                     t_layer: float = 0.0) -> List[CommOp]:
    """Rail CommOp stream of ONE serving step (prefill or decode).

    prefill  forward-only Fig-3 row: one per-layer FSDP parameter
             AllGather per layer, overlapped with that layer's forward
             compute — the same bytes and phase structure the training
             forward schedules (serve.step.make_prefill_step).  A single
             symmetric phase, so the steady state needs ZERO
             reconfigurations: the ring is programmed at registration and
             never moves.
    decode   weight-resident resident decode (serve.step.
             _make_resident_decode_step): params stay rail-sharded; each
             layer reduces activation-sized partial sums over the rails.
             Also one static ring — zero reconfigurations by construction
             (the property that lets serving share rails with training).

    A TP-only replica (``fsdp == 1``) is rail-silent: its stream carries
    the per-layer compute on zero-byte scale-up markers (TP traffic is
    intra-domain), so the event engine still measures a step time while
    programming nothing on the rails.
    """
    assert kind in SERVE_KINDS, kind
    assert job.pp == 1 and job.cp == 1 and job.ep == 1, \
        "serving replicas are TP x FSDP meshes (serve/step.py)"
    ops: List[CommOp] = []
    if job.fsdp <= 1:
        for layer in range(job.model.n_layers):
            ops.append(CommOp(layer, "tp", "all_reduce", 0, 0, 0.0,
                              "scale_up", t_layer))
        return ops
    for layer in range(job.model.n_layers):
        if kind == "prefill":
            ops.append(CommOp(layer, "fsdp", "all_gather", 0, 0,
                              fsdp_ag_bytes(job), "scale_out", t_layer))
        else:
            ops.append(CommOp(layer, "fsdp", "all_reduce", 0, 0,
                              decode_ar_bytes(job, batch_slots),
                              "scale_out", t_layer))
    return ops


# ---------------------------------------------------------------------------
# phase table (paper §4.2 "Profiling Parallelism Phases")
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Phase:
    """A maximal run of scale-out ops sharing one circuit requirement.

    With per-collective scheduling a "phase" is one *collective round*
    — the (dim, variant) pair names the matching the rails must hold —
    and classic phase-boundary scheduling is the degenerate case where
    every op carries variant 0 and runs merge purely by dim.
    """

    dim: str
    start_idx: int          # first op uid of the phase
    end_idx: int            # last op uid (inclusive)
    ways: Tuple[int, ...]
    variant: int = 0        # circuit-round matching (see CommOp.variant)


def build_phase_table(ops: Iterable[CommOp]) -> List[Phase]:
    """Group maximal runs of same-(dim, variant) scale-out ops into
    phases (collective rounds, DESIGN.md §13).

    Back-to-back PP Send/Recvs (same tick) form one phase — there is no
    idle window between them; the shim still issues per-op topo_writes for
    asymmetric ops (§4.2), which the controller suppresses when digits are
    unchanged.  A variant change within one dim (consecutive circuit
    rounds of a decomposed collective) starts a NEW phase: each round is
    a real reconfiguration boundary.
    """
    table: List[Phase] = []
    cur: Optional[List[CommOp]] = None
    for op in ops:
        if op.scale != "scale_out":
            continue
        if cur and cur[0].dim == op.dim and cur[0].variant == op.variant:
            cur.append(op)
        else:
            if cur:
                table.append(_mk_phase(cur))
            cur = [op]
    if cur:
        table.append(_mk_phase(cur))
    return table


def _mk_phase(ops: List[CommOp]) -> Phase:
    return Phase(ops[0].dim, ops[0].uid, ops[-1].uid,
                 tuple(sorted({o.way for o in ops})), ops[0].variant)


def count_windows(ops: Iterable[CommOp]) -> int:
    """Number of inter-phase windows in one iteration (Fig 5 quantity)."""
    return max(0, len(build_phase_table(list(ops))) - 1)


def phase_index_of(ops: Iterable[CommOp],
                   table: Optional[List[Phase]] = None) -> np.ndarray:
    """uid -> phase-index vector for ``ops`` (-1 for non-scale-out uids).

    Array-backed (op uids are dense from 0): an int64 numpy vector filled
    with one slice-assignment per phase and shared by every phase-aware
    driver — both simulator engines index it instead of each rebuilding a
    per-uid dict, and the vectorized engine uses it directly as the class
    key for its batched per-phase walks.
    """
    ops = list(ops)
    if table is None:
        table = build_phase_table(ops)
    n = (max(o.uid for o in ops) + 1) if ops else 0
    arr = np.full(n, -1, dtype=np.int64)
    for pi, p in enumerate(table):
        arr[p.start_idx:p.end_idx + 1] = pi
    return arr


def phase_digits(phase: Phase, digits: List[int], n_ways: int) -> List[int]:
    """Topo digits required by a phase, given the current digits."""
    nd = list(digits)
    if phase.dim == "pp":
        for w in phase.ways:
            for x in (w, w + 1):
                if 0 <= x < n_ways:
                    nd[x] = 0
    else:
        ways = range(n_ways) if -1 in phase.ways else phase.ways
        for x in ways:
            if 0 <= x < n_ways:
                nd[x] = SYM_DIGITS.get(phase.dim, 1)
    return nd


def count_reconfigs(ops: Iterable[CommOp], n_ways: int) -> int:
    """Reconfiguration events per steady-state iteration (cyclic).

    The topology persists across iterations, so the initial digits are the
    LAST phase's requirement and the wrap-around transition counts.  A
    single-dimension job (paper Config 3) therefore requires ZERO in-job
    reconfigurations; the testbed's PP/DP alternation counts 4 (Fig 9).
    """
    table = build_phase_table(list(ops))
    if not table:
        return 0

    def step(state, p):
        digits, variants = state
        nd = phase_digits(p, digits, n_ways)
        nv = list(variants)
        if p.dim != "pp":        # circuit-round matching of the sym ways
            ways = range(n_ways) if -1 in p.ways else p.ways
            for x in ways:
                if 0 <= x < n_ways:
                    nv[x] = p.variant
        return nd, nv

    # two passes: first to find the steady-state end state, then count
    state = ([1] * n_ways, [0] * n_ways)
    for p in table:
        state = step(state, p)
    n = 0
    for p in table:
        ns = step(state, p)
        if ns != state:
            n += 1
        state = ns
    return n


def eq5_window_count(n_layer: int, n_microbatch: int, pp: int,
                     zero3: bool = True) -> int:
    """Closed-form window count (paper Eq. 5 / Fig 5), validated against
    the generated schedule in tests.

    FSDP x PP (1F1B): each microbatch's forward contributes an
    (AG-phase -> PP) boundary pair and each backward a (PP -> AG/RS-phase)
    pair; warm-up/cool-down asymmetry removes one boundary; the optimizer
    sync ARs merge into the trailing phase.
    """
    if pp <= 1:
        return 1 if zero3 else 0
    per_mb = 4 if zero3 else 2
    return per_mb * n_microbatch - 1
