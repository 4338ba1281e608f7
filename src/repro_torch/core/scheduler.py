"""Circuit schedulers: the granularity axis of the control plane
(DESIGN.md §13).

A :class:`CircuitScheduler` decides WHAT the rails are asked to hold
while one iteration's collectives execute, by rewriting the iteration's
:class:`~repro_torch.core.phases.CommOp` stream before the plane profiles it.
It is an API axis exactly parallel to the switch-backend axis (§10):
``FabricSpec(scheduler=...)`` names one, every sim surface threads it,
and all downstream machinery — phase tables, shims, barriers, the
replay cache, both event engines, fault demotion — runs unchanged over
whatever stream the scheduler produces.

Two implementations:

``phase_boundary`` (default)
    The paper's scheduling: one circuit per parallelism phase, rings
    only, reconfiguration at phase boundaries.  On a circuit fabric an
    EP all-to-all must EXECUTE on the ring the phase wired — n-1
    forwarding hops each carrying the whole routed buffer
    (``fabric.ring_all_to_all``) — so its direct bytes are taxed by
    the group size.  A stream with no all-to-all is returned as the
    SAME list object: the default path is bit-identical to the
    pre-scheduler plane by construction.

``per_collective``
    PCCL-style scheduling: the fabric is reprogrammed *per collective
    round*, not per phase.  An EP all-to-all of group size k becomes
    k-1 shift-variant rounds (round r wires port i -> port (i+r) mod k;
    every payload travels ONE hop, so the rounds carry the direct bytes
    split evenly).  AllGather/ReduceScatter decompose into ring rounds
    (variant 0, equal split) or — ``collective_rounds="halving"`` —
    log2(k) XOR-matching rounds with the recursive doubling/halving
    byte ladder.  Each round is a real op: the shim issues a real
    topo_write per round boundary, the OCS busy-clock charges every
    reprogram, and a mid-round fault demotes the job to the giant ring
    like any other dispatch.  Whether the extra reconfigurations pay
    for the removed forwarding tax is exactly the headline trade
    (``benchmarks/run.py --scheduler-ab``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Protocol, Sequence, runtime_checkable

from repro_torch.core.phases import CommOp, JobConfig

PHASE_BOUNDARY = "phase_boundary"
PER_COLLECTIVE = "per_collective"


@runtime_checkable
class CircuitScheduler(Protocol):
    """Rewrites one iteration's op stream into the stream the control
    plane actually drives (uids dense from 0, order preserved)."""

    name: str

    def schedule(self, ops: Sequence[CommOp], job: JobConfig, *,
                 circuit: bool) -> List[CommOp]:
        """``circuit`` is whether the fabric executes collectives on
        physical circuits (OCS/patch panel) rather than packet routes —
        the execution tax and round decomposition only exist there."""
        ...


def _renumber(ops: Sequence[CommOp]) -> List[CommOp]:
    """Dense uids 0..n-1 in stream order (phase tables, shim tables and
    the engines' per-op metadata all key on dense uids)."""
    return [op if op.uid == i else replace(op, uid=i)
            for i, op in enumerate(ops)]


def _group_size(op: CommOp, job: JobConfig) -> int:
    return {"fsdp": job.fsdp, "dp": job.fsdp, "cp": job.cp,
            "ep": job.ep}.get(op.dim, 1)


@dataclass(frozen=True)
class PhaseBoundaryScheduler:
    """Today's behaviour, made explicit.

    Identity on the op stream — except that on a circuit fabric an
    all-to-all op's bytes are multiplied by its group size k: the ring
    the phase wired forwards each payload k-1 hops and every hop
    carries the whole per-GPU routed buffer, so direct bytes D become
    D * k on the wire (``ring_all_to_all``'s cost, DESIGN.md §7).
    Packet fabrics route all-to-all directly and pay D unchanged.
    """

    name: str = PHASE_BOUNDARY

    def schedule(self, ops: Sequence[CommOp], job: JobConfig, *,
                 circuit: bool) -> List[CommOp]:
        if not circuit or not any(
                o.kind == "all_to_all" and o.scale == "scale_out"
                for o in ops):
            return list(ops) if not isinstance(ops, list) else ops
        return [replace(o, bytes_per_gpu=o.bytes_per_gpu
                        * _group_size(o, job))
                if o.kind == "all_to_all" and o.scale == "scale_out"
                else o
                for o in ops]


@dataclass(frozen=True)
class PerCollectiveScheduler:
    """Per-collective circuit rounds (PCCL mode).

    collective_rounds
        ``"ring"``      AG/RS stay on the shift-1 ring, split into k-1
                        equal-byte rounds (adjacent variant-0 rounds
                        merge back into one phase — the ring already
                        serves every round without moving, so only the
                        op granularity changes, not the reconfig count).
        ``"halving"``   AG/RS become log2(k) XOR-matching rounds
                        (variant -d pairs port i with i^d): recursive
                        doubling for AG (d = 1, 2, ..., k/2), recursive
                        halving for RS (d = k/2, ..., 1), bytes
                        emitted * d / (k-1) per round — each a real
                        reconfiguration.  Non-power-of-two groups fall
                        back to ring rounds.
    min_bytes
        Collectives below this size pass through undecomposed: a
        reconfiguration per round of a 64 KB sync AllReduce would cost
        orders of magnitude more than it saves, and no real PCCL
        deployment would schedule one.
    """

    name: str = PER_COLLECTIVE
    collective_rounds: str = "ring"
    min_bytes: float = 1 << 20

    def __post_init__(self):
        assert self.collective_rounds in ("ring", "halving"), \
            self.collective_rounds

    def schedule(self, ops: Sequence[CommOp], job: JobConfig, *,
                 circuit: bool) -> List[CommOp]:
        assert circuit, \
            "per_collective scheduling programs circuits; a packet " \
            "fabric has nothing to schedule (FabricSpec validates this)"
        out: List[CommOp] = []
        for op in ops:
            out.extend(self._rounds(op, job))
        return _renumber(out)

    # -- per-op decomposition ------------------------------------------------
    def _rounds(self, op: CommOp, job: JobConfig) -> List[CommOp]:
        k = _group_size(op, job)
        if (op.scale != "scale_out" or k <= 1
                or op.bytes_per_gpu < self.min_bytes
                or op.kind == "send_recv"):
            # undecomposed — but an all-to-all left on the phase ring
            # still EXECUTES there and pays the §7 forwarding tax, same
            # as under phase_boundary scheduling
            if (op.kind == "all_to_all" and op.scale == "scale_out"
                    and k > 1):
                return [replace(op, bytes_per_gpu=op.bytes_per_gpu * k)]
            return [op]
        if op.kind == "all_to_all":
            return self._a2a_rounds(op, k)
        if op.kind in ("all_gather", "reduce_scatter"):
            return self._ag_rs_rounds(op, k)
        if op.kind == "all_reduce":
            # RS + AG composition: the emitted AR bytes are already the
            # ring total of both halves, so each half carries half
            rs = replace(op, kind="reduce_scatter",
                         bytes_per_gpu=op.bytes_per_gpu / 2)
            ag = replace(op, kind="all_gather",
                         bytes_per_gpu=op.bytes_per_gpu / 2,
                         compute_before=0.0)
            return self._ag_rs_rounds(rs, k) + self._ag_rs_rounds(ag, k)
        return [op]

    def _a2a_rounds(self, op: CommOp, k: int) -> List[CommOp]:
        """k-1 shift rounds; round r wires every port to its r-th
        successor, so the slice destined r hops away travels ONE hop.
        Direct bytes split evenly — the ring forwarding tax is gone."""
        per_round = op.bytes_per_gpu / (k - 1)
        return [replace(op, variant=r, bytes_per_gpu=per_round,
                        compute_before=op.compute_before if r == 1 else 0.0)
                for r in range(1, k)]

    def _ag_rs_rounds(self, op: CommOp, k: int) -> List[CommOp]:
        if self.collective_rounds == "halving" and k & (k - 1) == 0:
            dists = [1 << j for j in range((k - 1).bit_length())]
            if op.kind == "reduce_scatter":
                dists.reverse()
            return [replace(op, variant=-d,
                            bytes_per_gpu=op.bytes_per_gpu * d / (k - 1),
                            compute_before=op.compute_before if i == 0
                            else 0.0)
                    for i, d in enumerate(dists)]
        per_round = op.bytes_per_gpu / (k - 1)
        return [replace(op, bytes_per_gpu=per_round,
                        compute_before=op.compute_before if r == 0 else 0.0)
                for r in range(k - 1)]


SCHEDULERS: Dict[str, CircuitScheduler] = {
    PHASE_BOUNDARY: PhaseBoundaryScheduler(),
    PER_COLLECTIVE: PerCollectiveScheduler(),
}


def get_scheduler(name: str) -> CircuitScheduler:
    try:
        return SCHEDULERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; one of {sorted(SCHEDULERS)}"
        ) from None
