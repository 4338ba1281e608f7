"""Serving-fleet simulator: disaggregated prefill/decode pools on the
shared photonic rails (DESIGN.md §11).

The cluster simulator (§9) answers "what do shared rails cost N training
tenants?"; this module asks the ROADMAP's serving question: can the same
time-multiplexed circuits carry an inference fleet — millions of user
requests through pools of model replicas — and what does that fleet cost
in requests/s-per-watt against an electrical packet fabric?  The pieces:

* **Replica pools.**  Disaggregated prefill and resident-decode pools
  (the serve/step.py split): a prefill replica runs forward-only
  per-layer FSDP parameter AllGathers; a decode replica keeps weights
  rail-resident and reduces activation partials on one static ring.
  Every replica is a REAL ``ControlPlane(collapse=True)`` registered on
  shared ``RailOrchestrator``s with a ``PortAllocator`` grant — the
  exact §9 machinery — and its step time is MEASURED by replaying its
  serving workload through the event engine on those rails (the serving
  engine is a strict superset of ``simulate(engine="event")``, asserted
  bit-exact in tests/test_serving.py).

* **Request traces.**  Deterministic diurnal + bursty arrivals with
  per-request token lengths (:mod:`repro_torch.sim.traces`): every derived
  number lands in a committed BENCH record, so no platform RNG anywhere.

* **Queueing.**  A global prefill FIFO, per-replica decode slots, and
  per-request TTFT (arrival -> first token) / TPOT (per-token decode
  step) / goodput (completions within the TTFT SLO).

* **KV-cache migration as a first-class rail workload.**  A finished
  prefill's KV moves to its decode replica over the rails.  On a
  circuit fabric that is a reconfiguration PHASE: handoffs batch on a
  flush cadence, one ``RailOrchestrator.migrate`` program wires all
  (prefill port -> decode port) circuits, transfers stream over them,
  and one ``restore`` program reinstates the borrowed prefill rings —
  both programs contend on the shared switch clock with every other
  tenant's reconfigurations (per-request reconfiguration would saturate
  a 10 ms OCS; the flush interval is the knob that trades TTFT against
  switch pressure).  A packet fabric routes handoffs immediately with no
  programs — that difference IS the serving-latency overhead headline.
  Replica drains migrate resident KV off the victim the same way.

* **Autoscaling.**  A deterministic controller sizes both pools every
  ``scale_interval_s``: scale-ups allocate ports and register planes
  mid-trace (warmup = spin-up), scale-downs drain and release — port
  churn through the allocator with utilization/fragmentation sampled at
  every transition, exactly where the hardware couples.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import phases as ph
from repro_torch.core.fabric import FabricSpec, OCSArray
from repro_torch.core.orchestrator import PortAllocator, RailOrchestrator
from repro_torch.core.plane import ControlPlane
from repro_torch.sim.opus_sim import SHIM_MODE, SimParams, SimResult, VectorEngine
from repro_torch.sim.traces import Request, TraceParams, make_trace
from repro_torch.sim.workload import GPUS, build_serving


def kv_bytes_per_token(model) -> float:
    """KV-cache bytes per token across the whole replica (bf16 K+V per
    layer; attention-free archs carry no per-token KV at all)."""
    dh = model.resolved_head_dim if model.n_heads else 0
    return float(model.n_layers * 2 * model.n_kv_heads * dh * 2)


@dataclass(frozen=True)
class PoolSpec:
    """One replica pool: the replica's mesh plus autoscaler bounds."""

    job: ph.JobConfig             # TP x FSDP serving mesh (pp=cp=ep=1)
    min_replicas: int = 1
    max_replicas: int = 1
    batch_slots: int = 16         # resident decode slots per replica
    ref_prompt_tokens: int = 2048  # prefill measurement reference length
    # Serving steps are SINGLE-phase (one dim, one ring): the ring is
    # programmed once at registration and the steady state issues zero
    # topo writes, so static shims ("oneshot") are the physically honest
    # default — the rails' programmability is exercised by autoscaling
    # port churn and KV-handoff phases, not by per-op control.  Set
    # "opus"/"opus_prov" to price per-op shim control instead.
    mode: str = "oneshot"

    def __post_init__(self):
        assert self.job.pp == 1 and self.job.cp == 1 and self.job.ep == 1, \
            "serving replicas are TP x FSDP meshes"
        assert 1 <= self.min_replicas <= self.max_replicas
        assert self.batch_slots >= 1
        assert self.mode in ("opus", "opus_prov", "oneshot")

    @property
    def n_ranks(self) -> int:
        """Scale-out ranks = ports needed on every rail."""
        return self.job.fsdp


@dataclass(frozen=True)
class FleetParams:
    """Shared-rail substrate + queueing/autoscaler knobs of one fleet."""

    n_ports: int
    n_rails: int = 1
    policy: str = "contiguous"
    ocs_latency: float = 0.01
    nic_linkup: float = 0.0
    gpu: str = "h200"
    backend: str = "crossbar_ocs"   # crossbar_ocs | ocs_array | packet
    radix: Optional[int] = None
    # circuit-scheduling granularity (DESIGN.md §13) for reconfiguring
    # replica pools; static (oneshot/packet) pools stay phase_boundary
    scheduler: str = "phase_boundary"
    # measured compute calibration (DESIGN.md §15); None = analytic mfu
    calibration: object = None
    # KV handoff
    handoff_interval_s: float = 0.05   # circuit-fabric flush cadence
    relay_bw_factor: float = 0.5       # cross-sub-switch relay penalty
    kv_bytes_per_token_override: Optional[float] = None
    # autoscaler
    scale_interval_s: float = 1.0
    scale_up_headroom: float = 0.25
    # SLO + horizon
    ttft_slo_s: float = 5.0
    tail_s: float = 60.0               # post-trace drain grace

    def fabric_spec(self) -> FabricSpec:
        return FabricSpec(technology=self.backend, n_rails=self.n_rails,
                          reconfig_latency=self.ocs_latency,
                          nic_linkup=self.nic_linkup, radix=self.radix,
                          scheduler=(self.scheduler
                                     if self.backend != "packet"
                                     else "phase_boundary"))

    def replica_mode(self, pool_mode: str) -> str:
        """Packet rails take STATIC shims (mode ``native``) — there are
        no circuits for an opus shim to move."""
        return "native" if self.backend == "packet" else pool_mode

    def sim_params(self, pool_mode: str) -> SimParams:
        mode = self.replica_mode(pool_mode)
        return SimParams(mode=mode,
                         ocs_latency=self.ocs_latency,
                         nic_linkup=self.nic_linkup, n_rails=self.n_rails,
                         backend=self.backend, radix=self.radix,
                         scheduler=(self.scheduler
                                    if mode in ("opus", "opus_prov")
                                    else None))


@dataclass
class Replica:
    """One live (or past) replica: plane, measured step model, slots."""

    name: str
    kind: str                     # "prefill" | "decode"
    pool: PoolSpec
    ports: Tuple[int, ...]
    plane: ControlPlane
    admitted: float
    ready: float                  # end of the measurement/warmup run
    result: SimResult
    # step-time model derived from the measured run
    comm_ctrl_s: float = 0.0      # prefill: step - compute (token-invariant)
    compute_ref_s: float = 0.0    # prefill: compute at ref_prompt_tokens
    tpot_s: float = 0.0           # decode: seconds per token (whole batch)
    # runtime state
    status: str = "live"          # live | draining | released
    busy_until: float = 0.0       # prefill serialization / handoff phases
    active: int = 0               # occupied decode slots
    n_prefills: int = 0
    n_decodes: int = 0
    released: Optional[float] = None

    @property
    def free_slots(self) -> int:
        return self.pool.batch_slots - self.active

    def prefill_time(self, prompt_tokens: int) -> float:
        """Measured comm+control floor plus compute scaled to the prompt
        (per-layer AG bytes are token-invariant; compute is linear)."""
        scale = prompt_tokens / self.pool.ref_prompt_tokens
        return self.comm_ctrl_s + self.compute_ref_s * scale


@dataclass
class RequestRecord:
    req: Request
    prefill_start: Optional[float] = None
    prefill_done: Optional[float] = None
    first_token: Optional[float] = None
    done: Optional[float] = None
    replica: Optional[str] = None     # decode home (drains re-home it)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.req.arrival


def _pctl(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


class ServingFleet:
    """N serving replicas through shared per-rail OCS port space."""

    def __init__(self, params: FleetParams, prefill: PoolSpec,
                 decode: PoolSpec, trace: List[Request], *,
                 ocs_fail_by_replica: Optional[
                     Dict[str, Callable[[int], bool]]] = None):
        self.params = params
        self.prefill_pool = prefill
        self.decode_pool = decode
        self.trace = trace
        self.ocs_fail = dict(ocs_fail_by_replica or {})
        self.spec = params.fabric_spec()
        self.allocator = PortAllocator(params.n_ports, params.policy)
        self.rails = [RailOrchestrator(r, self.spec.make_backend(
                          params.n_ports))
                      for r in range(params.n_rails)]
        self.gpu = GPUS[params.gpu]
        self.replicas: List[Replica] = []      # admission order, all ever
        self.records: List[RequestRecord] = []
        self.events: List[Dict[str, object]] = []
        # queues
        self.prefill_queue: List[int] = []     # record indices, FIFO
        self.outbox: List[Tuple[int, str]] = []  # (record idx, src name)
        self.pending_decode: List[Tuple[int, str]] = []  # packet slot-wait
        # counters (all deterministic -> BENCH exact-match)
        self.n_scale_ups = 0
        self.n_scale_downs = 0
        self.n_failed_scale_ups = 0
        self.n_flushes = 0
        self.n_handoff_circuits = 0
        self.n_handoff_relays = 0
        self.n_drain_migrations = 0
        self._counter = {"prefill": 0, "decode": 0}
        self._seq = 0
        self._heap: List[Tuple[float, int, str, object]] = []
        self._wakeups: set = set()     # scheduled dispatch-retry times
        self._ran = False

    # -- substrate ----------------------------------------------------------
    @property
    def programmable(self) -> bool:
        return self.rails[0].ocs.programmable

    def _kv_transfer_s(self, tokens: float, bw_factor: float = 1.0) -> float:
        """Handoff seconds for one request's KV: each of the TP ranks
        ships its slice in parallel over its own rail port."""
        per_t = self.params.kv_bytes_per_token_override
        if per_t is None:
            per_t = kv_bytes_per_token(self.decode_pool.job.model)
        total = per_t * tokens / max(self.decode_pool.job.tp, 1)
        return total * 8.0 / (self.gpu.scale_out_gbps * 1e9 * bw_factor)

    def _handoff_ports(self, src: Replica, dst: Replica
                       ) -> Tuple[Tuple[int, ...], Tuple[int, ...], int]:
        """Circuit endpoints for one src->dst handoff: rank i wires to
        rank i.  When the pools' fsdp sizes differ only ``min(n)`` pairs
        can hold circuits — the unpaired ranks' KV slices hop through a
        wired peer instead, returned as a relay count (never silently
        truncated: migrate() asserts equal-length port tuples)."""
        k = min(len(src.ports), len(dst.ports))
        extra = max(len(src.ports), len(dst.ports)) - k
        return src.ports[:k], dst.ports[:k], extra

    def _wired(self, src: Replica, dst: Replica) -> bool:
        """Can a (src, dst) handoff pair hold a direct circuit?"""
        ocs = self.rails[0].ocs
        if not ocs.programmable:
            return False
        if isinstance(ocs, OCSArray):
            return ocs.sub_switch(src.ports[0]) == \
                ocs.sub_switch(dst.ports[0])
        return True

    def _sample(self, t: float, event: str, name: str) -> None:
        self.events.append({"t": t, "event": event, "replica": name,
                            **self.allocator.stats()})

    # -- replica lifecycle --------------------------------------------------
    def _admit(self, kind: str, now: float) -> Optional[Replica]:
        pool = self.prefill_pool if kind == "prefill" else self.decode_pool
        name = f"{kind}{self._counter[kind]}"
        grant = self.allocator.allocate(name, pool.n_ranks)
        if grant is None:
            self.n_failed_scale_ups += 1
            return None
        ocs = self.rails[0].ocs
        if isinstance(ocs, OCSArray) and not ocs.fits(grant):
            # the grant straddles a sub-switch boundary (DESIGN.md §10):
            # hand the ports back — the autoscaler re-tries next tick
            self.allocator.release(name)
            self.n_failed_scale_ups += 1
            return None
        self._counter[kind] += 1
        mode = self.params.replica_mode(pool.mode)
        plane = ControlPlane(pool.job, mode=SHIM_MODE[mode], job_id=name,
                             spec=self.spec,
                             ocs_fail=self.ocs_fail.get(name),
                             collapse=True, orchestrators=self.rails,
                             ports=grant, now=now)
        wl = build_serving(pool.job, self.params.gpu, kind,
                           batch_slots=pool.batch_slots,
                           prompt_tokens=pool.ref_prompt_tokens,
                           calibration=self.params.calibration)
        # replica steps are priced through the same vectorized core the
        # training engine runs (DESIGN.md §12); a one/two-iteration
        # serving step never fast-forwards, so the numbers are
        # bit-identical to the per-op collapsed engine's
        engine = VectorEngine(wl, self.params.sim_params(pool.mode),
                              plane=plane, start=now)
        res = engine.run()
        rep = Replica(name, kind, pool, grant, plane, admitted=now,
                      ready=engine.t, result=res, busy_until=engine.t)
        L = pool.job.model.n_layers
        if kind == "prefill":
            rep.compute_ref_s = L * wl.t_fwd_layer
            rep.comm_ctrl_s = res.step_time - rep.compute_ref_s
        else:
            rep.tpot_s = res.step_time
        self.replicas.append(rep)
        self.n_scale_ups += 1
        self._sample(now, "admit", name)
        return rep

    def _release(self, rep: Replica, now: float) -> None:
        assert rep.active == 0, (rep.name, rep.active)
        rep.status = "released"
        rep.released = now
        rep.plane.release(now=now)
        self.allocator.release(rep.name)
        self.n_scale_downs += 1
        self._sample(now, "release", rep.name)

    def _live(self, kind: str, *, ready_by: Optional[float] = None
              ) -> List[Replica]:
        return [r for r in self.replicas
                if r.kind == kind and r.status == "live"
                and (ready_by is None or r.ready <= ready_by)]

    # -- the event loop -----------------------------------------------------
    def _push(self, t: float, kind: str, payload: object = None) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, payload))

    def run(self) -> "FleetResult":
        assert not self._ran, "a ServingFleet runs once"
        self._ran = True
        p = self.params
        for _ in range(self.prefill_pool.min_replicas):
            self._admit("prefill", 0.0)
        for _ in range(self.decode_pool.min_replicas):
            self._admit("decode", 0.0)
        for req in self.trace:
            self.records.append(RequestRecord(req))
            self._push(req.arrival, "arrival", len(self.records) - 1)
        self.duration = max((r.arrival for r in self.trace),
                            default=0.0)
        self.horizon = self.duration + p.tail_s
        if self.trace:
            self._push(p.scale_interval_s, "scale")
            if self.programmable:
                self._push(p.handoff_interval_s, "flush")
        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            if kind == "arrival":
                self.prefill_queue.append(payload)
                self._dispatch_prefill(t)
            elif kind == "prefill_done":
                self._prefill_done(t, *payload)
            elif kind == "decode_done":
                self._decode_done(t, *payload)
            elif kind == "dispatch":
                self._wakeups.discard(t)
                self._dispatch_prefill(t)
            elif kind == "flush":
                self._flush(t)
            elif kind == "scale":
                self._scale(t)
        return FleetResult(self)

    # -- prefill ------------------------------------------------------------
    def _dispatch_prefill(self, t: float) -> None:
        if t > self.horizon:
            return
        wake: Optional[float] = None
        for rep in self._live("prefill"):
            if not self.prefill_queue:
                return
            start = max(t, rep.busy_until, rep.ready)
            if start > t:
                # busy (serializing, handoff phase) or still warming up:
                # remember when it frees so queued requests start THEN,
                # not at the next unrelated arrival/flush/scale event
                wake = start if wake is None else min(wake, start)
                continue
            idx = self.prefill_queue.pop(0)
            rec = self.records[idx]
            rec.prefill_start = start
            dur = rep.prefill_time(rec.req.prompt_tokens)
            rep.busy_until = start + dur
            rep.n_prefills += 1
            self._push(start + dur, "prefill_done", (idx, rep.name))
        if self.prefill_queue and wake is not None \
                and wake <= self.horizon and wake not in self._wakeups:
            self._wakeups.add(wake)
            self._push(wake, "dispatch")

    def _replica(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(name)

    def _prefill_done(self, t: float, idx: int, src_name: str) -> None:
        rec = self.records[idx]
        rec.prefill_done = t
        if self.programmable:
            self.outbox.append((idx, src_name))   # next flush ships it
        else:
            self._packet_handoff(t, idx, src_name)
        self._dispatch_prefill(t)

    # -- handoff (packet: routed, immediate) --------------------------------
    def _packet_handoff(self, t: float, idx: int, src_name: str) -> None:
        dst = self._pick_decode(t)
        if dst is None:
            self.pending_decode.append((idx, src_name))
            return
        rec = self.records[idx]
        src = self._replica(src_name)
        sp, dp, extra = self._handoff_ports(src, dst)
        for rail in self.rails:   # accounting + ownership asserts only
            tk = rail.migrate([(src.name, dst.name, sp, dp)], t)
        self.n_handoff_relays += tk.n_relayed + extra
        first = t + self._kv_transfer_s(rec.req.prompt_tokens)
        self._start_decode(first, idx, dst)

    def _pick_decode(self, t: float) -> Optional[Replica]:
        best = None
        for rep in self._live("decode", ready_by=t):
            if rep.free_slots <= 0:
                continue
            if best is None or rep.free_slots > best.free_slots:
                best = rep
        return best

    # -- handoff (circuit fabric: batched flush phase) ----------------------
    def _flush(self, t: float) -> None:
        assigns: List[Tuple[int, Replica, Replica]] = []
        if self.outbox:
            free: Dict[str, int] = {}
            # each source holds ONE handoff circuit per flush phase (its
            # ports are wired to exactly one destination — the same port
            # cannot hold two circuits, and migrate() rejects a program
            # that names a source port twice), so a source's entries all
            # stream to its pinned destination; overflow past that
            # destination's slots waits for the next flush
            pinned: Dict[str, str] = {}
            remaining: List[Tuple[int, str]] = []
            for idx, src_name in self.outbox:
                pin = pinned.get(src_name)
                if pin is not None:
                    if free[pin] > 0:
                        free[pin] -= 1
                        assigns.append((idx, self._replica(src_name),
                                        self._replica(pin)))
                    else:
                        remaining.append((idx, src_name))
                    continue
                dst = None
                for rep in self._live("decode", ready_by=t):
                    slots = free.setdefault(rep.name, rep.free_slots)
                    if slots <= 0:
                        continue
                    if dst is None or slots > free[dst.name]:
                        dst = rep
                if dst is None:
                    remaining.append((idx, src_name))
                    continue
                free[dst.name] -= 1
                pinned[src_name] = dst.name
                assigns.append((idx, self._replica(src_name), dst))
            self.outbox = remaining
        if assigns:
            self.n_flushes += 1
            # one migrate program wires EVERY pair of this flush phase
            groups: Dict[Tuple[str, str], List[int]] = {}
            for idx, src, dst in assigns:
                groups.setdefault((src.name, dst.name), []).append(idx)
            handoffs = []
            for s, d in groups:
                sp, dp, extra = self._handoff_ports(self._replica(s),
                                                    self._replica(d))
                handoffs.append((s, d, sp, dp))
                self.n_handoff_relays += extra
            done = t
            for rail in self.rails:
                tk = rail.migrate(handoffs, t)
                done = max(done, tk.done)
            self.n_handoff_circuits += tk.n_circuits
            self.n_handoff_relays += tk.n_relayed
            restore_at = done
            for (s, d), idxs in groups.items():
                src, dst = self._replica(s), self._replica(d)
                bwf = 1.0 if self._wired(src, dst) \
                    else self.params.relay_bw_factor
                tt = done
                for idx in idxs:            # transfers serialize per circuit
                    tt += self._kv_transfer_s(
                        self.records[idx].req.prompt_tokens, bwf)
                    self._start_decode(tt, idx, dst)
                restore_at = max(restore_at, tt)
            # closing reconfiguration: reinstate the borrowed rings
            srcs = sorted({s for s, _ in groups})
            r_done = restore_at
            for rail in self.rails:
                r_done = max(r_done, rail.restore(srcs, restore_at))
            for s in srcs:
                rep = self._replica(s)
                rep.busy_until = max(rep.busy_until, r_done)
        nxt = t + self.params.handoff_interval_s
        if nxt <= self.horizon and (t < self.duration or self.outbox
                                    or self.prefill_queue
                                    or any(r.busy_until > t
                                           for r in self._live("prefill"))):
            self._push(nxt, "flush")
        if t <= self.horizon:
            self._dispatch_prefill(t)

    # -- decode -------------------------------------------------------------
    def _start_decode(self, first_token: float, idx: int,
                      rep: Replica) -> None:
        rec = self.records[idx]
        rec.first_token = first_token
        rec.replica = rep.name
        rep.active += 1
        rep.n_decodes += 1
        done = first_token + rec.req.decode_tokens * rep.tpot_s
        self._push(done, "decode_done", (idx,))

    def _decode_done(self, t: float, idx: int) -> None:
        rec = self.records[idx]
        rec.done = t
        rep = self._replica(rec.replica)
        rep.active -= 1
        if rep.status == "draining" and rep.active == 0:
            self._release(rep, t)
        if self.pending_decode and rep.status == "live":
            nidx, src = self.pending_decode.pop(0)
            self._packet_handoff(t, nidx, src)

    # -- autoscaler ---------------------------------------------------------
    def _scale(self, t: float) -> None:
        p = self.params
        # decode pool: slot demand with headroom
        live_d = self._live("decode")
        waiting = len(self.outbox) + len(self.pending_decode)
        demand = sum(r.active for r in live_d) + waiting
        slots = self.decode_pool.batch_slots
        target_d = max(self.decode_pool.min_replicas,
                       min(self.decode_pool.max_replicas,
                           math.ceil(demand * (1.0 + p.scale_up_headroom)
                                     / slots)))
        while len(live_d) < target_d:
            if self._admit("decode", t) is None:
                break
            live_d = self._live("decode")
        if len(live_d) > target_d:
            self._drain_one(live_d, t)
        # prefill pool: queue pressure
        live_p = self._live("prefill")
        busy = sum(1 for r in live_p if r.busy_until > t)
        target_p = max(self.prefill_pool.min_replicas,
                       min(self.prefill_pool.max_replicas,
                           busy + math.ceil(len(self.prefill_queue) / 2)))
        while len(live_p) < target_p:
            if self._admit("prefill", t) is None:
                break
            live_p = self._live("prefill")
            self._dispatch_prefill(t)
        if len(live_p) > target_p:
            # a prefill replica still HOLDING un-migrated KV (finished
            # requests waiting in the handoff outbox) owns live state on
            # its ports — releasing it would orphan the handoff's source
            # circuits, and the ownership assert would (rightly) fire
            holding = {src for _, src in self.outbox}
            holding.update(src for _, src in self.pending_decode)
            victims = [r for r in live_p
                       if r.busy_until <= t and r.name not in holding]
            if victims and len(live_p) > self.prefill_pool.min_replicas:
                rep = victims[-1]
                rep.status = "draining"
                self._release(rep, t)
        nxt = t + p.scale_interval_s
        if nxt <= self.horizon and (
                t < self.duration or self.prefill_queue or self.outbox
                or self.pending_decode
                or any(r.active for r in self._live("decode"))):
            self._push(nxt, "scale")

    def _drain_one(self, live_d: List[Replica], t: float) -> None:
        """Drain the decode replica with the fewest resident requests,
        migrating its KV to peers with free slots (a rail workload)."""
        victim = min(live_d, key=lambda r: (r.active, r.name))
        victim.status = "draining"
        if victim.active == 0:
            self._release(victim, t)
            return
        moved: List[int] = [i for i, rec in enumerate(self.records)
                            if rec.replica == victim.name
                            and rec.done is None
                            and rec.first_token is not None]
        # a persistent OCS fault mid-drain (§4.2 spirit): the migration's
        # circuits cannot be wired, so the KV is RELAYED at reduced
        # bandwidth — the drain still completes and every ownership /
        # telemetry invariant holds on the fault path too
        fail = self.ocs_fail.get(victim.name)
        faulted = fail is not None and all(fail(k) for k in range(3))
        done = t
        for idx in list(moved):
            dst = self._pick_decode(t)
            if dst is None:
                break        # no room: finish resident work, then release
            rec = self.records[idx]
            bwf = 1.0
            if faulted:
                self.n_handoff_relays += len(victim.ports)
                bwf = self.params.relay_bw_factor
            else:
                sp, dp, extra = self._handoff_ports(victim, dst)
                for rail in self.rails:
                    tk = rail.migrate([(victim.name, dst.name, sp, dp)], t)
                    done = max(done, tk.done)
                self.n_handoff_relays += tk.n_relayed + extra
            self.n_drain_migrations += 1
            # resident KV = prompt + tokens generated so far (~half)
            done += self._kv_transfer_s(rec.req.prompt_tokens
                                        + rec.req.decode_tokens // 2, bwf)
            rec.replica = dst.name
            victim.active -= 1
            dst.active += 1
        if victim.active == 0:
            self._release(victim, max(t, done))


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


@dataclass
class FleetResult:
    fleet: ServingFleet

    @property
    def params(self) -> FleetParams:
        return self.fleet.params

    @property
    def replicas(self) -> List[Replica]:
        return self.fleet.replicas

    @property
    def records(self) -> List[RequestRecord]:
        return self.fleet.records

    def peak_concurrent(self) -> Tuple[int, int]:
        """(peak live replicas, peak GPUs) over the fleet's lifetime."""
        deltas: List[Tuple[float, int, int]] = []
        for rep in self.replicas:
            g = rep.pool.job.n_gpus
            deltas.append((rep.admitted, 1, g))
            if rep.released is not None:
                deltas.append((rep.released, -1, -g))
        peak_r = peak_g = cur_r = cur_g = 0
        for _, dr, dg in sorted(deltas, key=lambda x: (x[0], x[1])):
            cur_r += dr
            cur_g += dg
            peak_r, peak_g = max(peak_r, cur_r), max(peak_g, cur_g)
        return peak_r, peak_g

    def summary(self) -> Dict[str, object]:
        """Fleet-level metrics: ints deterministic (perf-gate exact),
        floats deterministic model outputs (1e-6 gate)."""
        f = self.fleet
        p = f.params
        gpu = f.gpu
        done = [r for r in f.records if r.done is not None]
        ttfts = [r.ttft for r in f.records if r.ttft is not None]
        slo_ok = sum(1 for r in done if r.ttft <= p.ttft_slo_s)
        duration = max(f.duration, 1e-9)
        peak_r, peak_g = self.peak_concurrent()
        tpots = [r.tpot_s for r in f.replicas if r.kind == "decode"]
        out: Dict[str, object] = {
            "n_requests": len(f.records),
            "n_completed": len(done),
            "n_slo_met": slo_ok,
            "duration_s": round(duration, 6),
            "throughput_rps": round(len(done) / duration, 6),
            "goodput_rps": round(slo_ok / duration, 6),
            "p50_ttft_s": round(_pctl(ttfts, 0.50), 6),
            "p99_ttft_s": round(_pctl(ttfts, 0.99), 6),
            "mean_tpot_s": round(sum(tpots) / len(tpots), 6) if tpots
            else 0.0,
            "peak_replicas": peak_r,
            "peak_gpus": peak_g,
            "n_scale_ups": f.n_scale_ups,
            "n_scale_downs": f.n_scale_downs,
            "n_failed_scale_ups": f.n_failed_scale_ups,
            "n_handoff_flushes": f.n_flushes,
            "n_handoff_circuits": f.n_handoff_circuits,
            "n_handoff_relays": f.n_handoff_relays,
            "n_drain_migrations": f.n_drain_migrations,
            "allocator": f.allocator.stats(),
            "rails": {
                "n_reconfig_events": sum(o.n_reconfig_events
                                         for o in f.rails),
                "n_program_calls": sum(o.ocs.n_program_calls
                                       for o in f.rails),
                "n_ports_programmed": sum(o.ocs.n_ports_programmed
                                          for o in f.rails),
                "n_queued_programs": sum(o.ocs.n_queued_programs
                                         for o in f.rails),
                "queue_wait_s": round(sum(o.ocs.queue_wait_s
                                          for o in f.rails), 6),
            },
        }
        # the headline: requests/s-per-watt, network watts billed from
        # the SAME FabricSpec the rails were simulated on (DESIGN.md §10)
        if peak_g > 0:
            from repro_torch.sim.costmodel import (OCS_PORTS_PER_LINK,
                                             rail_fabric)
            part = "eps_800g_cpo" if p.gpu == "gb200" else "eps_400g"
            spec = replace(p.fabric_spec(),
                           ports_per_link=OCS_PORTS_PER_LINK.get(part, 1)
                           if p.backend != "packet" else 1,
                           part=part if p.backend == "packet" else None)
            bill = rail_fabric(peak_g, gpu.domain, spec)
            net_w = bill.power
            gpu_w = peak_g * gpu.tdp_w
            thr = len(done) / duration
            out["network_power_w"] = round(net_w, 2)
            out["gpu_power_w"] = round(gpu_w, 2)
            out["rps_per_net_kw"] = round(thr / max(net_w / 1e3, 1e-9), 6)
            out["rps_per_total_kw"] = round(
                thr / max((net_w + gpu_w) / 1e3, 1e-9), 6)
        return out

    def replica_rows(self) -> List[Dict[str, object]]:
        rows = []
        for rep in self.replicas:
            rows.append({
                "replica": rep.name, "kind": rep.kind,
                "n_gpus": rep.pool.job.n_gpus,
                "ports": list(rep.ports),
                "admitted": round(rep.admitted, 4),
                "released": (round(rep.released, 4)
                             if rep.released is not None else None),
                "step_s": round(rep.result.step_time, 6),
                "served": (rep.n_prefills if rep.kind == "prefill"
                           else rep.n_decodes),
            })
        return rows


def simulate_fleet(params: FleetParams, prefill: PoolSpec, decode: PoolSpec,
                   trace_params: TraceParams, *,
                   ocs_fail_by_replica=None) -> FleetResult:
    """Convenience driver: make the trace, run the fleet."""
    fleet = ServingFleet(params, prefill, decode, make_trace(trace_params),
                         ocs_fail_by_replica=ocs_fail_by_replica)
    return fleet.run()
