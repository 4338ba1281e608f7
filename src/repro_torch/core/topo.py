"""Topology-ID encoding and sub-mapping decomposition (paper §4.1, Fig 8).

A job's rail connectivity requirement is a ``TopoId``: one decimal digit per
*way* (stage) of the asymmetric parallelism (PP).  Digit values:

    0      -> PP owns the stage's connectivity (asymmetric Send/Recv)
    1..9   -> symmetric parallelism #k (DP=1, CP=2, EP=3, ... job-defined)

Up to 10 parallelism dimensions are supported per digit (paper §7).

The orchestrator never stores the full cross-product of topologies
(O(N_par^P_asym * N_rank)); it stores one *sub-mapping* per way
(O(N_par * N_rank) total) and reprograms only the ways whose digit changed
(O(N_rank / P_asym) ports per event).  ``diff_digits`` + ``affected_ways``
implement the dispatch rules of §4.1:

  (i)  symmetric<->symmetric or symmetric-owned digit change: exactly the
       changed ways are rewired;
  (ii) asymmetric shifts (a way toggling to/from 0) additionally rewire the
       peer way it is pipeline-connected to.

Per-collective circuit rounds (PCCL mode, DESIGN.md §13) extend the
encoding with a per-way *variant*: the matching a symmetric digit wires
within each group.  Variant 0 is the canonical shift-1 ring (the only
matching phase-boundary scheduling ever uses — an all-zero variant
vector normalizes away, so pre-variant TopoIds compare and dispatch
bit-identically).  Variant v>0 is the shift-v ring (round v of a
round-robin all-to-all: port i wires to port (i+v) mod n).  Variant v<0
is the XOR matching at distance -v (recursive-halving round: port i
exchanges with port i^(-v)).  A variant change on an unchanged digit is
still a real reconfiguration — ``affected_ways`` reports it and the
orchestrator reprograms the way's matching.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Sequence, Tuple

PP_DIGIT = 0


@dataclass(frozen=True)
class TopoId:
    """digits[way] = owning parallelism for that way (index 0 = stage 0).

    ``variants[way]`` selects the matching wired within each group of the
    owning symmetric dimension (0 = shift-1 ring; v>0 = shift-v ring;
    v<0 = XOR matching at distance -v; ignored on PP-owned ways).  An
    all-zero variant vector normalizes to () so phase-boundary TopoIds
    stay bit-identical to the pre-variant encoding.
    """

    digits: Tuple[int, ...]
    variants: Tuple[int, ...] = ()

    def __post_init__(self):
        assert all(0 <= d <= 9 for d in self.digits), self.digits
        if self.variants:
            assert len(self.variants) == len(self.digits), \
                (self.digits, self.variants)
            if not any(self.variants):
                object.__setattr__(self, "variants", ())

    @classmethod
    def uniform(cls, n_ways: int, digit: int) -> "TopoId":
        return cls(tuple([digit] * n_ways))

    def variant_of(self, way: int) -> int:
        return self.variants[way] if self.variants else 0

    def encode(self) -> int:
        """Decimal integer; digit position i = way i (way 0 least
        significant, so int round-trips need n_ways)."""
        out = 0
        for d in reversed(self.digits):
            out = out * 10 + d
        return out

    @classmethod
    def decode(cls, value: int, n_ways: int) -> "TopoId":
        ds = []
        for _ in range(n_ways):
            ds.append(value % 10)
            value //= 10
        assert value == 0, "encoded value wider than n_ways"
        return cls(tuple(ds))

    def with_way(self, way: int, digit: int, variant: int = 0) -> "TopoId":
        return self.with_ways((way,), digit, variant)

    def with_ways(self, ways: Sequence[int], digit: int,
                  variant: int = 0) -> "TopoId":
        ds = list(self.digits)
        vs = list(self.variants) if self.variants else [0] * len(ds)
        for w in ways:
            ds[w] = digit
            vs[w] = variant
        return TopoId(tuple(ds), tuple(vs))

    @property
    def n_ways(self) -> int:
        return len(self.digits)


def diff_digits(old: TopoId, new: TopoId) -> List[int]:
    assert old.n_ways == new.n_ways
    return [i for i, (a, b) in enumerate(zip(old.digits, new.digits))
            if a != b]


def affected_ways(old: TopoId, new: TopoId) -> List[int]:
    """Ways whose sub-mapping must be reprogrammed for old->new (§4.1).

    Asymmetric-to-symmetric shift at way m also disturbs the way(s) that
    were pipeline-connected to m (the adjacent way that was also 0).
    A variant change on a symmetric way (per-collective circuit round,
    §13) rewires that way's matching even when the digit is unchanged.
    """
    changed = diff_digits(old, new)
    out = set(changed)
    out.update(w for w in range(old.n_ways)
               if new.digits[w] != PP_DIGIT
               and old.variant_of(w) != new.variant_of(w))
    for w in changed:
        if old.digits[w] == PP_DIGIT and new.digits[w] != PP_DIGIT:
            # leaving PP: the previously-connected neighbour way(s)
            for nb in (w - 1, w + 1):
                if 0 <= nb < old.n_ways and old.digits[nb] == PP_DIGIT:
                    out.add(nb)
    return sorted(out)


# ---------------------------------------------------------------------------
# port maps / sub-mappings
# ---------------------------------------------------------------------------

PortPair = Tuple[int, int]


@dataclass(frozen=True)
class SubMapping:
    """Port wiring for one way of one job on one rail.

    ``pairs`` is a directed matching: (src_port -> dst_port).  A ring over
    ports (p0, p1, ..., pk) is the pairs (p0,p1),(p1,p2),...,(pk,p0).
    """

    way: int
    owner_digit: int
    pairs: Tuple[PortPair, ...]

    @property
    def ports(self) -> FrozenSet[int]:
        out = set()
        for a, b in self.pairs:
            out.add(a)
            out.add(b)
        return frozenset(out)


def ring_pairs(ports: Sequence[int]) -> Tuple[PortPair, ...]:
    n = len(ports)
    if n <= 1:
        return ()
    return tuple((ports[i], ports[(i + 1) % n]) for i in range(n))


def matching_pairs(ports: Sequence[int],
                   variant: int = 0) -> Tuple[PortPair, ...]:
    """The directed matching a circuit-round variant wires over a group.

    variant 0: the canonical shift-1 ring.  variant v>0: the shift-v
    ring (round-robin all-to-all round v — every port sends to its v-th
    successor; gcd(v,n)>1 splits the ring into cycles, still a valid
    matching).  variant v<0: the XOR exchange at distance -v (recursive
    halving — port i pairs with port i^(-v); partners beyond the group
    are left dark that round, as is a shift that lands on itself).
    """
    n = len(ports)
    if n <= 1:
        return ()
    if variant == 0:
        return ring_pairs(ports)
    if variant > 0:
        s = variant % n
        if s == 0:
            return ()
        return tuple((ports[i], ports[(i + s) % n]) for i in range(n))
    d = -variant
    return tuple((ports[i], ports[i ^ d]) for i in range(n)
                 if (i ^ d) < n)


@dataclass
class JobPlacement:
    """Which rail ports belong to which (way, symmetric-group) of a job.

    ports_by_way[way] = ordered ports of that pipeline stage on this rail.
    sym_groups[k][way] = list of port-groups; each group forms one ring for
    symmetric parallelism k restricted to that way (e.g. the DP group).
    """

    job_id: str
    ports_by_way: Tuple[Tuple[int, ...], ...]
    sym_groups: Dict[int, Dict[int, List[Tuple[int, ...]]]]

    @property
    def n_ways(self) -> int:
        return len(self.ports_by_way)

    @property
    def all_ports(self) -> FrozenSet[int]:
        return frozenset(p for way in self.ports_by_way for p in way)


def build_submapping(placement: JobPlacement, topo: TopoId,
                     way: int) -> SubMapping:
    """The port wiring of one way under ``topo``.

    Symmetric digit k: one matching per sym-group of dim k within the
    way — the shift-1 ring at variant 0, a shifted/XOR round matching
    otherwise (per-collective circuit rounds, §13).
    PP digit: each port pairs with the same-index port of the next PP-owned
    way (activation Send/Recv circuits; variants do not apply).
    """
    d = topo.digits[way]
    if d != PP_DIGIT:
        v = topo.variant_of(way)
        pairs: List[PortPair] = []
        for grp in placement.sym_groups[d][way]:
            pairs.extend(matching_pairs(grp, v))
        return SubMapping(way, d, tuple(pairs))
    # PP: connect to the adjacent PP-owned way (forward direction)
    nxt = way + 1
    pairs = []
    if nxt < placement.n_ways and topo.digits[nxt] == PP_DIGIT:
        a = placement.ports_by_way[way]
        b = placement.ports_by_way[nxt]
        pairs = [(x, y) for x, y in zip(a, b)]
    return SubMapping(way, PP_DIGIT, tuple(pairs))


def full_mapping(placement: JobPlacement, topo: TopoId) -> List[SubMapping]:
    return [build_submapping(placement, topo, w)
            for w in range(placement.n_ways)]


# ---------------------------------------------------------------------------
# storage accounting (paper §4.1 "Sub-mapping decomposition")
# ---------------------------------------------------------------------------


def naive_storage(n_parallel: int, p_asym: int, n_rank: int) -> int:
    """All possible full mappings: O(N_parallel^P_asym * N_rank)."""
    return (n_parallel ** p_asym) * n_rank


def opus_storage(n_parallel: int, p_asym: int, n_rank: int) -> int:
    """Per-way sub-mappings: O(N_parallel * N_rank)."""
    return n_parallel * n_rank


def ports_per_event(n_rank: int, p_asym: int) -> int:
    """Ports reprogrammed per reconfiguration event: O(N_rank / P_asym)."""
    return max(1, n_rank // max(p_asym, 1))
