"""Deterministic fault model for the degrade-and-recover state machine
(DESIGN.md §14).

The paper's §4.2 robustness story ends at one persistent OCS failure ->
permanent giant-ring demotion.  Production photonic rails spend their
life in the gray zone between healthy and dead: links FLAP — a rail's
circuits go dark for a repair time, then come back.  This module is the
declarative description of that gray zone:

``LinkFlap``    one outage window on one rail (or every rail);
``FaultModel``  a set of flaps plus the controller's retry/backoff
                budget and whether repaired rails RECOVER the requested
                topology (the new capability) or stay demoted forever
                (the legacy §4.2 behaviour).

A ``FaultModel`` rides the exact channel legacy injectors used — the
``ocs_fail`` parameter threaded from ``ControlPlane`` through
``Controller.topo_write`` — but the controller recognises it by type
and consults wall-clock outage windows (``down(rail, now)``) instead of
an ``attempt -> bool`` callable, so retries that WAIT OUT a short flap
succeed instead of burning the budget blind.  Legacy plain callables
keep their old semantics bit-for-bit (permanent demotion, no recovery,
fast-forward disabled).

Everything is drawn from the repo's fixed LCG (the ``exp_trace``
recurrence), never a global RNG: the ops benchmark commits counters
derived from these windows, so they must reproduce bit-exactly
everywhere.

The typed exceptions below replace the bare ``assert`` ownership and
migration-contract checks on the orchestrator dispatch paths.  They
subclass :class:`AssertionError` so every existing
``pytest.raises(AssertionError)`` contract still holds, while scenario
code can catch-and-degrade on the precise type — and the checks survive
``python -O``, which strips bare asserts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


class PortOwnershipError(AssertionError):
    """A program would touch ports outside the dispatching job's grant
    (the DESIGN.md §9 isolation invariant, now a real raise)."""


class MigrationContractError(AssertionError):
    """A migration/evacuation program violates its pairing contract
    (src/dst length mismatch, self-migration, duplicate sources)."""


# the repo-wide deterministic LCG (same recurrence as cluster.exp_trace)
_LCG_A = 1103515245
_LCG_C = 12345
_LCG_M = 0x7FFFFFFF


def _lcg_next(x: int) -> Tuple[int, float]:
    x = (_LCG_A * x + _LCG_C) & _LCG_M
    return x, (x + 1) / 2147483649.0       # strictly inside (0, 1)


def pick_victim(names: Sequence[str], seed: int = 1) -> str:
    """Deterministic victim selection for fault-injection scenarios:
    one LCG draw over the candidate list (tenant names, rail ids...).
    No global RNG — the same seed picks the same victim everywhere."""
    assert names, "no candidates to pick a victim from"
    x, u = _lcg_next((seed or 1) & _LCG_M)
    return names[int(u * len(names)) % len(names)]


@dataclass(frozen=True)
class LinkFlap:
    """One transient outage: ``rail``'s circuits are down (every
    dispatch times out) for ``start <= now < start + duration``.
    ``rail=-1`` takes every rail down (a shared-tree event)."""

    rail: int
    start: float
    duration: float

    def __post_init__(self):
        assert self.duration >= 0.0, self.duration
        assert self.start >= 0.0, self.start

    @property
    def end(self) -> float:
        return self.start + self.duration

    def covers(self, rail: int, now: float) -> bool:
        return (self.rail == -1 or self.rail == rail) \
            and self.start <= now < self.end


@dataclass(frozen=True)
class FaultModel:
    """A deterministic flap schedule plus the controller's response
    policy.

    retry_budget  dispatch attempts before giant-ring demotion
                  (None -> the controller's own ``max_retries``, i.e.
                  exactly the §4.2 budget)
    backoff       wait multiplier between attempts: attempt k waits
                  ``timeout * backoff**k``.  1.0 reproduces the legacy
                  fixed-timeout retry loop bit-exactly.
    recovery      True (default): once every flap covering a rail has
                  ended, ``Controller.recover`` restores the requested
                  topology, clears the demotion, and the replay cache /
                  vector fast-forward re-arm.  False: legacy one-way
                  cliff (demotion is forever).
    """

    flaps: Tuple[LinkFlap, ...]
    retry_budget: Optional[int] = None
    backoff: float = 1.0
    recovery: bool = True

    def __post_init__(self):
        assert self.retry_budget is None or self.retry_budget >= 1
        assert self.backoff > 0.0, self.backoff

    def down(self, rail: int, now: float) -> bool:
        """Is ``rail`` inside any outage window at ``now``?"""
        return any(f.covers(rail, now) for f in self.flaps)

    @property
    def horizon(self) -> float:
        """Time after which no flap can ever fire again — past this the
        vector engine may capture a steady iteration and fast-forward
        (nothing left to perturb the cycle)."""
        return max((f.end for f in self.flaps), default=0.0)

    @classmethod
    def flap_storm(cls, n: int, *, mean_gap: float = 10.0,
                   mean_repair: float = 1.0, rail: int = -1,
                   start: float = 0.0, seed: int = 1,
                   retry_budget: Optional[int] = None,
                   backoff: float = 1.0,
                   recovery: bool = True) -> "FaultModel":
        """``n`` non-overlapping flaps with exponential inter-arrival
        gaps and repair times drawn from the fixed LCG (the exp_trace
        recurrence) — the deterministic 'flap storm' scenario."""
        assert n >= 0 and mean_gap >= 0.0 and mean_repair >= 0.0
        x = (seed or 1) & _LCG_M
        flaps = []
        t = start
        for _ in range(n):
            x, u = _lcg_next(x)
            t += -mean_gap * math.log(1.0 - u)
            x, u = _lcg_next(x)
            dur = -mean_repair * math.log(1.0 - u)
            flaps.append(LinkFlap(rail=rail, start=t, duration=dur))
            t += dur
        return cls(tuple(flaps), retry_budget=retry_budget,
                   backoff=backoff, recovery=recovery)
