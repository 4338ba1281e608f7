"""Deterministic request traces for the serving-fleet simulator.

Production serving load is diurnal (a smooth day/night swing) with bursty
excursions (launches, retries, batch clients); the fleet simulator needs
both shapes to exercise the autoscaler, and every number derived from a
trace lands in a committed BENCH record — so arrivals come from a
nonhomogeneous Poisson process *thinned over a fixed LCG stream* (same
generator family as :func:`repro_torch.sim.cluster.exp_trace`): no platform
RNG, bit-identical everywhere.

    λ(t) = base_rate * (1 + diurnal_amp * sin(2π t / diurnal_period_s))
           * burst multiplier while t is inside a burst window

Per-request token lengths are drawn from the same stream: geometric-ish
(exponential, rounded) prompt and decode lengths, clamped to the
configured bounds.  ``diurnal_period_s`` defaults to a *compressed* day:
fleet sims run minutes of simulated time, so the period is a knob, not a
calendar fact.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple


class LCG:
    """The repo's fixed linear congruential stream (see cluster.exp_trace
    — same constants), packaged for multi-draw consumers."""

    def __init__(self, seed: int = 1):
        self.x = (seed or 1) & 0x7FFFFFFF

    def uniform(self) -> float:
        """Strictly inside (0, 1)."""
        self.x = (1103515245 * self.x + 12345) & 0x7FFFFFFF
        return (self.x + 1) / 2147483649.0

    def exponential(self, mean: float) -> float:
        return -mean * math.log(1.0 - self.uniform())


@dataclass(frozen=True)
class Request:
    """One user request as the fleet sees it."""

    rid: int
    arrival: float
    prompt_tokens: int
    decode_tokens: int


@dataclass(frozen=True)
class TraceParams:
    """Shape of a deterministic diurnal + bursty request trace."""

    duration_s: float = 120.0
    base_rate: float = 10.0            # requests/s at the diurnal mean
    diurnal_amp: float = 0.5           # peak-to-mean swing (0..1)
    diurnal_period_s: float = 120.0    # compressed day
    # burst windows: (start_s, duration_s, rate multiplier)
    bursts: Tuple[Tuple[float, float, float], ...] = ()
    mean_prompt_tokens: int = 2048
    max_prompt_tokens: int = 8192
    min_prompt_tokens: int = 64
    mean_decode_tokens: int = 256
    max_decode_tokens: int = 1024
    min_decode_tokens: int = 16
    seed: int = 1

    def __post_init__(self):
        assert self.duration_s > 0 and self.base_rate > 0
        assert 0.0 <= self.diurnal_amp < 1.0, self.diurnal_amp
        assert self.diurnal_period_s > 0
        for s, d, m in self.bursts:
            assert s >= 0 and d > 0 and m >= 1.0, (s, d, m)

    def rate_at(self, t: float) -> float:
        """λ(t): diurnal modulation times any active burst multiplier."""
        lam = self.base_rate * (
            1.0 + self.diurnal_amp
            * math.sin(2.0 * math.pi * t / self.diurnal_period_s))
        for start, dur, mult in self.bursts:
            if start <= t < start + dur:
                lam *= mult
        return lam

    @property
    def peak_rate(self) -> float:
        peak_mult = max((m for _, _, m in self.bursts), default=1.0)
        return self.base_rate * (1.0 + self.diurnal_amp) * peak_mult


def _clamped_exp(rng: LCG, mean: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(round(rng.exponential(float(mean))))))


def make_trace(params: TraceParams) -> List[Request]:
    """The trace, by thinning: candidate arrivals at ``peak_rate``, each
    accepted with probability λ(t)/peak_rate.  Token lengths are drawn
    for ACCEPTED requests only, from the same stream — so two traces that
    agree on every accept/reject decision agree on everything."""
    rng = LCG(params.seed)
    lam_max = params.peak_rate
    out: List[Request] = []
    t = 0.0
    rid = 0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= params.duration_s:
            break
        if rng.uniform() * lam_max > params.rate_at(t):
            continue                      # thinned away
        out.append(Request(
            rid, t,
            _clamped_exp(rng, params.mean_prompt_tokens,
                         params.min_prompt_tokens,
                         params.max_prompt_tokens),
            _clamped_exp(rng, params.mean_decode_tokens,
                         params.min_decode_tokens,
                         params.max_decode_tokens)))
        rid += 1
    return out


@dataclass
class TraceStats:
    n_requests: int = 0
    mean_rate_rps: float = 0.0
    total_prompt_tokens: int = 0
    total_decode_tokens: int = 0
    windows: List[Tuple[float, int]] = field(default_factory=list)


def trace_stats(reqs: List[Request], params: TraceParams,
                window_s: float = 10.0) -> TraceStats:
    """Summary + per-window arrival counts (the autoscaler's view)."""
    st = TraceStats(n_requests=len(reqs))
    if not reqs:
        return st
    st.mean_rate_rps = len(reqs) / params.duration_s
    st.total_prompt_tokens = sum(r.prompt_tokens for r in reqs)
    st.total_decode_tokens = sum(r.decode_tokens for r in reqs)
    n_win = int(math.ceil(params.duration_s / window_s))
    counts = [0] * n_win
    for r in reqs:
        counts[min(int(r.arrival // window_s), n_win - 1)] += 1
    st.windows = [(i * window_s, c) for i, c in enumerate(counts)]
    return st
