"""Inter-phase window model (paper §3.2, Fig 4).

Given a *timed* schedule — (op, start, end) per scale-out op — the window
between consecutive phases P1, P2 is

    T_window = min_{j in P2} T_start(j)  -  max_{i in P1} T_end(i),

where a collective's start is when its SLOWEST rank joins.  Windows are
categorized by the traffic volume of the phase AFTER the window (Fig 4b
classes: <1MB sync ARs, PP sends, AG, RS).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.core.phases import CommOp, build_phase_table


@dataclass(frozen=True)
class TimedOp:
    op: CommOp
    start: float
    end: float


@dataclass(frozen=True)
class Window:
    t_start: float
    t_end: float
    before_dim: str
    after_dim: str
    after_bytes: float          # traffic volume of the next phase

    @property
    def size(self) -> float:
        return max(0.0, self.t_end - self.t_start)


def windows_of(timed: Sequence[TimedOp]) -> List[Window]:
    ops = [t.op for t in timed if t.op.scale == "scale_out"]
    ts = {t.op.uid: t for t in timed}
    phases = build_phase_table(ops)
    out: List[Window] = []
    for p1, p2 in zip(phases, phases[1:]):
        end_p1 = max(ts[u].end for u in range(p1.start_idx, p1.end_idx + 1)
                     if u in ts)
        start_p2 = min(ts[u].start for u in range(p2.start_idx,
                                                  p2.end_idx + 1) if u in ts)
        vol = sum(ts[u].op.bytes_per_gpu
                  for u in range(p2.start_idx, p2.end_idx + 1) if u in ts)
        out.append(Window(end_p1, start_p2, p1.dim, p2.dim, vol))
    return out


def volume_class(nbytes: float) -> str:
    """Fig 4b traffic classes."""
    if nbytes < 1e6:
        return "<1MB (sync AR)"
    if nbytes < 256e6:
        return "send/recv (PP)"
    if nbytes < 2e9:
        return "AllGather (DP)"
    return "ReduceScatter (DP)"


def window_cdf(ws: Sequence[Window]) -> List[Tuple[float, float]]:
    sizes = sorted(w.size for w in ws)
    n = len(sizes)
    return [(s, (i + 1) / n) for i, s in enumerate(sizes)]


def fraction_over(ws: Sequence[Window], threshold: float) -> float:
    """Fraction of windows larger than ``threshold`` seconds (paper: >75%
    of windows exceed 1 ms)."""
    if not ws:
        return 0.0
    return sum(1 for w in ws if w.size > threshold) / len(ws)
