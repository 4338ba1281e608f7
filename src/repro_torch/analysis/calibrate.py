"""Fitted compute calibration: measured kernel time -> effective MFU table
(a copy of ``repro.analysis.calibrate``, which the port does not import).

* a :class:`TimingArtifact` — the JSON record a
  :mod:`repro_torch.profiling.microbench` run produces: per (kernel/phase,
  shape-class) trimmed-mean times next to the FLOPs that
  :mod:`repro_torch.analysis.cost` counts over the plain versions and the
  bytes of the inputs and outputs (kernels) or of
  :mod:`repro_torch.analysis.memmodel` (phases), plus provenance (torch and
  CUDA versions, the card's name and power limit, kernel source hash).
  Its format is the JAX package's: each package's fit reads the other's.

* a :class:`CalibrationTable` — ``fit()`` regresses each class's measured
  times against the roofline terms ``t ≈ α·flops/peak + β·bytes/hbm_bw``
  (closed-form 2x2 normal equations in pure Python, so the fit is
  bit-reproducible from the same artifact on any platform; no LAPACK) and
  keeps every sample's achieved FLOP/s as an interpolation curve.
  ``compute_time(key, flops)`` prices a phase by piecewise log-log
  interpolation over that curve (clamped outside the measured range);
  ``1/α`` and ``1/β`` are the per-class *effective* MFU and HBM
  efficiency relative to the artifact's target chip.

The table is identity-hashable (``eq=False``) so it can thread through
``lru_cache``'d functions and frozen parameter dataclasses.
"""
from __future__ import annotations

import json
import math
from bisect import bisect_left
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.hardware import PROFILES, HardwareProfile

SCHEMA = 1

#: phase keys the simulator consumes (kernel keys ride along as diagnostics)
PHASE_KEYS = ("train_fwd", "train_bwd", "prefill", "decode")


@dataclass(frozen=True)
class TimingRecord:
    """One measured (kernel/phase, shape) sample."""

    key: str               # flash_attention | ssd_scan | decode_attention |
    #                        train_fwd | train_bwd | prefill | decode
    shape_class: str       # e.g. "h32kv8d128" or a config name
    shape: Dict[str, object]
    flops: float           # per-call FLOPs (analysis.cost over the plain versions)
    bytes_accessed: float  # per-call bytes (inputs and outputs, or memmodel)
    t_mean_s: float        # trimmed-mean wall seconds per call
    t_min_s: float
    repeats: int
    skipped: bool = False
    skip_reason: str = ""

    @property
    def valid(self) -> bool:
        return (not self.skipped and self.t_mean_s > 0.0
                and self.flops > 0.0)


@dataclass
class TimingArtifact:
    """The committed measurement record (provenance + samples)."""

    provenance: Dict[str, object] = field(default_factory=dict)
    records: List[TimingRecord] = field(default_factory=list)
    schema: int = SCHEMA

    def to_json(self) -> str:
        doc = {"schema": self.schema, "provenance": self.provenance,
               "records": [asdict(r) for r in self.records]}
        return json.dumps(doc, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TimingArtifact":
        doc = json.loads(text)
        recs = [TimingRecord(**r) for r in doc.get("records", [])]
        return cls(provenance=doc.get("provenance", {}), records=recs,
                   schema=doc.get("schema", SCHEMA))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "TimingArtifact":
        with open(path) as f:
            return cls.from_json(f.read())


@dataclass(frozen=True)
class CalibrationEntry:
    """Fitted summary of one (key, shape-class)."""

    key: str
    shape_class: str
    n_samples: int
    flops_lo: float
    flops_hi: float
    achieved_flops_per_s: float   # mean measured FLOP/s over the class
    alpha: float                  # fitted 1/(eff MFU): t ≈ α·f/peak + β·b/bw
    beta: float                   # fitted 1/(eff HBM efficiency); 0 if
    #                               the class fit is compute-only
    eff_mfu: float                # 1/alpha, vs the target chip's peak
    eff_hbm: Optional[float]      # 1/beta, or None when beta == 0
    rms_rel_err: float            # fit residual over the class samples


def _fit_class(samples: List[TimingRecord],
               profile: HardwareProfile
               ) -> Tuple[float, float, float]:
    """(alpha, beta, rms_rel_err) of t ≈ α·f/peak + β·b/bw.

    Closed-form normal equations in pure Python — deterministic across
    platforms, which the CI byte-gate on the fitted table relies on.
    Degenerate systems (single sample, collinear terms, non-physical
    negative coefficients) fall back to the compute-only fit ``β = 0``.
    """
    xs = [r.flops / profile.flops for r in samples]
    ys = [r.bytes_accessed / profile.hbm_bw for r in samples]
    ts = [r.t_mean_s for r in samples]
    sxx = sum(x * x for x in xs)
    syy = sum(y * y for y in ys)
    sxy = sum(x * y for x, y in zip(xs, ys))
    sxt = sum(x * t for x, t in zip(xs, ts))
    syt = sum(y * t for y, t in zip(ys, ts))
    det = sxx * syy - sxy * sxy
    alpha = beta = -1.0
    if len(samples) >= 2 and det > 1e-9 * sxx * syy:
        alpha = (sxt * syy - syt * sxy) / det
        beta = (syt * sxx - sxt * sxy) / det
    if alpha <= 0.0 or beta < 0.0:
        alpha, beta = sxt / sxx, 0.0     # compute-only fallback
    err = 0.0
    for x, y, t in zip(xs, ys, ts):
        pred = alpha * x + beta * y
        err += ((pred - t) / t) ** 2
    return alpha, beta, math.sqrt(err / len(ts))


@dataclass(eq=False)
class CalibrationTable:
    """Fitted effective-throughput table (identity-hashable artifact).

    ``entries`` carry the per-(key, shape-class) roofline fit; ``points``
    carry every valid sample's (log2 FLOPs, achieved FLOP/s) for the
    lookup interpolation.  ``eq=False`` keeps the default identity
    ``__hash__`` so the table can sit inside ``lru_cache`` keys and
    frozen param dataclasses.
    """

    target_gpu: str = "h200"
    provenance: Dict[str, object] = field(default_factory=dict)
    entries: List[CalibrationEntry] = field(default_factory=list)
    points: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict)
    schema: int = SCHEMA

    # -- construction -----------------------------------------------------

    @classmethod
    def fit(cls, artifact: TimingArtifact,
            target_gpu: Optional[str] = None) -> "CalibrationTable":
        """Deterministic fit of a measured artifact.

        The same artifact bytes produce the same table on any host
        (pure-Python arithmetic over JSON-round-tripped floats).
        """
        gpu = target_gpu or str(artifact.provenance.get("target_gpu",
                                                        "h200"))
        profile = PROFILES[gpu]
        by_class: Dict[Tuple[str, str], List[TimingRecord]] = {}
        for r in artifact.records:
            if r.valid:
                by_class.setdefault((r.key, r.shape_class), []).append(r)
        entries: List[CalibrationEntry] = []
        pts: Dict[str, Dict[float, List[float]]] = {}
        for (key, shape_class) in sorted(by_class):
            samples = sorted(by_class[(key, shape_class)],
                             key=lambda r: r.flops)
            alpha, beta, err = _fit_class(samples, profile)
            achieved = sum(r.flops / r.t_mean_s
                           for r in samples) / len(samples)
            entries.append(CalibrationEntry(
                key=key, shape_class=shape_class, n_samples=len(samples),
                flops_lo=samples[0].flops, flops_hi=samples[-1].flops,
                achieved_flops_per_s=achieved,
                alpha=alpha, beta=beta,
                eff_mfu=1.0 / alpha,
                eff_hbm=(1.0 / beta) if beta > 0.0 else None,
                rms_rel_err=err))
            for r in samples:
                l2f = math.log2(r.flops)
                pts.setdefault(key, {}).setdefault(l2f, []).append(
                    r.flops / r.t_mean_s)
        points = {key: [(l2f, sum(v) / len(v))
                        for l2f, v in sorted(curve.items())]
                  for key, curve in sorted(pts.items())}
        return cls(target_gpu=gpu, provenance=dict(artifact.provenance),
                   entries=entries, points=points)

    # -- lookup -----------------------------------------------------------

    def keys(self) -> List[str]:
        return sorted(self.points)

    def achieved_flops_per_s(self, key: str, flops: float) -> float:
        """Measured FLOP/s at ``flops``, piecewise log-log interpolated
        over the key's samples and clamped outside the measured range."""
        curve = self.points[key]
        l2f = math.log2(flops)
        if l2f <= curve[0][0]:
            return curve[0][1]
        if l2f >= curve[-1][0]:
            return curve[-1][1]
        i = bisect_left(curve, (l2f, -math.inf))
        (x0, y0), (x1, y1) = curve[i - 1], curve[i]
        w = (l2f - x0) / (x1 - x0)
        return math.exp((1.0 - w) * math.log(y0) + w * math.log(y1))

    def compute_time(self, key: str, flops: float,
                     default: Optional[float] = None,
                     shape_class: Optional[str] = None) -> float:
        """Seconds to execute ``flops`` of phase ``key`` on the measured
        host.  ``shape_class`` (e.g. the canonical config name) prefers
        that class's fitted entry — the per-(kernel, shape-class) model
        the fit exists for; unknown classes fall back to the merged
        per-key curve, and ``default`` (the analytic estimate) covers
        phases the artifact never measured."""
        if key not in self.points or flops <= 0.0:
            if default is None:
                raise KeyError(f"no calibration for phase {key!r}")
            return default
        if shape_class is not None:
            for e in self.entries:
                if e.key == key and e.shape_class == shape_class:
                    return flops / e.achieved_flops_per_s
        return flops / self.achieved_flops_per_s(key, flops)

    def effective_mfu(self, key: str, flops: float,
                      gpu: Optional[str] = None) -> float:
        """Achieved/peak FLOP ratio vs ``gpu`` (default: the fit target)."""
        peak = PROFILES[gpu or self.target_gpu].flops
        return self.achieved_flops_per_s(key, flops) / peak

    def entry(self, key: str, shape_class: str) -> CalibrationEntry:
        for e in self.entries:
            if e.key == key and e.shape_class == shape_class:
                return e
        raise KeyError((key, shape_class))

    # -- serialization ----------------------------------------------------

    def to_json(self) -> str:
        doc = {"schema": self.schema, "target_gpu": self.target_gpu,
               "provenance": self.provenance,
               "entries": [asdict(e) for e in self.entries],
               "points": {k: [[x, y] for x, y in v]
                          for k, v in self.points.items()}}
        return json.dumps(doc, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationTable":
        doc = json.loads(text)
        entries = [CalibrationEntry(**e) for e in doc.get("entries", [])]
        points = {k: [(float(x), float(y)) for x, y in v]
                  for k, v in doc.get("points", {}).items()}
        return cls(target_gpu=doc.get("target_gpu", "h200"),
                   provenance=doc.get("provenance", {}),
                   entries=entries, points=points,
                   schema=doc.get("schema", SCHEMA))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with open(path) as f:
            return cls.from_json(f.read())
