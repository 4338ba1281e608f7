"""Deterministic synthetic token batches (port of ``repro.train.data``).

The same numpy generator and formula as the JAX package, so both packages
see the same tokens for a (seed, step).  The vlm and audio branches are not
ported (ROADMAP.md, Queue 1: remaining families).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 1234


def synth_batch(cfg: ModelConfig, dc: DataConfig, step: int, device="cuda") -> Dict:
    """Global batch for one step (deterministic in (seed, step))."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(f"{cfg.family} batches are not ported yet "
                                  f"(ROADMAP.md, Queue 1: remaining families)")
    rng = np.random.default_rng(dc.seed * 1_000_003 + step)
    toks = rng.integers(0, cfg.vocab_size, (dc.global_batch, dc.seq_len + 1), dtype=np.int32)
    toks = torch.from_numpy(toks).to(device)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
