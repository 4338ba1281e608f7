"""Deterministic synthetic token batches (port of ``repro.train.data``).

The same numpy generator and formula as the JAX package, so both packages
see the same tokens, and the same patches (vlm) or frames (audio), for a
(seed, step).
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
    """Global batch for one step (deterministic in (seed, step)); a VLM's
    "patches" and an encoder-decoder's "frames" [B, n_tokens, d_embed] are
    f32 normal draws from the same generator, after the tokens."""
    rng = np.random.default_rng(dc.seed * 1_000_003 + step)
    toks = rng.integers(0, cfg.vocab_size, (dc.global_batch, dc.seq_len + 1), dtype=np.int32)
    toks = torch.from_numpy(toks).to(device)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    extra = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
    if extra:
        shape = (dc.global_batch, cfg.frontend.n_tokens, cfg.frontend.d_embed)
        batch[extra] = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
    return batch
