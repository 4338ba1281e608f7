"""Analytic per-device HBM traffic model (roofline memory term; a copy of
``repro.analysis.memmodel`` over the port's configurations).

The calibration's phase records take their bytes from here (at tp=1, dp=1,
depth-differenced like the time): the port has no compiled module to read
a byte count from.  Model:

  train:  3x gathered params (fwd read, bwd read, grad write)
          + optimizer sweep over the local shard (p + m + v, r/w)
          + activation traffic: ~R reads/writes of [tokens, d] per sublayer
            (R≈14 covers norms/proj in+out/residuals; x1.5 with full remat)
          + MoE dispatch buffers (2x capacity buffer per moe layer)
  prefill: 1x params + activation traffic (no remat factor)
  decode:  1x params (weights stream once per token)
          + full KV-cache / SSM-state read per layer + small activations
"""
from __future__ import annotations

from repro_torch.analysis.flops import param_count_analytic
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf


def _param_bytes_local(cfg: ModelConfig, tp: int, fsdp: int) -> float:
    return 2.0 * param_count_analytic(cfg) / tp  # bf16, gathered over fsdp


def _act_rw_per_sublayer(cfg: ModelConfig) -> float:
    return 14.0


def traffic_train(cfg: ModelConfig, shape: ShapeConfig, *, tp: int,
                  dp: int) -> float:
    """Per-device HBM bytes for one train step."""
    tokens_dev = shape.global_batch * shape.seq_len / dp
    d = cfg.d_model
    p_loc = _param_bytes_local(cfg, tp, dp)
    params_traffic = 3.0 * p_loc
    opt_traffic = 2.0 * (2.0 + 4.0 + 4.0 + 4.0) * \
        (p_loc / 2.0) / dp * 2.0  # p(bf16)+g(f32)+m+v r/w over the shard
    remat = 1.5 if cfg.remat != "none" else 1.0
    n_sub = cfg.n_layers * (2 if cfg.d_ff > 0 or cfg.moe else 1)
    act = tokens_dev * d * 4.0 * _act_rw_per_sublayer(cfg) * n_sub * remat
    if cfg.moe:
        per = tf.period_spec(cfg)
        n_moe = sum(1 for _, f in per if f == "moe") * tf.n_periods(cfg)
        cap_factor = cfg.moe.top_k * cfg.moe.capacity_factor
        act += tokens_dev * d * 4.0 * 4.0 * cap_factor * n_moe / \
            max(len(per), 1)
    # flash attention KV re-reads: nq passes over K/V per layer
    if cfg.n_heads:
        kv_dim = cfg.n_kv_heads * cfg.resolved_head_dim
        nq = max(1, shape.seq_len // 512)
        att = 2.0 * tokens_dev * kv_dim * 2.0 * nq / tp
        act += att * cfg.n_layers * remat
    return params_traffic + opt_traffic + act


def traffic_prefill(cfg: ModelConfig, shape: ShapeConfig, *, tp: int,
                    dp: int) -> float:
    tokens_dev = shape.global_batch * shape.seq_len / dp
    d = cfg.d_model
    p_loc = _param_bytes_local(cfg, tp, dp)
    n_sub = cfg.n_layers * (2 if cfg.d_ff > 0 or cfg.moe else 1)
    act = tokens_dev * d * 2.0 * _act_rw_per_sublayer(cfg) * n_sub
    if cfg.n_heads:
        kv_dim = cfg.n_kv_heads * cfg.resolved_head_dim
        nq = max(1, shape.seq_len // 512)
        act += 2.0 * tokens_dev * kv_dim * 2.0 * nq / tp * cfg.n_layers
    return p_loc + act


def traffic_decode(cfg: ModelConfig, shape: ShapeConfig, *, tp: int,
                   dp: int) -> float:
    """One decode token: weights once + the whole cache once."""
    p_loc = _param_bytes_local(cfg, tp, dp)
    batch_dev = max(1.0, shape.global_batch / dp)
    cache = 0.0
    per = tf.period_spec(cfg)
    n_per = tf.n_periods(cfg)
    for kind, _ in per:
        if kind == "attn":
            cap = shape.seq_len
            if cfg.sliding_window is not None:
                cap = min(cap, cfg.sliding_window)
            if shape.global_batch < dp:   # context-sharded cache
                cap = cap / dp
                bd = 1.0
            else:
                bd = batch_dev
            kv_dim = cfg.n_kv_heads * cfg.resolved_head_dim / tp
            cache += n_per * bd * cap * kv_dim * 2.0 * 2.0
        else:
            s = cfg.ssm
            d_inner = s.expand * cfg.d_model
            h = d_inner // s.head_dim
            cache += n_per * batch_dev * (h * s.head_dim * s.state_dim / tp
                                          ) * 4.0 * 2.0
    act = batch_dev * cfg.d_model * 4.0 * 10.0 * cfg.n_layers
    return p_loc + cache + act


def traffic_for(cfg: ModelConfig, shape: ShapeConfig, *, tp: int,
                dp: int) -> float:
    if shape.kind == "train":
        return traffic_train(cfg, shape, tp=tp, dp=dp)
    if shape.kind == "prefill":
        return traffic_prefill(cfg, shape, tp=tp, dp=dp)
    return traffic_decode(cfg, shape, tp=tp, dp=dp)
