"""MODEL_FLOPS calculators: 6·N·D (dense) / 6·N_active·D (MoE) and friends
(a copy of ``repro.analysis.flops`` over the port's configurations).

The analytic side of the calibration's FLOP count: ``analysis.cost`` counts
what the plain versions dispatch, and the tests hold that count's per-layer
slope to this one's.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import padded_vocab
from repro_torch.models.transformer import period_spec


def param_count_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the config (matches init_lm's tree)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    dh = cfg.resolved_head_dim if cfg.n_heads else 0
    vp = padded_vocab(cfg)
    total = vp * d * (1 if cfg.tie_embeddings else 2)
    if cfg.frontend is not None:
        total += cfg.frontend.d_embed * d
    spec = []
    per = period_spec(cfg)
    n_per = L // len(per)
    for kind, ffn in per:
        n = 2 * d  # norms (approx; norm params negligible anyway)
        if kind == "attn":
            n += d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                + cfg.n_heads * dh * d
        else:
            s = cfg.ssm
            d_inner = s.expand * d
            conv_ch = d_inner + 2 * s.n_groups * s.state_dim
            h = d_inner // s.head_dim
            n += d * (2 * d_inner + 2 * s.n_groups * s.state_dim + h) \
                + s.conv_width * conv_ch + 3 * h + d_inner + d_inner * d
        if ffn == "dense":
            n += 3 * d * f
        elif ffn == "moe":
            m = cfg.moe
            de = m.d_expert or f
            experts = m.top_k if active_only else m.n_experts
            n += experts * 3 * d * de + m.n_shared_experts * 3 * d * de
            n += d * m.n_experts  # router
        spec.append(n)
    total += n_per * sum(spec)
    if cfg.encoder is not None:
        e = cfg.encoder
        total += e.n_layers * (e.d_model * (e.d_model // e.n_heads)
                               * (e.n_heads + 2 * e.n_kv_heads)
                               + e.n_heads * (e.d_model // e.n_heads) * e.d_model
                               + 3 * e.d_model * e.d_ff)
        # decoder cross-attention (one per decoder layer)
        total += cfg.n_layers * (d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads)
                                 + cfg.n_heads * dh * d)
    return int(total)


def model_flops_train(cfg: ModelConfig, tokens: int) -> float:
    """6·N·D where N counts ACTIVE params (MoE: routed top-k only)."""
    n_active = param_count_analytic(cfg, active_only=True)
    return 6.0 * n_active * tokens


def model_flops_prefill(cfg: ModelConfig, tokens: int) -> float:
    """Forward-only: 2·N_active·D."""
    return 2.0 * param_count_analytic(cfg, active_only=True) * tokens


def model_flops_decode(cfg: ModelConfig, batch: int, context: int) -> float:
    """One decode token per sequence: 2·N_active·B plus attention reads
    (2·B·ctx·kv_dims per layer) — the KV-cache term dominates memory, not
    FLOPs, so 2·N_active·B is the standard accounting."""
    return 2.0 * param_count_analytic(cfg, active_only=True) * batch
