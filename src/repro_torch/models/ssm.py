"""Mamba-2 (SSD, state-space duality) blocks (port of ``repro.models.ssm``).

Prefill runs the chunked dual form through ``kernels.ops.ssd``: the plain
``ref.ssd_chunked`` on a CPU tensor, the CUDA kernel ``csrc/ssd_scan.cu`` on
a CUDA one.  (The JAX package's ``ssm_apply`` calls its oracle directly and
leaves the Pallas kernel to ``kernels.ops``; the function is the same.)
Decode uses the O(1) recurrent form carrying (conv_state, ssm_state), in
plain tensor code.

Shapes
  x        [B, S, D]
  d_inner  = expand * D;  H = d_inner / head_dim (SSD heads);  N = state_dim
  ssm head dim P = head_dim;  n_groups G shares B/C projections across heads.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    assert d_inner % s.head_dim == 0, (d_inner, s.head_dim)
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.state_dim


def ssm_init(cfg: ModelConfig, n_periods: int, dtype, gen: torch.Generator, device) -> dict:
    """Stacked mixer leaves [n_periods, ...], in the JAX package's dtypes:
    ``w_in``/``w_out`` in ``dtype``, the conv, decay, skip and norm leaves
    in f32.  Each period's leaves are drawn in turn."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, h, _, n = ssm_dims(cfg)
    conv_ch = d_inner + 2 * s.n_groups * n  # conv runs over (x, B, C) channels
    f32 = torch.float32
    shapes = {  # name: (shape, fan_in, dtype)
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": ((d, 2 * d_inner + 2 * s.n_groups * n + h), d, dtype),
        "conv_w": ((s.conv_width, conv_ch), s.conv_width, f32),
        "w_out": ((d_inner, d), d_inner, dtype),
    }
    out = {name: torch.empty((n_periods,) + shape, dtype=dt, device=device)
           for name, (shape, _, dt) in shapes.items()}
    dt_bias = torch.empty((n_periods, h), dtype=f32, device=device)
    lo, hi = math.log(1e-3), math.log(0.1)
    for p in range(n_periods):
        for name, (shape, fan_in, dt) in shapes.items():
            dense_init(shape, dt, gen, device, in_axis_size=fan_in, out=out[name][p])
        # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 default)
        dt0 = torch.exp(torch.rand((h,), generator=gen, dtype=f32, device=device) * (hi - lo) + lo)
        dt_bias[p] = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    out.update({
        "conv_b": torch.zeros((n_periods, conv_ch), dtype=f32, device=device),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=f32, device=device)).repeat(n_periods, 1),
        "dt_bias": dt_bias,
        "d_skip": torch.ones((n_periods, h), dtype=f32, device=device),
        "norm_w": torch.zeros((n_periods, d_inner), dtype=f32, device=device),
    })
    return out


def _split_proj(proj, cfg: ModelConfig):
    d_inner, h, _, n = ssm_dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * cfg.ssm.n_groups * n, h], dim=-1)


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv over the sequence, in f32. xbc [B,S,C], conv_w [W,C].

    The JAX package's sum of shifted slices, not ``F.conv1d`` (which runs
    TF32 through cuDNN on the card by default)."""
    w = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * conv_w[i][None, None, :] for i in range(w))
    return F.silu(out + conv_b[None, None, :])


def ssm_apply(p, x, cfg: ModelConfig, *, h_init=None):
    """Full-sequence Mamba-2 block (prefill). x [B,S,D] -> [B,S,D]."""
    s_cfg = cfg.ssm
    d_inner, h, pdim, n = ssm_dims(cfg)
    g = s_cfg.n_groups
    f32 = torch.float32
    proj = torch.einsum("bsd,de->bse", x, p["w_in"])
    z, xbc, dt = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc.to(f32), p["conv_w"], p["conv_b"])
    xin, b_mat, c_mat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    bsz, s, _ = x.shape
    xin = xin.reshape(bsz, s, h, pdim)  # views of the conv output: no copies
    b_mat = b_mat.reshape(bsz, s, g, n)
    c_mat = c_mat.reshape(bsz, s, g, n)
    dt = F.softplus(dt.to(f32) + p["dt_bias"][None, None, :])
    a = -torch.exp(p["a_log"])
    # a ragged S goes to ops.ssd as it is: the plain version zero-pads it,
    # the kernel masks it (the JAX package pads here; the result is the same)
    y, _ = ops.ssd(xin, dt, a, b_mat, c_mat, s_cfg.chunk_size, h_init=h_init)
    y = y + p["d_skip"][None, None, :, None] * xin
    y = y.reshape(bsz, s, d_inner)
    y = rms_norm(y * F.silu(z.to(f32)), p["norm_w"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y.to(x.dtype), p["w_out"])


# ---------------------------------------------------------------------------
# decode (recurrent form)
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    s = cfg.ssm
    d_inner, h, pdim, n = ssm_dims(cfg)
    conv_ch = d_inner + 2 * s.n_groups * n
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=f32, device=device),
        "state": torch.zeros((batch, h, pdim, n), dtype=f32, device=device),
    }


def ssm_decode(p, x, cache, cfg: ModelConfig):
    """Single-token recurrent step. x [B,1,D] -> (y [B,1,D], cache).

    The cache is updated in place (the JAX package returns a new one) and
    returned."""
    s_cfg = cfg.ssm
    d_inner, h, pdim, n = ssm_dims(cfg)
    g = s_cfg.n_groups
    f32 = torch.float32
    proj = torch.einsum("bsd,de->bse", x, p["w_in"])[:, 0]  # [B, E]
    z, xbc, dt = _split_proj(proj, cfg)

    # conv ring: window = [cache, current]
    win = torch.cat([cache["conv"], xbc[:, None, :].to(f32)], dim=1)  # [B, W, C]
    conv_out = F.silu(torch.einsum("bwc,wc->bc", win, p["conv_w"]) + p["conv_b"])

    xin, b_mat, c_mat = torch.split(conv_out, [d_inner, g * n, g * n], dim=-1)
    bsz = x.shape[0]
    xin = xin.reshape(bsz, h, pdim)
    b_mat = b_mat.reshape(bsz, g, n).repeat_interleave(h // g, 1)
    c_mat = c_mat.reshape(bsz, g, n).repeat_interleave(h // g, 1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"][None, :])
    a = -torch.exp(p["a_log"])
    dA = torch.exp(dt * a[None, :])  # [B,H]
    # state' = dA * state + dt * x ⊗ B
    new_state = (dA[..., None, None] * cache["state"]
                 + torch.einsum("bh,bhp,bhn->bhpn", dt, xin, b_mat))
    y = torch.einsum("bhn,bhpn->bhp", c_mat, new_state)
    y = y + p["d_skip"][None, :, None] * xin
    y = y.reshape(bsz, d_inner)
    y = rms_norm(y * F.silu(z.to(f32)), p["norm_w"], cfg.norm_eps)
    out = torch.einsum("be,ed->bd", y.to(x.dtype), p["w_out"])[:, None, :]
    cache["conv"].copy_(win[:, 1:])
    cache["state"].copy_(new_state)
    return out, cache
