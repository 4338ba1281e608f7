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
from repro_torch.parallel import sharding as sh


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


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv over the sequence, in f32. xbc [B,S,C], conv_w [W,C].

    The JAX package's sum of shifted slices, not ``F.conv1d`` (which runs
    TF32 through cuDNN on the card by default)."""
    w = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * conv_w[i][None, None, :] for i in range(w))
    return F.silu(out + conv_b[None, None, :])


def ssm_gated(p, x, cfg: ModelConfig, *, h_init=None):
    """The block up to its gated norm: y * silu(z) [B,S,d_inner] in f32, of
    the heads that ``p`` holds (all of them, or one rank's share from
    ``shard_mixer``: their count is a_log's, their groups' w_in's)."""
    s_cfg = cfg.ssm
    pdim, n = s_cfg.head_dim, s_cfg.state_dim
    h = p["a_log"].shape[-1]
    d_inner = h * pdim
    g = (p["w_in"].shape[-1] - 2 * d_inner - h) // (2 * n)
    f32 = torch.float32
    proj = torch.einsum("bsd,de->bse", x, p["w_in"])
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * g * n, h], dim=-1)
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
    return y * F.silu(z.to(f32))


def gated_norm_out(p, v, sum_sq, n: int, eps: float, dtype):
    """The gated RMSNorm of v = y * silu(z) over the whole d_inner (``n``),
    from its sum of squares ``sum_sq`` [B,S,1] over all of it, then w_out
    (this rank's rows of it): [B,S,D], partial where v is a share."""
    y = v * torch.rsqrt(sum_sq / n + eps)
    y = y * (1.0 + p["norm_w"].to(torch.float32))
    return torch.einsum("bse,ed->bsd", y.to(dtype), p["w_out"])


def ssm_apply(p, x, cfg: ModelConfig, *, h_init=None, tp=None):
    """Full-sequence Mamba-2 block (prefill). x [B,S,D] -> [B,S,D].

    tp: the model axis; ``p`` then holds this rank's shards of the leaves
    and the rank runs its share of the SSD heads (``shard_mixer``).  The
    gated norm's sum of squares is summed over the axis (``all_sum``) and
    the partial output leaves through ``reduce``."""
    if tp is not None and tp.active:
        p, split = shard_mixer(p, cfg, tp)
        if not split:
            return ssm_apply(p, x, cfg, h_init=h_init)
        v = ssm_gated(p, tp.copy(x), cfg, h_init=h_init)
        ss = tp.all_sum(v.square().sum(-1, keepdim=True))
        return tp.reduce(gated_norm_out(p, v, ss, ssm_dims(cfg)[0], cfg.norm_eps, x.dtype))
    v = ssm_gated(p, x, cfg, h_init=h_init)
    y = rms_norm(v, p["norm_w"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y.to(x.dtype), p["w_out"])


def mixer_columns(cfg: ModelConfig, size: int, rank: int, device=None) -> dict:
    """The columns of w_in and of the conv channels (w and b), and the rows
    of d_inner (norm_w), that rank ``rank`` of ``size`` reads when the SSD
    heads split over a model axis: its z, x and dt columns and the B/C
    columns of the groups its heads read ({leaf: index tensor})."""
    d_inner, h, pdim, n = ssm_dims(cfg)
    g = cfg.ssm.n_groups
    hl, hpg = h // size, h // g
    if not (hl % hpg == 0 or hpg % hl == 0):
        raise NotImplementedError(f"{cfg.name}: {hl} SSD heads a rank over groups of {hpg}")
    g0, g1 = rank * hl // hpg, ((rank + 1) * hl - 1) // hpg + 1
    ar = lambda lo, hi: torch.arange(lo, hi, device=device)  # noqa: E731
    rows = ar(rank * hl * pdim, (rank + 1) * hl * pdim)
    bc = ar(g0 * n, g1 * n)
    conv = torch.cat([rows, d_inner + bc, d_inner + g * n + bc])
    return {"w_in": torch.cat([rows, d_inner + conv, 2 * d_inner + 2 * g * n
                               + ar(rank * hl, (rank + 1) * hl)]),
            "conv_w": conv, "conv_b": conv, "norm_w": rows}


def shard_mixer(p, cfg: ModelConfig, tp):
    """(leaves, split) of this rank's share of a Mamba-2 block on the model
    axis ``tp``, whose leaves ``p`` are this rank's shards.

    Where the SSD heads split (a_log, dt_bias, d_skip on their heads, w_out
    on its rows), the rank keeps those shards.  w_in and conv_w are stored
    in even column blocks that do not line up with the [z | x | B | C | dt]
    segments, so they are gathered over the axis (``gather_leaf``) and the
    rank takes its z, x and dt columns and the B/C columns of its heads'
    groups (``mixer_columns``), as it does of the replicated conv_b and
    norm_w; each of these enters through ``copy``, so that the partial
    gradients of the columns several ranks read are summed over the axis.
    Where the heads do not split, every sharded leaf is gathered and the
    block runs replicated (split False)."""
    d, (d_inner, h, _, n) = cfg.d_model, ssm_dims(cfg)
    conv_ch = d_inner + 2 * cfg.ssm.n_groups * n
    shapes = {"w_in": (d, 2 * d_inner + 2 * cfg.ssm.n_groups * n + h),
              "conv_w": (cfg.ssm.conv_width, conv_ch), "conv_b": (conv_ch,),
              "w_out": (d_inner, d), "norm_w": (d_inner,), "a_log": (h,), "dt_bias": (h,),
              "d_skip": (h,)}
    split = sh.model_dim("a_log", (h,), tp) == 0
    out = dict(p)
    cols = mixer_columns(cfg, tp.size, tp.rank, p["w_in"].device) if split else {}
    for name, shape in shapes.items():
        td = sh.model_dim(name, shape, tp)
        if name in cols:
            leaf = p[name] if td is None else tp.gather_leaf(p[name], td)
            out[name] = tp.copy(leaf).index_select(leaf.dim() - 1, cols[name])
        elif td is not None and not split:
            out[name] = tp.gather_leaf(p[name], td)
    return out, split


# ---------------------------------------------------------------------------
# decode (recurrent form)
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, device="cuda", tp=None) -> dict:
    """Zero conv window [B, W-1, conv channels] and SSM state [B, H, P, N]
    (f32); on a model axis ``tp`` where the SSD heads split, the channels of
    ``mixer_columns`` and the heads of this rank."""
    s = cfg.ssm
    d_inner, h, pdim, n = ssm_dims(cfg)
    conv_ch = d_inner + 2 * s.n_groups * n
    if tp is not None and tp.active and sh.model_dim("a_log", (h,), tp) == 0:
        conv_ch = mixer_columns(cfg, tp.size, tp.rank)["conv_w"].numel()
        h //= tp.size
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=f32, device=device),
        "state": torch.zeros((batch, h, pdim, n), dtype=f32, device=device),
    }


def ssm_decode(p, x, cache, cfg: ModelConfig, tp=None, rows=None):
    """Single-token recurrent step. x [B,1,D] -> (y [B,1,D], cache).

    The cache is updated in place (the JAX package returns a new one) and
    returned.  tp: the model axis; ``p`` then holds this rank's shards and
    the cache its heads' (``init_ssm_cache``): the rank steps its heads
    (``shard_mixer``), the gated norm's sum of squares is summed over the
    axis (``all_sum``) and the partial output leaves through ``reduce``.
    rows: weight-resident decode over a batch-sharded cache
    (``parallel.resident.Rows``): x is the whole batch's, the cache holds
    this rank's rows, whose outputs are gathered before the gated norm."""
    if tp is not None and tp.active:
        p, split = shard_mixer(p, cfg, tp)
        if not split:
            return ssm_decode(p, x, cache, cfg, rows=rows)
        v = ssm_decode_gated(p, tp.copy(x), cache, cfg, rows)
        ss = tp.all_sum(v.square().sum(-1, keepdim=True))
        return tp.reduce(gated_norm_out(p, v, ss, ssm_dims(cfg)[0], cfg.norm_eps,
                                        x.dtype)), cache
    v = ssm_decode_gated(p, x, cache, cfg, rows)
    y = rms_norm(v, p["norm_w"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y.to(x.dtype), p["w_out"]), cache


def ssm_decode_gated(p, x, cache, cfg: ModelConfig, rows=None):
    """The recurrent step up to the gated norm: y * silu(z) [B,1,d_inner]
    in f32, of the heads that ``p`` holds (their count is a_log's, their
    groups' w_in's, as in ``ssm_gated``); the cache is updated in place.
    ``rows``: the in-projection's rows of this rank's cache are stepped and
    the whole batch's outputs gathered (``ssm_decode``)."""
    pdim, n = cfg.ssm.head_dim, cfg.ssm.state_dim
    h = p["a_log"].shape[-1]
    d_inner = h * pdim
    g = (p["w_in"].shape[-1] - 2 * d_inner - h) // (2 * n)
    f32 = torch.float32
    proj = torch.einsum("bsd,de->bse", x, p["w_in"])[:, 0]  # [B, E]
    if rows is not None:
        proj = rows.local(proj)
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * g * n, h], dim=-1)

    # conv ring: window = [cache, current]
    win = torch.cat([cache["conv"], xbc[:, None, :].to(f32)], dim=1)  # [B, W, C]
    conv_out = F.silu(torch.einsum("bwc,wc->bc", win, p["conv_w"]) + p["conv_b"])

    xin, b_mat, c_mat = torch.split(conv_out, [d_inner, g * n, g * n], dim=-1)
    bsz = proj.shape[0]
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
    y = y.reshape(bsz, 1, d_inner)
    cache["conv"].copy_(win[:, 1:])
    cache["state"].copy_(new_state)
    out = y * F.silu(z.to(f32))[:, None, :]
    return out if rows is None else rows.gather(out)
