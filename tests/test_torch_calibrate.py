"""The port's calibration fit, hardware profiles, analytic FLOPs and traffic,
and its FLOP counter, against the JAX package's (twins of
tests/test_calibrate.py's artifact and table tests and of
tests/test_flops_consistency.py's count against the analytic one).

The committed artifact is read, never written.  The port's fit of it is held
to the JAX package's within a relative 1e-12, not byte for byte
(ROADMAP.md, Queue 3: the JAX package's own byte test fails on this host's
float formatting).  The simulator tests wait for the control plane's port.
"""
import dataclasses
import math
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import flops, memmodel
from repro_torch.analysis.calibrate import (PHASE_KEYS, CalibrationTable, TimingArtifact,
                                            TimingRecord)
from repro_torch.analysis.cost import counted_flops, io_bytes
from repro_torch.configs.base import (ASSIGNED_ARCHS, ASSIGNED_SHAPES, PAPER_ARCHS, SHAPES,
                                      get_config, shape_applicable)
from repro_torch.hardware import PROFILES
from repro_torch.models import transformer as tf

BASELINES = Path(__file__).resolve().parent.parent / "benchmarks/baselines"
ARTIFACT = BASELINES / "CALIB_opus_timings.json"
TABLE = BASELINES / "CALIB_opus_table.json"
ARCHS = ASSIGNED_ARCHS + PAPER_ARCHS
CONFIGS = ("llama3_8b", "deepseek_moe_16b", "mamba2_370m")
MESHES = ((1, 1), (4, 8), (8, 64))  # (tp, dp)


def _rec(key, shape_class, flops_, achieved, bytes_accessed=None):
    return TimingRecord(key, shape_class, {}, flops_,
                        bytes_accessed if bytes_accessed is not None else 4.0 * flops_,
                        flops_ / achieved, flops_ / achieved, 3)


def _synth_table():
    """Two-point train_fwd curve: 1e9 FLOP/s at 2^20, 4e9 at 2^30."""
    art = TimingArtifact(provenance={"target_gpu": "h200"}, records=[
        _rec("train_fwd", "tiny", 2.0 ** 20, 1e9),
        _rec("train_fwd", "big", 2.0 ** 30, 4e9),
    ])
    return CalibrationTable.fit(art)


def _close(a, b, rel=1e-12) -> bool:
    if a is None or b is None:
        return a is b
    return a == b or abs(a - b) <= rel * max(abs(a), abs(b))


# -- the fit of the committed artifact ----------------------------------------


def test_fit_of_committed_artifact_matches_jax_fit():
    from repro.analysis.calibrate import CalibrationTable as JaxTable
    from repro.analysis.calibrate import TimingArtifact as JaxArtifact
    got = CalibrationTable.fit(TimingArtifact.load(str(ARTIFACT)))
    want = JaxTable.fit(JaxArtifact.load(str(ARTIFACT)))
    assert got.target_gpu == want.target_gpu and got.provenance == want.provenance
    assert len(got.entries) == len(want.entries) > 0
    for e, w in zip(got.entries, want.entries):
        for f in dataclasses.fields(w):
            a, b = getattr(e, f.name), getattr(w, f.name)
            assert (a == b) if isinstance(b, str) else _close(a, b), (e.key, f.name, a, b)
    assert got.points.keys() == want.points.keys()
    for key, curve in want.points.items():
        assert len(got.points[key]) == len(curve)
        for (x, y), (xw, yw) in zip(got.points[key], curve):
            assert _close(x, xw) and _close(y, yw), key


def test_fit_is_deterministic():
    art = TimingArtifact.load(str(ARTIFACT))
    assert CalibrationTable.fit(art).to_json() == CalibrationTable.fit(art).to_json()


def test_committed_table_covers_all_phase_keys():
    table = CalibrationTable.load(str(TABLE))
    for key in PHASE_KEYS:
        assert key in table.keys(), key


def test_artifact_roundtrip():
    art = TimingArtifact.load(str(ARTIFACT))
    again = TimingArtifact.from_json(art.to_json())
    assert again.to_json() == art.to_json()
    assert any(r.skipped for r in art.records)   # the JAX package's gated sharded step


def test_table_roundtrip():
    table = CalibrationTable.load(str(TABLE))
    again = CalibrationTable.from_json(table.to_json())
    assert again.to_json() == table.to_json()


# -- lookup / interpolation -------------------------------------------------------


def test_interpolation_log_log_midpoint():
    table = _synth_table()
    got = table.achieved_flops_per_s("train_fwd", 2.0 ** 25)
    assert got == pytest.approx(2e9, rel=1e-9)
    assert table.compute_time("train_fwd", 2.0 ** 25) == pytest.approx(2.0 ** 25 / 2e9,
                                                                       rel=1e-9)


def test_lookup_clamps_outside_measured_range():
    table = _synth_table()
    assert table.achieved_flops_per_s("train_fwd", 2.0 ** 10) == pytest.approx(1e9)
    assert table.achieved_flops_per_s("train_fwd", 2.0 ** 50) == pytest.approx(4e9)


def test_compute_time_default_and_missing_key():
    table = _synth_table()
    assert table.compute_time("prefill", 1e9, default=0.125) == 0.125
    assert table.compute_time("train_fwd", 0.0, default=0.5) == 0.5
    with pytest.raises(KeyError):
        table.compute_time("prefill", 1e9)


def test_shape_class_prefers_class_entry():
    table = _synth_table()
    t_class = table.compute_time("train_fwd", 2.0 ** 50, shape_class="tiny")
    assert t_class == pytest.approx(2.0 ** 50 / 1e9, rel=1e-9)
    t_merged = table.compute_time("train_fwd", 2.0 ** 50, shape_class="nonesuch")
    assert t_merged == pytest.approx(2.0 ** 50 / 4e9, rel=1e-9)


def test_single_sample_class_is_compute_only_fit():
    e = _synth_table().entry("train_fwd", "tiny")
    assert e.n_samples == 1
    assert e.beta == 0.0 and e.eff_hbm is None
    assert e.alpha > 0.0 and e.eff_mfu == pytest.approx(1.0 / e.alpha)


@pytest.mark.parametrize("gpu", [None, "h100"])
def test_effective_mfu_is_achieved_over_peak(gpu):
    got = _synth_table().effective_mfu("train_fwd", 2.0 ** 25, gpu)
    assert got == pytest.approx(2e9 / PROFILES[gpu or "h200"].flops, rel=1e-9)


# -- the hardware profiles and the configs' shapes -------------------------------


def test_profiles_are_the_jax_rows_and_an_h100():
    from repro.hardware import PROFILES as JAX_PROFILES
    assert set(PROFILES) == set(JAX_PROFILES) | {"h100"}
    for name, row in JAX_PROFILES.items():
        assert dataclasses.asdict(PROFILES[name]) == dataclasses.asdict(row), name
    h100 = PROFILES["h100"]
    assert (h100.flops, h100.hbm_bw, h100.tdp_w, h100.domain) == (989e12, 3.35e12, 700.0, 8)
    assert (h100.scale_out_gbps, h100.scale_up_gbps) == (400.0, 3600.0)


def test_shapes_match_jax():
    from repro.configs.base import ASSIGNED_SHAPES as JAX_SHAPES
    from repro.configs.base import get_config as jax_config
    from repro.configs.base import shape_applicable as jax_applicable
    assert [dataclasses.asdict(s) for s in ASSIGNED_SHAPES] == \
        [dataclasses.asdict(s) for s in JAX_SHAPES]
    assert set(SHAPES) == {s.name for s in JAX_SHAPES}
    for name in ARCHS:
        for shape, jshape in zip(ASSIGNED_SHAPES, JAX_SHAPES):
            assert shape_applicable(get_config(name), shape) == \
                jax_applicable(jax_config(name), jshape), (name, shape.name)


# -- analytic FLOPs and traffic ---------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_param_count_and_traffic_equal_jax(name, smoke):
    from repro.analysis import flops as jflops
    from repro.analysis import memmodel as jmem
    from repro.configs.base import ASSIGNED_SHAPES as JAX_SHAPES
    from repro.configs.base import get_config as jax_config
    cfg, jcfg = get_config(name, smoke=smoke), jax_config(name, smoke=smoke)
    for active in (False, True):
        assert flops.param_count_analytic(cfg, active) == \
            jflops.param_count_analytic(jcfg, active)
    assert flops.model_flops_train(cfg, 4096) == jflops.model_flops_train(jcfg, 4096)
    assert flops.model_flops_prefill(cfg, 4096) == jflops.model_flops_prefill(jcfg, 4096)
    assert flops.model_flops_decode(cfg, 8, 4096) == jflops.model_flops_decode(jcfg, 8, 4096)
    for shape, jshape in zip(ASSIGNED_SHAPES, JAX_SHAPES):
        if not shape_applicable(cfg, shape)[0]:
            continue
        for tp, dp in MESHES:
            assert memmodel.traffic_for(cfg, shape, tp=tp, dp=dp) == \
                jmem.traffic_for(jcfg, jshape, tp=tp, dp=dp), (shape.name, tp, dp)


# -- the FLOP counter against the analytic count ----------------------------------


def _per_layer_param_flops(cfg, tokens: int) -> float:
    """Forward FLOPs a layer from the analytic parameter count (2 N D),
    depth-differenced at 2 and 4 periods."""
    period = len(tf.period_spec(cfg))
    d1, d2 = 2 * period, 4 * period
    p1 = flops.param_count_analytic(cfg.replace(n_layers=d1), active_only=True)
    p2 = flops.param_count_analytic(cfg.replace(n_layers=d2), active_only=True)
    return 2.0 * (p2 - p1) / (d2 - d1) * tokens


def _per_layer_counted_flops(cfg, bsz: int, seq: int) -> float:
    """Forward FLOPs a layer that the port's ``lm_loss`` dispatches through
    the plain versions, by the same two-depth difference (on the meta
    device: nothing runs)."""
    period = len(tf.period_spec(cfg))
    d1, d2 = 2 * period, 4 * period
    batch = {k: torch.zeros((bsz, seq), dtype=torch.long) for k in ("tokens", "targets")}
    out = {}
    for d in (d1, d2):
        dcfg = cfg.replace(n_layers=d)
        out[d] = counted_flops(lambda p, b, dcfg=dcfg: tf.lm_loss(p, b, dcfg)[0],
                               tf.init_lm(dcfg, device="meta"), batch)
    return (out[d2] - out[d1]) / (d2 - d1)


@pytest.mark.parametrize("name", CONFIGS)
def test_counted_layer_flops_brackets_analytic(name):
    cfg = get_config(name, smoke=True)
    counted = _per_layer_counted_flops(cfg, 2, 256)
    analytic = _per_layer_param_flops(cfg, 2 * 256)
    assert analytic > 0.0
    assert 1.0 <= counted / analytic <= 2.5, (name, counted / analytic)


def test_counted_and_analytic_agree_on_config_ordering():
    counted, analytic = {}, {}
    for name in CONFIGS:
        cfg = get_config(name, smoke=True)
        counted[name] = _per_layer_counted_flops(cfg, 2, 256)
        analytic[name] = _per_layer_param_flops(cfg, 2 * 256)
    assert sorted(CONFIGS, key=counted.get) == sorted(CONFIGS, key=analytic.get)


def test_counted_flops_of_a_product_and_io_bytes():
    a, b = torch.ones(8, 16), torch.ones(16, 4, dtype=torch.bfloat16)
    assert counted_flops(lambda x, y: x @ y.float(), a, b) == 2 * 8 * 16 * 4
    assert io_bytes((a, {"b": [b]}), a[:, :4]) == 8 * 16 * 4 + 16 * 4 * 2 + 8 * 4 * 4


class _OnAnotherDevice:
    device = torch.device("xpu")


def test_meta_routes_to_the_plain_version_and_other_devices_raise():
    from repro_torch.kernels import ops
    q = torch.empty((1, 8, 2, 16), device="meta")
    assert ops.mha(q, q, q).device.type == "meta"
    assert ops.decode_attention(q[:, :1], q, q, torch.ones((1, 8), dtype=torch.bool,
                                                         device="meta")).device.type == "meta"
    with pytest.raises(ValueError, match="no kernel for device"):
        ops._route(_OnAnotherDevice())
    assert math.isfinite(float(ops.mha(*(torch.ones(1, 8, 2, 16),) * 3).sum()))
