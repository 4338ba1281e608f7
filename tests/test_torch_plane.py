"""The port's control plane and simulator (``repro_torch.core``,
``repro_torch.sim``, copies of the JAX package's jax-free modules) and the
drivers' ``--plane-report``, against the JAX package's.

Twins of tests/test_serving.py::test_serve_train_plane_report_parity and of
tests/test_calibrate.py's simulator tests; ``mesh_plane_profile`` on every
assigned architecture and the meshes of the drivers and of the paper;
``simulate`` in its four modes, without a calibration table and with one
that each package fits from the same committed timing artifact; and
chip_smoke.py's pinned numbers of phase 32 (the flat h100 profile, which
the JAX package's table of GPUs lacks: it is given the port's row here).
"""
import dataclasses
import importlib.util
import io
import math
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from repro_torch.analysis.calibrate import CalibrationTable, TimingArtifact
from repro_torch.configs.base import ASSIGNED_ARCHS, get_config
from repro_torch.core import phases as ph
from repro_torch.launch import train as launch_train
from repro_torch.sim import workload as wl_mod
from repro_torch.sim.opus_sim import SimParams, mesh_plane_profile, simulate
from repro_torch.sim.workload import build, build_serving, recalibrate

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "benchmarks/baselines/CALIB_opus_timings.json"
MESHES = {"1x8": {"data": 1, "model": 8}, "4x2": {"data": 4, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MODES = ("native", "oneshot", "opus", "opus_prov")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_mesh(axes: dict):
    """What the JAX driver's ``plane_report`` reads of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.zeros(tuple(axes.values())))


def jax_report(cfg_name: str, axes: dict, batch: int, seq: int, ocs: float, smoke=True):
    """(the JAX driver's printed report, its profile)."""
    from repro.configs.base import get_config as jax_config
    from repro.launch.train import plane_report
    buf = io.StringIO()
    with redirect_stdout(buf):
        p = plane_report(jax_config(cfg_name, smoke=smoke), _jax_mesh(axes), batch, seq, ocs)
    return buf.getvalue(), p


def port_report(cfg_name: str, mesh, batch: int, seq: int, ocs: float, smoke=True):
    buf = io.StringIO()
    with redirect_stdout(buf):
        p = launch_train.plane_report(get_config(cfg_name, smoke=smoke), mesh, batch, seq, ocs)
    return buf.getvalue(), p


def test_serve_train_plane_report_parity():
    """The twin of tests/test_serving.py:389: a TP-only decode mesh reports
    its rail mapping; the report is the profile the serve driver delegates
    to, and a mixed mesh maps its scale-out ways onto rail ports."""
    cfg = get_config("llama3_8b", smoke=True)
    out, p_train = port_report("llama3_8b", launch_train.parse_mesh("1x8"), 64, 512, 0.01)
    assert "rail mapping" in out and "rail-silent" in out
    assert p_train["rail_mapping"] == {
        "scale_up_axis": "model", "scale_up_ways": 8,
        "scale_out_ranks": 1, "ports_per_rail": [0], "rail_silent": True}
    p_serve = mesh_plane_profile(cfg, {"data": 1, "model": 8}, global_batch=64, seq_len=512,
                                 ocs_latency=0.01)
    assert p_serve == p_train
    _, p_mixed = port_report("llama3_8b", launch_train.parse_mesh("4x2"), 64, 512, 0.01)
    rm = p_mixed["rail_mapping"]
    assert rm["scale_out_ranks"] == 4 and rm["ports_per_rail"] == [0, 1, 2, 3]
    assert rm["rail_silent"] is False


@pytest.mark.parametrize("mesh", ["1x8", "4x2", "2x2x2"])
def test_plane_report_prints_the_jax_drivers_lines(mesh):
    """The port's ``plane_report`` prints what the JAX driver's prints for
    the same mesh (a ``parse_mesh`` dict here)."""
    axes = MESHES[mesh]
    want, wp = jax_report("yi_9b", axes, 8, 32, 0.05)
    got, gp = port_report("yi_9b", launch_train.parse_mesh(mesh), 8, 32, 0.05)
    assert got == want and gp == wp
    assert got.startswith("control plane report (TP=")


@pytest.mark.parametrize("ocs", [0.01, 0.1])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_mesh_plane_profile_matches_jax(arch, mesh, ocs):
    """Every key of the profile, exactly, at the full configuration."""
    from repro.configs.base import get_config as jax_config
    from repro.sim.opus_sim import mesh_plane_profile as jax_profile
    kw = dict(global_batch=256, seq_len=4096, ocs_latency=ocs)
    want = jax_profile(jax_config(arch), MESHES[mesh], **kw)
    assert mesh_plane_profile(get_config(arch), MESHES[mesh], **kw) == want


def _job(cfg, **kw):
    shape = dict(tp=4, fsdp=8, pp=1, global_batch=64, seq_len=4096)
    shape.update(kw)
    return ph.JobConfig(model=cfg, **shape)


@pytest.fixture(scope="module")
def tables():
    """(the JAX package's, the port's) fit of the committed artifact."""
    from repro.analysis.calibrate import CalibrationTable as JTable
    from repro.analysis.calibrate import TimingArtifact as JArtifact
    return (JTable.fit(JArtifact.load(str(ARTIFACT))),
            CalibrationTable.fit(TimingArtifact.load(str(ARTIFACT))))


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_simulate_matches_jax(tables, mode, calibrated):
    """One JobConfig (llama3-8b, TP 4 x FSDP 8, PP 2) in each mode: the step
    time and the control plane's counters equal the JAX package's, without
    a table and with each package's own fit."""
    from repro.configs.base import get_config as jax_config
    from repro.core import phases as jph
    from repro.sim.opus_sim import SimParams as JParams
    from repro.sim.opus_sim import simulate as jsimulate
    from repro.sim.workload import build as jbuild
    shape = dict(tp=4, fsdp=8, pp=2, global_batch=64, seq_len=4096)
    ocs = 0.0 if mode in ("native", "oneshot") else 0.01
    jt, pt = tables if calibrated else (None, None)
    want = jsimulate(jbuild(jph.JobConfig(model=jax_config("llama3_8b"), **shape), "h200"),
                     JParams(mode=mode, ocs_latency=ocs, calibration=jt))
    got = simulate(build(ph.JobConfig(model=get_config("llama3_8b"), **shape), "h200"),
                   SimParams(mode=mode, ocs_latency=ocs, calibration=pt))
    assert got.n_reconfigs == want.n_reconfigs and got.n_topo_writes == want.n_topo_writes
    if calibrated:  # the two fits agree within 1e-12 (tests/test_torch_calibrate.py)
        assert got.step_time == pytest.approx(want.step_time, rel=1e-9)
    else:
        assert got.step_time == want.step_time


# ---- twins of tests/test_calibrate.py's simulator tests ----

def test_calibration_none_is_the_analytic_seed():
    job = _job(get_config("llama3_8b"))
    wl, wl_none = build(job, "h200"), build(job, "h200", None)
    assert (wl.t_fwd_layer, wl.t_bwd_layer) == (wl_none.t_fwd_layer, wl_none.t_bwd_layer)
    r0 = simulate(wl, SimParams(mode="opus_prov", ocs_latency=0.01))
    r1 = simulate(wl_none, SimParams(mode="opus_prov", ocs_latency=0.01, calibration=None))
    assert (r1.step_time, r1.n_reconfigs) == (r0.step_time, r0.n_reconfigs)


def test_simparams_calibration_changes_compute_not_counters(tables):
    wl = build(_job(get_config("llama3_8b")), "h200")
    r0 = simulate(wl, SimParams(mode="opus_prov", ocs_latency=0.01))
    rc = simulate(wl, SimParams(mode="opus_prov", ocs_latency=0.01, calibration=tables[1]))
    assert rc.step_time != r0.step_time and rc.n_reconfigs == r0.n_reconfigs


def test_build_with_table_uses_class_entry(tables):
    """The port's table answers the simulator's call sites
    (``compute_time(key, flops, default=, shape_class=)``): the class entry,
    not the default."""
    table, job = tables[1], _job(get_config("llama3_8b"))
    wl = build(job, "h200", table)
    lf = wl.t_fwd_layer * table.entry("train_fwd", "llama3_8b").achieved_flops_per_s
    assert math.isfinite(lf) and lf > 0.0
    assert wl.t_fwd_layer > build(job, "h200").t_fwd_layer
    assert wl.t_fwd_layer == table.compute_time(
        "train_fwd", wl_mod.layer_flops(job.model, 64 // 8 * 4096) / 4, default=-1.0,
        shape_class="llama3_8b")


def test_build_serving_threads_calibration(tables):
    job = _job(get_config("llama3_8b"))
    pa = build_serving(job, "h200", "prefill", prompt_tokens=1024)
    pc = build_serving(job, "h200", "prefill", prompt_tokens=1024, calibration=tables[1])
    assert pc.t_fwd_layer != pa.t_fwd_layer
    assert pc.calibration is tables[1] and pa.calibration is None


def test_recalibrate_identity_and_rebuild(tables):
    table, job = tables[1], _job(get_config("llama3_8b"))
    wl = build(job, "h200")
    assert recalibrate(wl, None) is wl
    wc = recalibrate(wl, table)
    assert wc.calibration is table and wc.t_fwd_layer != wl.t_fwd_layer
    assert recalibrate(wc, table) is wc
    wsc = recalibrate(build_serving(job, "h200", "decode", batch_slots=8), table)
    assert wsc.kind == "decode" and wsc.batch_slots == 8 and wsc.calibration is table


# ---- chip_smoke.py phase 32's pinned numbers ----

def test_phase_32_pins_the_jax_simulators_flat_h100_numbers(monkeypatch):
    """chip_smoke.py's ``PLANE_PINNED`` (llama3-8b on 16x16 and 2x16x16 at
    1, 10, 50 and 100 ms, the flat MFU of the h100 profile) are the JAX
    package's ``mesh_plane_profile`` numbers, given the port's h100 row, and
    the port's."""
    import repro.sim.workload as jwl
    from repro.configs.base import get_config as jax_config
    from repro.sim.opus_sim import mesh_plane_profile as jax_profile
    cs = _chip_smoke()
    h = wl_mod.GPUS["h100"]
    monkeypatch.setitem(jwl.GPUS, "h100", jwl.GPUSpec(**dataclasses.asdict(h)))
    assert set(cs.PLANE_PINNED) == {(m, lat) for m in cs.PLANE_MESHES
                                    for lat in cs.PLANE_LATENCIES}
    for (mesh, lat), pinned in cs.PLANE_PINNED.items():
        kw = dict(global_batch=cs.PLANE_BATCH, seq_len=cs.PLANE_SEQ, gpu="h100",
                  ocs_latency=lat)
        for p in (jax_profile(jax_config(cs.PLANE_ARCH), cs.PLANE_MESHES[mesh], **kw),
                  mesh_plane_profile(get_config(cs.PLANE_ARCH), cs.PLANE_MESHES[mesh], **kw)):
            assert (p["modeled_step_s"], p["overhead_vs_native"], p["n_reconfigs"]) == pinned
