"""The rest of the port's simulator (``repro_torch.sim``'s traces, network,
costmodel, cluster, serving, planner and ops: copies of the JAX package's
jax-free modules) against the JAX package's.

Two halves.  The reference's own tests of those modules run here against
the port: each reference file's source is read with ``repro.`` taken as
``repro_torch.`` and its tests and fixtures are collected under a prefix
(``test_costmodel.py``, ``test_cluster.py``, ``test_serving.py``,
``test_planner.py``, ``test_ops.py``, the cluster half of
``test_vector_engine.py``, the cost and power ratios of ``test_sim.py`` and
the network hooks of ``test_protocol.py`` and ``test_plane.py``), so every
reference assertion holds the port.  Then both packages take the same
inputs and their records are held equal: the same floats, the same JSON
text for the planner's record, the same digital-twin rows.
"""
import dataclasses
import json
import re
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent

# reference file -> the tests twinned here (None: all of them)
TWINNED = {
    "test_costmodel.py": None,
    "test_cluster.py": None,
    "test_serving.py": None,
    "test_planner.py": None,
    "test_ops.py": None,
    "test_vector_engine.py": ("test_cluster_numbers_are_engine_invariant",
                              "test_cluster_runtime_tenants_depart_at_runtime"),
    "test_sim.py": ("test_cost_power_ratios_near_paper",
                    "test_cost_scales_linearly_with_gpus"),
    "test_protocol.py": ("test_network_backend_g2_rejection",),
    "test_plane.py": ("test_backend_bridge_mirrors_plane_reconfigs",),
}
# the reference's driver-report parity test twinned by hand in
# tests/test_torch_plane.py (its mesh is the JAX driver's)
SKIP = {"test_serving.py": ("test_serve_train_plane_report_parity",)}


def _port_twin(ref_file: str, only):
    """The reference file's tests and fixtures, compiled against the port."""
    path = TESTS / ref_file
    src = re.sub(r"\brepro\.", "repro_torch.", path.read_text())
    mod = types.ModuleType(f"_port_twin_{path.stem}")
    mod.__file__ = str(path)  # the reference's own paths (src/ for subprocesses)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    prefix = path.stem[len("test_"):]
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("test_") and callable(obj):
            if (only is None or name in only) and name not in SKIP.get(ref_file, ()):
                out[f"test_{prefix}__{name[len('test_'):]}"] = obj
        elif hasattr(obj, "_fixture_function_marker") or type(obj).__name__ == \
                "FixtureFunctionDefinition":
            out[name] = obj
    missing = {n for n in only or () if f"test_{prefix}__{n[len('test_'):]}" not in out}
    if missing:
        raise LookupError(f"{ref_file} has no {sorted(missing)}")
    return out


for _ref, _only in TWINNED.items():
    globals().update(_port_twin(_ref, _only))


# ---------------------------------------------------------------------------
# records of the two packages on the same inputs
# ---------------------------------------------------------------------------


def _plain(x):
    """A record as JSON-able plain data, dataclasses unpacked."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "tolist"):
        return x.tolist()
    return x


def _same(a, b):
    """Equal as JSON text (NaN and inf written out): bit for bit in every
    float, since json writes a float's shortest round-trip repr."""
    ja = json.dumps(_plain(a), sort_keys=True, default=repr)
    jb = json.dumps(_plain(b), sort_keys=True, default=repr)
    assert ja == jb


@pytest.mark.parametrize("eps", ["eps_400g", "eps_800g_cpo"])
@pytest.mark.parametrize("n_gpus", [256, 512, 2048, 8192])
def test_costmodel_compare_matches_jax(n_gpus, eps):
    from repro.sim import costmodel as jcm

    from repro_torch.sim import costmodel as pcm
    _same(pcm.compare(n_gpus, 8, eps), jcm.compare(n_gpus, 8, eps))
    _same(pcm.rail_fabric(n_gpus, 8, "ocs"), jcm.rail_fabric(n_gpus, 8, "ocs"))


def test_traces_match_jax():
    from repro.sim import traces as jt

    from repro_torch.sim import traces as pt
    kw = dict(duration_s=40.0, base_rate=8.0, diurnal_amp=0.5, diurnal_period_s=40.0,
              bursts=((10.0, 5.0, 3.0),), seed=11)
    pp, jp = pt.TraceParams(**kw), jt.TraceParams(**kw)
    pr, jr = pt.make_trace(pp), jt.make_trace(jp)
    assert len(pr) > 100
    _same(pr, jr)
    _same(pt.trace_stats(pr, pp, window_s=5.0), jt.trace_stats(jr, jp, window_s=5.0))


def test_exp_trace_and_catalog_match_jax():
    from repro.sim import cluster as jc

    from repro_torch.sim import cluster as pc
    _same(pc.exp_trace(64, 3.0, seed=5), jc.exp_trace(64, 3.0, seed=5))
    ps, js = pc.catalog_jobs(6, 16, mean_gap=2.0), jc.catalog_jobs(6, 16, mean_gap=2.0)
    assert [s.name for s in ps] == [s.name for s in js]
    assert [s.arrival for s in ps] == [s.arrival for s in js]


@pytest.mark.parametrize("policy", ["contiguous", "fragmented"])
def test_simulate_cluster_matches_jax(policy):
    from repro.sim import cluster as jc

    from repro_torch.sim import cluster as pc

    def run(m):
        specs = m.catalog_jobs(6, 16, mean_gap=2.0, seed=3)
        res = m.simulate_cluster(specs, m.ClusterParams(n_ports=48, policy=policy,
                                                        ocs_latency=0.01))
        return res.summary(), res.events
    (ps, pt), (js, jt) = run(pc), run(jc)
    assert ps["n_jobs"] == 6
    _same(ps, js)
    _same(pt, jt)


@pytest.mark.parametrize("backend", ["crossbar_ocs", "packet"])
def test_simulate_fleet_matches_jax(backend):
    from repro.configs.base import get_config as jax_config
    from repro.core.phases import JobConfig as JaxJob
    from repro.sim import serving as js
    from repro.sim.traces import TraceParams as JaxTrace

    from repro_torch.configs.base import get_config
    from repro_torch.core.phases import JobConfig
    from repro_torch.sim import serving as ps
    from repro_torch.sim.traces import TraceParams

    def run(m, cfg, job_cls, trace_cls):
        job = job_cls(model=cfg.replace(n_layers=4), tp=2, fsdp=4, pp=1, global_batch=32,
                      seq_len=2048)
        pre = m.PoolSpec(job, min_replicas=1, max_replicas=3, ref_prompt_tokens=1024)
        dec = m.PoolSpec(job, min_replicas=1, max_replicas=3, batch_slots=4)
        params = m.FleetParams(n_ports=48, backend=backend, ocs_latency=0.005,
                               handoff_interval_s=0.05)
        res = m.simulate_fleet(params, pre, dec, trace_cls(duration_s=6.0, base_rate=4.0,
                                                           seed=2))
        return res.summary(), [dataclasses.astuple(r) for r in res.records]
    p = run(ps, get_config("llama3_8b"), JobConfig, TraceParams)
    j = run(js, jax_config("llama3_8b"), JaxJob, JaxTrace)
    assert p[0]["n_requests"] > 0
    _same(p, j)


def test_planner_record_is_the_jax_json():
    """The planner's "strict JSON and deterministic" record: the same text."""
    from repro.core import fabric as jf
    from repro.sim import planner as jp

    from repro_torch.core import fabric as pf
    from repro_torch.sim import planner as pp

    def small(m, f):
        return m.PlannerConfig(backends=((f.PACKET, None), (f.CROSSBAR_OCS, None),
                                         (f.OCS_ARRAY, 16)),
                               ports_per_rail=(96,), policies=("contiguous",),
                               cluster_jobs=4, cluster_ranks=16,
                               serve_duration_s=6.0, serve_rate=4.0)
    pr = pp.plan(small(pp, pf)).record()
    jr = jp.plan(small(jp, jf)).record()
    assert pr["n_cells"] == 3
    pr.pop("wall_s"), jr.pop("wall_s")  # the one field that is a clock
    assert json.dumps(pr, sort_keys=True, allow_nan=False) == \
        json.dumps(jr, sort_keys=True, allow_nan=False)


def test_headline_points_match_jax():
    """The planner's two scale points, but for their wall clocks."""
    from repro.sim import planner as jp

    from repro_torch.sim import planner as pp
    p, j = pp.headline_points(), jp.headline_points()
    for rec in (p, j):
        for point in rec.values():
            point.pop("wall_s")
    assert p["single_job_100k"]["n_gpus"] == 100_000
    _same(p, j)


def test_ops_scenario_twin_matches_jax():
    """A drain, a tenant's flap storm and defrag over one cluster: the
    digital-twin rows, the summary and the scenario's counters of both
    packages."""
    from repro.configs.base import get_config as jax_config
    from repro.core import faults as jfa
    from repro.core.phases import JobConfig as JaxJob
    from repro.sim import cluster as jc
    from repro.sim import ops as jo

    from repro_torch.configs.base import get_config
    from repro_torch.core import faults as pfa
    from repro_torch.core.phases import JobConfig
    from repro_torch.sim import cluster as pc
    from repro_torch.sim import ops as po

    def run(c, o, fa, cfg, job_cls):
        job = job_cls(model=cfg.replace(n_layers=4), tp=2, fsdp=4, pp=1, global_batch=32,
                      seq_len=2048)
        specs = [c.ClusterJobSpec(f"job{i}", job, arrival=0.5 * i, iterations=6)
                 for i in range(3)]
        ops = o.ScenarioEngine(drains=(o.DrainWindow(start=1.0, duration=3.0, ports=(0, 16),
                                                     migrate=True),),
                               flaps={"job2": fa.FaultModel.flap_storm(3, mean_gap=1.0,
                                                                       seed=4)},
                               defrag=o.DefragPolicy(threshold=0.3))
        res, sim = o.run_scenario(specs, c.ClusterParams(n_ports=32, ocs_latency=0.01),
                                  ops=ops, twin=True)
        return sim.twin(), res.summary(), ops.stats
    p = run(pc, po, pfa, get_config("llama3_8b"), JobConfig)
    j = run(jc, jo, jfa, jax_config("llama3_8b"), JaxJob)
    assert p[2]["n_drain_starts"] == 1
    _same(p, j)


def test_phase_35_pins_the_jax_simulators_numbers():
    """chip_smoke.py phase 35 holds the port's simulator on the card's
    machine to SIM_PINNED: the JAX package's numbers, here, and the port's."""
    import importlib.util
    from types import SimpleNamespace
    spec = importlib.util.spec_from_file_location("chip_smoke", TESTS.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro.configs.base import get_config as jax_config
    from repro.core import phases as jph
    from repro.sim import cluster, costmodel, opus_sim, planner, serving, traces

    from repro_torch.configs.base import get_config
    from repro_torch.core import phases as pph
    from repro_torch.sim import cluster as pc, costmodel as pcm, opus_sim as pos
    from repro_torch.sim import planner as pp, serving as pse, traces as pt
    jax_points = cs.sim_points(SimpleNamespace(
        costmodel=costmodel, opus_sim=opus_sim, planner=planner, cluster=cluster,
        serving=serving, traces=traces, phases=jph, get_config=jax_config))
    port_points = cs.sim_points(SimpleNamespace(
        costmodel=pcm, opus_sim=pos, planner=pp, cluster=pc, serving=pse, traces=pt,
        phases=pph, get_config=get_config))
    assert jax_points == cs.SIM_PINNED
    assert port_points == cs.SIM_PINNED
    assert cs.same_numbers(port_points, cs.SIM_PINNED)
    bad = json.loads(json.dumps(cs.SIM_PINNED))
    bad["cluster"]["makespan"] *= 1 + 1e-9
    assert not cs.same_numbers(bad, cs.SIM_PINNED)
