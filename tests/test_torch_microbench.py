"""The port's microbenchmark suite and calibration driver on the CPU (the
plain versions; on the card chip_smoke.py's phase 30 runs it through the
CUDA kernels): records for every kernel class and every phase
configuration, no skip but the JAX package's by-design ones, and failures
that raise instead of becoming records."""
import json

import pytest
import torch

from repro_torch.analysis.calibrate import PHASE_KEYS, CalibrationTable, TimingArtifact
from repro_torch.kernels import ops, ref
from repro_torch.launch import calibrate as launch_calibrate
from repro_torch.profiling import microbench as mb

# the JAX package's by-design skips of a phase record
BY_DESIGN = ("non-positive depth difference", "non-positive step-minus-fwd")


@pytest.fixture(scope="module")
def artifact():
    return mb.run_suite(device="cpu", smoke=True, repeats=1, include_sharded=False)


def test_every_kernel_class_has_valid_records(artifact):
    cases = mb.kernel_cases(smoke=True)
    kernel = [r for r in artifact.records if r.key in ops.COUNTED]
    assert len(kernel) == len(cases)
    assert all(r.valid and r.bytes_accessed > 0 for r in kernel)
    assert {(r.key, r.shape_class) for r in kernel} == {(c.key, c.shape_class) for c in cases}
    assert {c.key for c in cases} == {"flash_attention", "decode_attention", "ssd_scan"}
    assert len({c.shape_class for c in cases if c.key == "flash_attention"}) == 5


def test_phase_records_for_the_three_configs(artifact):
    """Each config has its four per-layer phases; each is valid or a
    by-design skip (a CPU timing of one repeat may come out non-positive),
    and each config has a valid one."""
    phases = [r for r in artifact.records if r.key in PHASE_KEYS]
    for name in mb.DEFAULT_PHASE_CONFIGS:
        mine = [r for r in phases if r.shape_class == name]
        assert sorted(r.key for r in mine) == sorted(PHASE_KEYS), name
        assert all(r.valid or r.skip_reason in BY_DESIGN for r in mine), name
        assert any(r.valid for r in mine), name
        assert all(r.shape["depths"] == [2 * len(_period(name)), 4 * len(_period(name))]
                   for r in mine)


def _period(name):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    return tf.period_spec(get_config(name, smoke=True))


def test_provenance_and_fit(artifact):
    p = artifact.provenance
    assert p["device"] == "cpu" and p["target_gpu"] == "h100" and p["smoke"] is True
    assert p["torch_version"] == torch.__version__ and len(p["kernel_hash"]) == 16
    assert p["launch_counts_after"] == p["launch_counts_before"]  # the CPU launches nothing
    assert set(p["max_tolerance_ratio"]) == {"flash_attention", "decode_attention", "ssd_scan"}
    assert all(r <= 1.0 for r in p["max_tolerance_ratio"].values())
    assert len(p["phase_seconds"]) == 4 * 2 * len(mb.DEFAULT_PHASE_CONFIGS)
    again = TimingArtifact.from_json(artifact.to_json())
    table = CalibrationTable.fit(again)
    assert table.target_gpu == "h100"
    assert {"flash_attention", "decode_attention", "ssd_scan"} <= set(table.keys())
    assert all(e.eff_mfu > 0 for e in table.entries)


def test_a_failing_case_raises():
    def make(device):
        def fn(x):
            raise RuntimeError("planted")
        return fn, (torch.ones(2, device=device),)
    case = mb.BenchCase("flash_attention", "planted", {}, make, lambda x: x,
                        ref.tolerance_ratio)
    with pytest.raises(RuntimeError, match="planted"):
        mb.measure_case(case, "cpu", repeats=1)


def test_a_wrong_output_raises():
    """A planted fault: a flash case of the suite whose output loses its
    last query row must fail the check against the plain version, as
    chip_smoke.py's phase 30 plants it on the card; the case as it is
    passes."""
    case = next(c for c in mb.kernel_cases(smoke=True) if c.key == "flash_attention")
    record, ratio = mb.measure_case(case, "cpu", repeats=1)
    assert record.valid and ratio <= 1.0

    def make(device):
        fn, args = case.make(device)

        def dropped(*a):
            out = fn(*a).clone()
            out[:, -1] = 0.0
            return out
        return dropped, args
    planted = mb.BenchCase(case.key, case.shape_class, case.shape, make, case.plain,
                           case.ratio)
    with pytest.raises(RuntimeError, match="disagrees with the plain version"):
        mb.measure_case(planted, "cpu", repeats=1)


def test_kernel_hash_covers_the_cuda_sources():
    sources = mb.hashed_sources()
    assert {"kernels/csrc/flash_attention.cu", "kernels/csrc/common.cuh",
            "kernels/ops.py", "models/transformer.py", "train/step.py"} <= set(sources)
    assert sources == sorted(sources)
    assert mb.kernel_hash() == mb.kernel_hash()


def test_driver_writes_both_artifacts(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.calibrate --device cpu`` with the suite
    cut to one phase config and no sharded step: the timing artifact and the
    table in the JAX package's formats, and the table printed."""
    real = mb.run_suite

    def small(**kw):
        return real(**kw, phase_configs=("mamba2_370m",), include_sharded=False)
    monkeypatch.setattr(launch_calibrate, "run_suite", small)
    out, tab = tmp_path / "t.json", tmp_path / "tb.json"
    table = launch_calibrate.main(["--device", "cpu", "--repeats", "1", "--out", str(out),
                                   "--table", str(tab)])
    assert json.loads(out.read_text())["provenance"]["target_gpu"] == "h100"
    assert CalibrationTable.load(str(tab)).to_json() == table.to_json()
    printed = capsys.readouterr().out
    assert "fitted effective throughput (target h100)" in printed
    assert all(line in printed for line in launch_calibrate.table_lines(table))


def test_driver_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_calibrate.main(["--repeats", "1"])



# ---- the step phase differentiates one leaf a period (no zero-filled stacks) ----

def _step_phase(depth, stacked=False):
    """(gradients, OpRecord, the leaves differentiated) of the step phase of
    llama3-8b smoke in f32 at B=2 S=256; ``stacked`` takes the gradient
    over the stacked leaves of the same parameters, as the phase did before
    (each period's slice a ``select_backward``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map
    cfg = get_config("llama3_8b", smoke=True).replace(dtype="float32")
    fn, (params, batch) = mb.step_phase(cfg, depth, device="cpu", batch=2, seq=256)
    if stacked:
        params = tree_map(lambda t: t.detach().requires_grad_(),
                          tf.init_lm(cfg.replace(n_layers=depth), seed=0, device="cpu"))
    with mb.OpRecord() as rec:
        grads = fn(params, batch)
    return grads, rec, params


@pytest.mark.parametrize("depth", [2, 4])
def test_step_phase_gradients_equal_the_stacked_leaves(depth):
    """The same gradients as through the stacked leaves, bit for bit (each
    stacked leaf's gradient, split into its periods), and no
    ``select_backward`` among the ops, where the stacked leaves run one a
    period.  Deterministic algorithms: the CPU's embedding backward
    otherwise sums in a thread-dependent order (~2e-9 run to run)."""
    from repro_torch.train.step import split_periods
    from repro_torch.tree import leaves, tree_map
    torch.use_deterministic_algorithms(True)
    try:
        got, rec, _ = _step_phase(depth)
        want, rec_stacked, stacked = _step_phase(depth, stacked=True)
    finally:
        torch.use_deterministic_algorithms(False)
    it = iter(want)
    want_split = leaves(split_periods(tree_map(lambda _: next(it), stacked)))
    assert len(got) == len(want_split) > len(want)
    assert max(float((a - b).abs().max()) for a, b in zip(got, want_split)) == 0.0
    assert rec.ops["aten.select_backward"] == 0
    assert rec_stacked.ops["aten.select_backward"] == len(leaves(stacked["layers"])) * depth


def test_step_phase_allocates_linearly_in_depth():
    """The bytes the step phase allocates grow by the same amount a layer
    from 2 to 4 layers as from 4 to 8 (within half a period's parameter
    bytes); through the stacked leaves each layer adds a zero gradient of
    the whole stack, and the second difference is ~12 periods' bytes."""
    from repro_torch.tree import leaves

    def per_layer(stacked):
        alloc = {}
        for depth in (2, 4, 8):
            _, rec, params = _step_phase(depth, stacked)
            alloc[depth] = rec.allocated
            period = sum(t.numel() * t.element_size() for t in leaves(params["layers"])) / depth
        return (alloc[4] - alloc[2]) / 2, (alloc[8] - alloc[4]) / 4, period
    lo, hi, period = per_layer(False)
    assert abs(hi - lo) < 0.5 * period, (lo, hi, period)
    lo, hi, period = per_layer(True)
    assert hi - lo > 8 * period, (lo, hi, period)
