"""The port's dry-run (``repro_torch.launch.dryrun``): one rank's step on the
meta device over a fake process group, against the JAX package's.

Twin of tests/test_system.py::test_dryrun_cell_in_process (granite-moe-1b-a400m
x train_4k on the mesh (4, 2)): FLOPs and collective bytes > 0, the FLOPs
held to the JAX package's HLO count of the same cell, the rail bytes to a
closed form of the rank's parameter shards.  Then cells of the paper's
meshes (a 2x16x16 decode, a context-sharded long_500k), the memory fit of a
prefill against the attention scores the card's kernels never hold, and the
fake group's life: refused over an existing group, gone after a cell, an
error included.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.fabric import all_reduce_bytes, gather_bytes, scatter_bytes
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tf
from repro_torch.train import step as st
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
GRANITE = ("granite_moe_1b_a400m", "train_4k", {"data": 4, "model": 2})
# The port's FLOPs of the granite cell over the JAX package's, as measured
# on this cell: 7.539e14 / 1.004e15.  The two differ by more than 15 %, and
# the difference has two named sources.  The JAX package's plain blocked
# attention computes every (q, k) block of the square, 4.49e14 FLOPs against
# the port's 2.38e14 over the causal blocks (kernels.ref).  Its tied
# embedding's gradient is a one-hot product, 5.3e13 FLOPs; the port's is an
# index_add, no product.  The rest (MoE experts over their padded capacity,
# the projections, the logits, the remat recompute) agree within 3 %.
GRANITE_FLOP_RATIO = 0.7509


@pytest.fixture(scope="module")
def granite():
    assert not dist.is_initialized()
    rec = dryrun.cell_record(*GRANITE)
    assert not dist.is_initialized()  # the cell's fake group is gone
    return rec


def test_granite_cell_counts_flops_and_bytes(granite):
    """The twin of the reference test: FLOPs and rail and scale-up bytes > 0,
    a memory fit, the h100 roofline and the control plane's record."""
    assert granite["status"] == "ok"
    assert granite["corrected_flops"] > 0
    coll = granite["collectives"]
    assert coll["data"]["_bytes"] > 0 and coll["model"]["_bytes"] > 0
    assert coll["total"]["_bytes"] == coll["data"]["_bytes"] + coll["model"]["_bytes"]
    mem = granite["memory_analysis"]
    assert 0 < mem["argument_size"] < mem["peak_size"]
    rl = granite["roofline"]
    assert granite["profile"] == "h100" and rl["chips"] == 8
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["t_compute"] == pytest.approx(granite["corrected_flops"] / 989e12)
    assert granite["control_plane"]["rail_mapping"]["scale_up_axis"] == "model"
    json.dumps(granite)  # the record is JSON


def test_granite_flops_against_the_jax_hlo_count(granite):
    """The JAX package's corrected HLO FLOPs of the same cell (its dry-run's
    ``input_specs`` compiled on 8 host devices, in a subprocess): the port's
    count over it at the measured ratio within 5 % (its two sources are
    named at GRANITE_FLOP_RATIO)."""
    code = (
        "import os\n"
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'\n"
        "import jax\n"
        "from repro.analysis.hlo_cost import corrected_cost\n"
        "from repro.launch import dryrun\n"
        "mesh = jax.make_mesh((4, 2), ('data', 'model'),\n"
        "                     axis_types=(jax.sharding.AxisType.Auto,) * 2)\n"
        "with jax.set_mesh(mesh):\n"
        "    fn, args = dryrun.input_specs('granite_moe_1b_a400m', 'train_4k', mesh)\n"
        "    text = jax.jit(fn).lower(*args).compile().as_text()\n"
        "print(corrected_cost(text, {'data': 4, 'model': 2}).flops)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    jax_flops = float(out.stdout.strip().splitlines()[-1])
    ratio = granite["corrected_flops"] / jax_flops
    assert ratio == pytest.approx(GRANITE_FLOP_RATIO, rel=0.05), ratio


def test_granite_rail_bytes_follow_the_shards(granite):
    """Rank 0's rail bytes a step, in closed form over its parameter shards:
    each top-level leaf gathered once and its gradient reduce-scattered;
    each period's layer leaves gathered in the forward, again in the
    recompute of remat "full", and reduce-scattered; the gradients of the
    rail-replicated leaves all-reduced."""
    arch, _, axes = GRANITE
    tpl = tf.init_lm(get_config(arch).replace(remat="full"), device="meta")
    rails, m = (axes["data"],), axes["model"]
    fd_tree, td_tree = st.meta_trees(tpl, rails=("data",), n_rails=rails[0], model_size=m)
    want = 0
    for part in range(2):  # the top-level leaves, then the periods' stacks
        trees = [st._split_stacks(t)[part] for t in (tpl, fd_tree, td_tree)]
        for t, fd, td in zip(*(leaves(x) for x in trees)):
            local = t.numel() * t.element_size() // (m if td is not None else 1)
            if fd is None:  # replicated over the rails: the gradient all-reduced
                want += all_reduce_bytes(local // t.element_size(), t.element_size(), rails)
                continue
            shard = local // rails[0] // (t.shape[0] if part else 1)
            gathers = 2 * t.shape[0] if part else 1  # forward and recompute, a period each
            want += gathers * gather_bytes(shard, rails) + \
                (t.shape[0] if part else 1) * scatter_bytes(shard * rails[0], rails)
    assert granite["collectives"]["data"]["_bytes"] == want


def test_multi_pod_decode_cell(tmp_path):
    """A decode cell on the paper's 2x16x16 mesh (512 fake ranks): rail bytes
    on both rail axes, the caches in the fit, status ok; the record on disk."""
    rec = dryrun.run_cell("yi_9b", "decode_32k", multi_pod=True, out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["roofline"]["chips"] == 512
    assert rec["collectives"]["pod"]["_bytes"] > 0 and rec["collectives"]["data"]["_bytes"] > 0
    saved = json.loads((tmp_path / "yi_9b__decode_32k__2x16x16__photonic.json").read_text())
    assert saved["status"] == "ok" and saved["corrected_flops"] == rec["corrected_flops"]
    assert not dist.is_initialized()


def test_long_500k_cell_is_context_sharded(tmp_path):
    """long_500k (one sequence, 524288 slots) context-shards the caches over
    the 16 x 16 mesh's rails, and the CLI exits 0 on its cell."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "h2o_danube_3_4b", "--shape", "long_500k", "--out", str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "h2o_danube_3_4b__long_500k__16x16__photonic.json").read_text())
    assert rec["status"] == "ok"
    assert "[ok] h2o_danube_3_4b__long_500k__16x16__photonic" in out.stdout
    # each rank holds 1/16 of every cache's slots: its caches are 1/16 of the
    # whole batch's (B=1), for the rank's kv heads on the model axis
    cfg = get_config("h2o_danube_3_4b")
    cap = min(SHAPES["long_500k"].seq_len, cfg.sliding_window or math.inf)
    dh = cfg.resolved_head_dim
    kv_local = max(1, cfg.n_kv_heads // 16)
    caches = 2 * cfg.n_layers * (cap // 16) * kv_local * dh * 2
    assert rec["memory_analysis"]["argument_size"] >= caches


def test_prefill_fit_holds_no_attention_scores():
    """The fit counts what the card's kernels allocate: a prefill cell's peak
    lies far below one layer's [B, H, S, S] f32 scores on a rank, which the
    flash kernel never holds (the plain version's blocks are not counted),
    and within a closed form of the rank's inputs, one period's gathered
    leaves and six [B, S, d] f32 activations."""
    cfg = get_config("h2o_danube_3_4b")
    shape = SHAPES["prefill_32k"]
    rec = dryrun.cell_record("h2o_danube_3_4b", "prefill_32k", {"data": 16, "model": 16})
    b, s, d = shape.global_batch // 16, shape.seq_len, cfg.d_model
    scores = b * (cfg.n_heads // 16) * s * s * 4
    peak = rec["memory_analysis"]["peak_size"]
    period = 2 * (tf.param_count(tf.init_lm(cfg, device="meta")) // cfg.n_layers) // 16
    bound = rec["memory_analysis"]["argument_size"] + period + 6 * b * s * d * 4
    assert peak < bound < scores / 2, (peak, bound, scores)


def test_fake_group_refused_over_an_existing_group_and_gone_after_an_error():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group exists"):
            dryrun.cell_record(*GRANITE)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError):  # the step refuses a batch the rails do not divide
        dryrun.cell_record("yi_9b", "long_500k", {"data": 3, "model": 1})
    assert not dist.is_initialized()


def test_live_bytes_counts_outputs_of_kernels_only():
    """Inside a kernel scope the intermediates freed there never count; the
    outputs left alive count at its exit; a freed output leaves the count."""
    live = dryrun.LiveBytes()
    with live:
        x = torch.empty(1000, device="meta")  # 4000 bytes
        with live.kernel():
            tmp = x * 2
            out = tmp + 1
            del tmp
        assert live.live == 8000 and live.peak == 8000
        del out
        assert live.live == 4000
