"""The port's training path against the JAX package's, on the CPU.

yi-9b's smoke configuration in f32 on B=8, S=16, as in
tests/test_train_step.py (its FSDP, HSDP, compressed-HSDP, accumulation and
remat variants), and deepseek-moe-16b's (the MoE twin of its
``test_moe_arch_through_distributed_step``).  The reference is ``jax.grad`` of the JAX
package's ``lm_loss`` on its own ``init_lm`` parameters; the port gets the
same parameters through ``bridge.shards_from_numpy`` and trains on four
spawned gloo ranks (``run_ranks`` from test_torch_fabric.py).  Gradients are
compared gathered, per leaf, by relative RMS (f32: the two packages sum in
other orders).  Parameters after a full step are not compared elementwise:
AdamW's first step moves each by about lr * sign(g), and a near-zero
gradient of either sign moves it by 2 lr.
"""
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fabric import init_rank, run_ranks

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tf
from repro_torch.models.layers import cross_entropy
from repro_torch.train import optimizer as topt
from repro_torch.train.data import DataConfig, synth_batch
from repro_torch.train.step import (TrainSetup, compressed_pod_allreduce, ef_init, gather_tree,
                                   make_train_step)
from repro_torch.tree import leaves, tree_map

CFG = get_config("yi_9b", smoke=True).replace(dtype="float32")
MOE_CFG = get_config("deepseek_moe_16b", smoke=True).replace(dtype="float32")
B, S, WORLD = 8, 16, 4
GRAD_RTOL = 1e-4   # per leaf, relative RMS
# (label, mesh shape and axes, TrainSetup fields, config fields)
RUNS = {
    "photonic": ((4,), ("data",), {}, {}),
    "eps": ((4,), ("data",), {"fabric": "eps"}, {}),
    "accum2": ((4,), ("data",), {"accum": 2}, {}),
    "pod2x2": ((2, 2), ("pod", "data"), {}, {}),
    "bidirectional": ((4,), ("data",), {"bidirectional_rings": True}, {}),
    "remat_full": ((4,), ("data",), {}, {"remat": "full"}),
    "remat_dots": ((4,), ("data",), {}, {"remat": "dots"}),
    "hsdp": ((2, 2), ("pod", "data"), {"hsdp": True}, {}),
    "hsdp_compress": ((2, 2), ("pod", "data"), {"hsdp": True, "compress_pod_grads": True}, {}),
}
# the int8 exchange perturbs the gradients: its norm is held to the JAX
# package's tolerance for it (tests/test_train_step.py:60), its gradients to none
EXACT_RUNS = [label for label in RUNS if label != "hsdp_compress"]
GRAD_NORM_RTOL = {"hsdp_compress": 0.02}
# The exchange's direct case: per-pod gradients and error feedback of leaves
# sharded over data along (dim) or replicated (None), f32 and bf16.
EXCHANGE = {"a": ((8, 6), 0, "float32"), "b": ((3, 4), 1, "float32"),
            "c": ((5,), None, "float32"), "d": ((4, 6), 0, "bfloat16")}


def _rel_rms(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def _rank_main(rank, world, store, tmp):
    from torch.distributed.device_mesh import init_device_mesh
    init_rank(rank, world, store)
    ref = dict(np.load(os.path.join(tmp, "params.npz")))
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(tmp, "batch.npz")).items()}
    out = {}
    for label, (shape, axes, kw, cfg_kw) in RUNS.items():
        cfg = CFG.replace(**cfg_kw)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        setup = TrainSetup(cfg=cfg, **kw)
        step = make_train_step(setup, mesh, tf.init_lm(cfg, device="meta"))
        fab = step.fabric
        params = bridge.shards_from_numpy(ref, fab.axis_index(), fab.n_shards, "cpu", "float32")
        grads, _ = step.pod_sync(step.grads_fn(params, batch)[0], ef_init(setup, params))
        for path, g in bridge.to_numpy(gather_tree(grads, step.fd_tree, fab)).items():
            out[f"{label}/grad/{path}"] = g
        opt = topt.adamw_init(params)
        _, _, ef, m = step(params, opt, ef_init(setup, params), batch)
        out[f"{label}/loss"], out[f"{label}/grad_norm"] = float(m["loss"]), float(m["grad_norm"])
        out[f"{label}/ef_abs_sum"] = sum(float(e.abs().sum()) for e in leaves(ef))
        # the updated shards, gathered back to global arrays
        for path, p in bridge.to_numpy(gather_tree(params, step.fd_tree, fab)).items():
            out[f"{label}/param/{path}"] = p
    # MoE: each rank's aux loss is over its own rows, so the step's objective
    # is the mean over ranks of lm_loss on each rank's rows
    moe_ref = dict(np.load(os.path.join(tmp, "moe_params.npz")))
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    step = make_train_step(TrainSetup(cfg=MOE_CFG), mesh, tf.init_lm(MOE_CFG, device="meta"))
    fab = step.fabric
    params = bridge.shards_from_numpy(moe_ref, fab.axis_index(), fab.n_shards, "cpu", "float32")
    grads, _ = step.grads_fn(params, batch)
    for path, g in bridge.to_numpy(gather_tree(grads, step.fd_tree, fab)).items():
        out[f"moe/grad/{path}"] = g
    _, _, _, m = step(params, topt.adamw_init(params), {}, batch)
    out["moe/loss"] = float(m["loss"])
    # the loss over 8 steps on one fixed batch (tests/test_train_step.py)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    setup = TrainSetup(cfg=CFG, opt=topt.OptConfig(lr=3e-3, warmup_steps=2))
    step = make_train_step(setup, mesh, tf.init_lm(CFG, device="meta"))
    params = bridge.shards_from_numpy(ref, step.fabric.axis_index(), 4, "cpu", "float32")
    opt = topt.adamw_init(params)
    fixed = synth_batch(CFG, DataConfig(seq_len=S, global_batch=B), 0, device="cpu")
    losses = []
    for _ in range(8):
        params, opt, _, m = step(params, opt, {}, fixed)
        losses.append(float(m["loss"]))
    out["losses"] = np.array(losses)
    out.update(_exchange_rank())
    # the driver on a model axis of two: tensor and expert parallelism
    printed = io.StringIO()
    with redirect_stdout(printed):
        loss = launch_train.main(["--arch", "yi_9b", "--smoke", "--device", "cpu", "--mesh",
                                  "2x2", "--steps", "2", "--batch", "4", "--seq", "16",
                                  "--plane-report"])
    losses, reports = [None] * world, [None] * world
    dist.all_gather_object(losses, loss)
    dist.all_gather_object(reports, printed.getvalue())
    out["main_2x2/losses"] = np.array(losses)
    out["main_2x2/printed"] = np.array(reports)
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), **out)
    dist.destroy_process_group()


def _exchange_inputs():
    """Per-pod gradients [2, ...] and error feedback [2, ...] of each leaf."""
    rng = np.random.default_rng(7)
    g = {k: (rng.standard_normal((2,) + shape) * 10.0 ** rng.integers(-3, 2, (2,) + shape)
             ).astype(np.float32) for k, (shape, _, _) in EXCHANGE.items()}
    e = {k: (rng.standard_normal((2,) + shape) * 1e-3).astype(np.float32)
         for k, (shape, _, _) in EXCHANGE.items()}
    # bf16 gradients: their values rounded to bf16
    g["d"] = torch.from_numpy(g["d"]).to(torch.bfloat16).float().numpy()
    return g, e


def _exchange_rank():
    """The port's int8 exchange on mesh (pod 2, data 2): this rank's data
    shard of its pod's leaves; returns the summed gradients and the new
    error feedback gathered over data, and each pod's error feedback."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.fabric import Fabric
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    fab, pod_fab = Fabric.from_mesh(mesh, ("data",)), Fabric.from_mesh(mesh, ("pod",))
    pod, data = pod_fab.axis_index(), fab.axis_index()
    g, e = _exchange_inputs()

    def shard(x, fd):
        t = torch.from_numpy(x[pod].copy())
        return t if fd is None else t.chunk(2, fd)[data].contiguous()
    grads = {k: shard(g[k], fd).to(getattr(torch, dt)) for k, (_, fd, dt) in EXCHANGE.items()}
    ef = {k: shard(e[k], fd) for k, (_, fd, _) in EXCHANGE.items()}
    summed = compressed_pod_allreduce(grads, ef, fab, pod_fab)
    out = {}
    for k, (_, fd, _) in EXCHANGE.items():
        whole = (lambda t: t) if fd is None else (lambda t: fab.all_gather(t, fd))  # noqa: E731
        out[f"exchange/sum/{k}"] = whole(summed[k]).float().numpy()
        out[f"exchange/ef/{k}"] = pod_fab.all_gather(whole(ef[k])[None], 0).numpy()
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX package's parameters, batch, loss, gradients and norm."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_config
    from repro.models import transformer as T
    from repro.parallel.sharding import _path_str

    cfg = jax_config("yi_9b", smoke=True).replace(dtype="float32")
    rng = jax.random.PRNGKey(0)
    params = T.init_lm(rng, cfg)
    batch = {"tokens": jax.random.randint(rng, (B, S), 0, cfg.vocab_size, jnp.int32),
             "targets": jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size,
                                           jnp.int32)}
    (loss, _), g = jax.value_and_grad(lambda p: T.lm_loss(p, batch, cfg), has_aux=True)(params)
    flat = lambda t: {_path_str(p): np.asarray(x)  # noqa: E731
                      for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
    grads = flat(g)
    gn = float(np.sqrt(sum(np.sum(np.square(x, dtype=np.float64)) for x in grads.values())))
    return {"params": flat(params), "batch": {k: np.asarray(v) for k, v in batch.items()},
            "loss": float(loss), "grads": grads, "grad_norm": gn, "cfg": cfg}


@pytest.fixture(scope="module")
def moe_reference(reference):
    """deepseek-moe-16b's smoke parameters; the loss on one device; and the
    gradients of the distributed step's exact objective, (1/n_dp) times the
    sum over ranks of ``lm_loss`` on each rank's rows, and its value."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_config
    from repro.models import transformer as T
    from repro.parallel.sharding import _path_str

    cfg = jax_config("deepseek_moe_16b", smoke=True).replace(dtype="float32")
    params = T.init_lm(jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(v) for k, v in reference["batch"].items()}
    rows = B // WORLD

    def objective(p):
        return sum(T.lm_loss(p, {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()},
                             cfg)[0] for r in range(WORLD)) / WORLD
    value, g = jax.value_and_grad(objective)(params)
    flat = lambda t: {_path_str(p): np.asarray(x)  # noqa: E731
                      for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
    return {"params": flat(params), "grads": flat(g), "objective": float(value),
            "loss": float(T.lm_loss(params, batch, cfg)[0])}


@pytest.fixture(scope="module")
def port(reference, moe_reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    np.savez(tmp / "params.npz", **reference["params"])
    np.savez(tmp / "moe_params.npz", **moe_reference["params"])
    np.savez(tmp / "batch.npz", **reference["batch"])
    run_ranks(_rank_main, WORLD, tmp, str(tmp))
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("label", EXACT_RUNS)
def test_gradients_match_jax(reference, port, label):
    """The gradients after every collective of the step (under HSDP, the
    pod AllReduce too)."""
    for path, want in reference["grads"].items():
        assert _rel_rms(port[f"{label}/grad/{path}"], want) <= GRAD_RTOL, path


@pytest.mark.parametrize("label", list(RUNS))
def test_loss_and_grad_norm_match_jax(reference, port, label):
    assert abs(float(port[f"{label}/loss"]) - reference["loss"]) < 1e-4
    gn = float(port[f"{label}/grad_norm"])
    assert abs(gn - reference["grad_norm"]) / reference["grad_norm"] < \
        GRAD_NORM_RTOL.get(label, 1e-3)


def test_error_feedback_accumulates(port):
    """The twin of tests/test_train_step.py::test_error_feedback_accumulates:
    after one compressed step the error feedback holds the quantization
    residue; without compression there is none."""
    assert port["hsdp_compress/ef_abs_sum"] > 0
    assert port["hsdp/ef_abs_sum"] == 0


@pytest.fixture(scope="module")
def exchange_reference():
    """``repro.train.step.compressed_pod_allreduce`` under ``shard_map`` on a
    two-pod CPU mesh, each pod with its whole leaves: (summed [2, ...], new
    error feedback [2, ...])."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.core.fabric import Fabric as JFabric
    from repro.train.step import compressed_pod_allreduce as jax_exchange
    g, e = _exchange_inputs()
    jg = {k: jnp.asarray(v, dtype=EXCHANGE[k][2]) for k, v in g.items()}
    mesh = Mesh(np.array(jax.devices()[:2]), ("pod",))
    pod_fab = JFabric(("pod",), (2,), "photonic")
    one = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)  # noqa: E731
    stack = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)  # noqa: E731

    def per_pod(gs, es):
        summed, new_e = jax_exchange(one(gs), one(es), pod_fab)
        return stack(summed), stack(new_e)
    summed, new_e = jax.jit(jax.shard_map(per_pod, mesh=mesh, in_specs=(P("pod"), P("pod")),
                                          out_specs=(P("pod"), P("pod")), check_vma=False))(
        jg, {k: jnp.asarray(v) for k, v in e.items()})
    return ({k: np.asarray(v.astype(jnp.float32)) for k, v in summed.items()},
            {k: np.asarray(v) for k, v in new_e.items()})


@pytest.mark.parametrize("leaf", list(EXCHANGE))
def test_compressed_exchange_matches_jax(port, exchange_reference, leaf):
    """Each pod's int8 codes equal the JAX package's (read back from each
    side's error feedback: q = round((x - ef') / scale), with x = g + ef and
    scale = max|x| / 127 over the whole leaf, data shards included); the sum
    and the new error feedback agree to f32 rounding: one ulp of the largest
    |x| (XLA may contract x - q * scale into one FMA), bf16 sums one ulp."""
    want_sum, want_ef = exchange_reference
    g, e = _exchange_inputs()
    x = g[leaf].astype(np.float32) + e[leaf]
    scale = np.abs(x.reshape(2, -1)).max(1).reshape((2,) + (1,) * (x.ndim - 1)) / np.float32(127)
    got_ef = port[f"exchange/ef/{leaf}"]
    codes = lambda ef: np.rint((x - ef) / scale)  # noqa: E731
    np.testing.assert_array_equal(codes(got_ef), codes(want_ef[leaf]))
    assert np.abs(codes(got_ef)).max() == 127
    ulp = float(np.abs(x).max()) * 2 ** -23
    np.testing.assert_allclose(got_ef, want_ef[leaf], rtol=0, atol=ulp)
    got_sum = port[f"exchange/sum/{leaf}"]
    for pod in range(2):
        rtol = 2 ** -8 if EXCHANGE[leaf][2] == "bfloat16" else 0
        np.testing.assert_allclose(got_sum, want_sum[leaf][pod], rtol=rtol, atol=2 * ulp)


def test_moe_gradients_match_jax_distributed_objective(moe_reference, port):
    """Per leaf, the router and the experts included: each rank's aux loss
    is over its own rows, which the objective reproduces exactly."""
    for path, want in moe_reference["grads"].items():
        assert _rel_rms(port[f"moe/grad/{path}"], want) <= GRAD_RTOL, path


def test_moe_loss_matches_jax(moe_reference, port):
    """The step's loss is the objective's value; against the loss on one
    device (aux over all rows, a nonlinear partition of the same quantity)
    it is held within 1e-2, as tests/test_train_step.py holds the JAX step."""
    assert abs(port["moe/loss"] - moe_reference["objective"]) < 1e-4
    assert abs(port["moe/loss"] - moe_reference["loss"]) < 1e-2


def test_moe_leaf_specs_match_jax(moe_reference):
    """The stacked [np, E, d, de] expert leaves, the router and the shared
    experts get the JAX package's FSDP and TP dims."""
    from repro.parallel import sharding as jsh

    from repro_torch.parallel import sharding
    for path, arr in moe_reference["params"].items():
        kw = dict(n_rails=4, rail_axes=("data",), model_size=1,
                  stacked=path.startswith("layers"))
        assert sharding.leaf_spec(path, arr.shape, **kw)[1:] == \
            jsh.leaf_spec(path, arr.shape, **kw)[1:], path
    assert {p for p in moe_reference["params"] if "/ffn/" in p} >= {
        "layers/0/ffn/router", "layers/0/ffn/w_gate", "layers/0/ffn/shared/w_down"}


def test_step_updates_every_leaf_and_keeps_shapes(reference, port):
    for path, p0 in reference["params"].items():
        p1 = port[f"photonic/param/{path}"]
        assert p1.shape == p0.shape and np.isfinite(p1).all()
        assert not np.array_equal(p1, p0), path


def test_loss_falls_over_8_steps(port):
    losses = port["losses"]
    assert losses[-1] < losses[0] - 0.2, losses


def test_cross_entropy_matches_jax():
    import jax.numpy as jnp

    from repro.models.layers import cross_entropy as jax_ce
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 5, 768)) * 3).astype(np.float32)  # vocab padded to 768
    targets = rng.integers(0, 700, (2, 5)).astype(np.int32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), 700)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(targets), 700)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


@pytest.mark.parametrize("arch,seq", [
    pytest.param("yi_9b", S, id=str(S)), pytest.param("yi_9b", 1024, id="1024"),
    # GeGLU, tied embeddings (the unembedding's gradient adds to the embedding's)
    # and a head dim (32) that is not d_model / heads (16)
    pytest.param("gemma_7b", S, id=f"gemma_7b-{S}"),
    pytest.param("gemma_7b", 1024, id="gemma_7b-1024"),
    # the Mamba-2 scan's gradient through the port's ``ops.ssd`` autograd
    # function: S over five chunks of 8, and a ragged S
    pytest.param("mamba2_370m", 40, id="mamba2_370m-40"),
    pytest.param("mamba2_370m", 37, id="mamba2_370m-37")])
def test_lm_loss_and_its_gradient_match_jax(reference, arch, seq):
    """One device, no fabric.  At S=1024 attention takes the flash path: the
    port's ``ops.mha`` autograd function (``ref.mha_bwd`` on the CPU) against
    the JAX package's custom VJP; mamba2-370m's scan goes through ``ops.ssd``'s
    (``ref.ssd_chunked_bwd``) against ``jax.grad`` through the oracle."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_config
    from repro.models import transformer as T
    from repro.parallel.sharding import _path_str
    cfg = jax_config(arch, smoke=True).replace(dtype="float32")
    if arch == "yi_9b" and seq == S:
        batch = reference["batch"]
    else:
        rng = np.random.default_rng(4)
        rows = B if seq in (S, 40, 37) else 1
        batch = {k: rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
                 for k in ("tokens", "targets")}
    jparams = jax.tree_util.tree_map(jnp.asarray, T.init_lm(jax.random.PRNGKey(0), cfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jg = jax.value_and_grad(lambda p: T.lm_loss(p, jb, cfg), has_aux=True)(jparams)
    flat = {_path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    params = bridge.from_numpy(flat, "cpu", "float32")
    for t in leaves(params):
        t.requires_grad_()
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, m = tf.lm_loss(params, tbatch, get_config(arch, smoke=True).replace(dtype="float32"))
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-4
    assert abs(m["ce"].item() - float(jm["ce"])) < 1e-4
    grads = bridge.to_numpy(tree_map(lambda t: t.grad, params))
    for p, w in jax.tree_util.tree_flatten_with_path(jg)[0]:
        assert _rel_rms(grads[_path_str(p)], np.asarray(w)) <= GRAD_RTOL, _path_str(p)


def test_adamw_matches_jax(reference):
    """Both optimizers on the same numpy gradients, two steps (the second
    with a clipped norm), f32."""
    import jax.numpy as jnp

    from repro.train import optimizer as jopt
    from repro.train.optimizer import OptConfig as JOptConfig
    rng = np.random.default_rng(5)
    jcfg, cfg = JOptConfig(warmup_steps=2), topt.OptConfig(warmup_steps=2)
    jparams = {k: jnp.asarray(v) for k, v in reference["params"].items()}
    params = bridge.from_numpy(reference["params"], "cpu", "float32")
    flat = bridge.flatten(params)
    jstate, state = jopt.adamw_init(jparams), topt.adamw_init(params)
    for scale in (0.01, 10.0):
        g = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
             for k, v in reference["params"].items()}
        jparams, jstate, jm = jopt.adamw_update(jparams, {k: jnp.asarray(v) for k, v in g.items()},
                                               jstate, jcfg)
        _, state, m = topt.adamw_update(params, bridge.from_numpy(g, "cpu"), state, cfg)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    mflat, vflat = bridge.flatten(state["m"]), bridge.flatten(state["v"])
    for k in reference["params"]:
        np.testing.assert_allclose(flat[k].numpy(), np.asarray(jparams[k]), atol=1e-6)
        np.testing.assert_allclose(mflat[k].numpy(), np.asarray(jstate["m"][k]), atol=1e-6)
        np.testing.assert_allclose(vflat[k].numpy(), np.asarray(jstate["v"][k]), atol=1e-6,
                                   rtol=1e-6)


def test_synth_batch_matches_jax():
    from repro.configs.base import get_config as jax_config
    from repro.train.data import DataConfig as JDataConfig
    from repro.train.data import synth_batch as jax_synth
    jcfg = jax_config("yi_9b", smoke=True)
    for step in (0, 7):
        got = synth_batch(CFG, DataConfig(seq_len=S, global_batch=B), step, device="cpu")
        want = jax_synth(jcfg, JDataConfig(seq_len=S, global_batch=B), step)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_shards_round_trip_through_the_bridge(reference):
    """Global arrays -> each rank's shards -> concatenated back: the shards
    tile the global arrays."""
    from repro_torch.parallel import sharding
    ref = reference["params"]
    shards = [bridge.to_numpy(bridge.shards_from_numpy(ref, i, 4, "cpu")) for i in range(4)]
    for path, arr in ref.items():
        stacked = path.startswith("layers")
        _, fd, _ = sharding.leaf_spec(path, arr.shape, n_rails=4, rail_axes=("data",),
                                      model_size=1, stacked=stacked)
        if fd is None:
            assert all(np.array_equal(s[path], arr) for s in shards)
        else:
            np.testing.assert_array_equal(np.concatenate([s[path] for s in shards], fd), arr)


def test_train_main_runs_on_cpu(capsys, monkeypatch):
    """``main`` trains, and ``--lr`` reaches the optimizer's config."""
    seen = []
    make = launch_train.make_train_step

    def recording(setup, *a, **kw):
        seen.append(setup.opt)
        return make(setup, *a, **kw)
    monkeypatch.setattr(launch_train, "make_train_step", recording)
    try:
        loss = launch_train.main(["--arch", "yi_9b", "--smoke", "--device", "cpu", "--steps",
                                  "2", "--batch", "4", "--seq", "16", "--lr", "1e-3"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert np.isfinite(loss)
    assert "step    1 loss" in capsys.readouterr().out
    assert [(o.lr, o.warmup_steps) for o in seen] == [(1e-3, 10)]


def test_train_main_trains_mamba_on_cpu(capsys):
    """``launch.train.main`` trains mamba2-370m's smoke configuration (gradients through
    ``ops.ssd``'s autograd function) and its loss falls over 20 steps."""
    try:
        launch_train.main(["--arch", "mamba2_370m", "--smoke", "--device", "cpu", "--steps",
                           "20", "--batch", "8", "--seq", "32", "--lr", "1e-2"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    losses = [float(line.split()[3]) for line in capsys.readouterr().out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 5 and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] - 0.05, losses


def _main(argv, capsys) -> tuple:
    """``launch.train.main`` on one gloo process: (its loss, its stdout)."""
    try:
        loss = launch_train.main(["--device", "cpu", "--batch", "4", "--seq", "16", *argv])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return loss, capsys.readouterr().out


def test_train_main_resumes_from_its_checkpoint(tmp_path, capsys, monkeypatch):
    """4 steps straight against 2 steps with ``--ckpt`` and ``--resume`` to 4:
    the same final loss (the restored state is exact, and the data replays
    by step).  ``--ckpt-every`` saves at the steps it names, and at the end."""
    arch = ["--arch", "yi_9b", "--smoke"]
    straight, _ = _main(arch + ["--steps", "4"], capsys)
    saved = []
    save = launch_train.ckpt.save

    def recording(d, *a, extra, **kw):
        saved.append(extra["step"])
        return save(d, *a, extra=extra, **kw)
    monkeypatch.setattr(launch_train.ckpt, "save", recording)
    ck = str(tmp_path / "ck")
    _, out = _main(arch + ["--steps", "2", "--ckpt", ck, "--ckpt-every", "1"], capsys)
    assert saved == [1, 2, 2] and "checkpointed @ 1" in out and "checkpointed @ 2" in out
    resumed, out = _main(arch + ["--steps", "4", "--ckpt", ck, "--resume"], capsys)
    assert "resumed from step 2" in out and saved[-1] == 4
    assert resumed == straight
    assert not os.path.exists(ck + ".tmp")


def test_train_main_runs_hsdp_with_compression(capsys):
    """``--hsdp --compress`` on a pod axis of one: the exchange quantizes (as
    the JAX package's does at one pod), so the first step's norm and from the
    second step on the loss leave the uncompressed run's; the first loss is
    the same."""
    arch = ["--arch", "yi_9b", "--smoke", "--steps", "2"]
    plain, out_plain = _main(arch + ["--mesh", "1x1x1"], capsys)
    packed, out = _main(arch + ["--mesh", "1x1x1", "--hsdp", "--compress"], capsys)
    first, first_plain = out.splitlines()[0], out_plain.splitlines()[0]
    assert first.split("gnorm")[0] == first_plain.split("gnorm")[0]
    assert first.split("gnorm")[1] != first_plain.split("gnorm")[1]
    assert np.isfinite(packed) and packed != plain


@pytest.mark.parametrize("flags,word", [(["--plane-report"], "control plane report"),
                                        (["--mesh", "2x0"], "DxM or PxDxM"),
                                        (["--mesh", "4x1"], "needs 4 processes"),
                                        (["--plane-report", "--ocs-latency", "0.01"],
                                         "OCS 10 ms")])
def test_train_main_refuses_unported_options(flags, word, capsys):
    """A mesh the driver cannot form is refused; ``--plane-report`` and
    ``--ocs-latency``, refused until the control plane was ported, now print
    the JAX driver's report of the job after training (one process, mesh
    1x1)."""
    argv = ["--arch", "yi_9b", "--smoke", "--device", "cpu", *flags]
    plane = "--plane-report" in flags
    try:
        if plane:
            launch_train.main(argv + ["--steps", "1", "--batch", "2", "--seq", "8"])
        else:
            with pytest.raises((SystemExit, ValueError)) as e:
                launch_train.main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    cap = capsys.readouterr()
    if not plane:
        assert word in cap.err + str(e.value)
        return
    from test_torch_plane import jax_report
    ocs = float(flags[-1]) if "--ocs-latency" in flags else 0.05
    want, _ = jax_report("yi_9b", {"data": 1, "model": 1}, 2, 8, ocs)
    assert word in cap.out and cap.out.endswith(want)


@pytest.mark.parametrize("mesh,axes", [("2x2", {"data": 2, "model": 2}),
                                       ("1x2x2", {"pod": 1, "data": 2, "model": 2})])
def test_model_axis_meshes_parse(mesh, axes):
    """A model axis (tensor and expert parallelism) parses to its dim."""
    assert launch_train.parse_mesh(mesh) == axes


def test_train_main_trains_on_a_model_axis(port):
    """``launch.train.main --mesh 2x2`` on the four gloo ranks: data 2 x
    model 2, two steps; every rank reports the same loss."""
    losses = port["main_2x2/losses"]
    assert np.isfinite(losses).all() and len(set(losses.tolist())) == 1, losses


def test_train_main_plane_report_on_4_ranks(port):
    """``--plane-report`` under the four gloo ranks of ``--mesh 2x2``: rank
    0 prints the report that the JAX driver's ``plane_report`` prints for
    the same mesh and job; the other ranks print none."""
    from test_torch_plane import jax_report
    printed = [str(x) for x in port["main_2x2/printed"]]
    want, _ = jax_report("yi_9b", {"data": 2, "model": 2}, 4, 16, 0.05)
    assert printed[0].endswith(want)
    assert all("control plane report" not in p for p in printed[1:])
