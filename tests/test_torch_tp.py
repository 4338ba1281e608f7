"""The port's model axis (tensor parallelism) against the JAX package's train
step on its own meshes, on the CPU: the dense family and the VLM and audio
families.

yi-9b's, paligemma-3b's and seamless-m4t-medium's smoke configurations in
f32 on B=8, S=16, as in tests/test_train_step.py.  Eight gloo ranks are
spawned once for the module (``run_ranks`` from test_torch_fabric.py) and
take the reference's meshes: ("data", "model") of (4, 2) and ("pod",
"data", "model") of (2, 2, 2).  The references are ``jax.value_and_grad``
of the JAX package's ``lm_loss`` on one device and its ``make_train_step``
on ``mesh8``, with the reference's tolerances: the loss within 1e-4 and the
gradient norm within 1e-3 relative (tests/test_train_step.py:46-58), the
multi-pod variants' norms within 2e-3 / 2e-3 / 0.02, and every gathered
gradient leaf by relative RMS <= 1e-4 (tests/test_torch_train.py).  The
checkpoint crosses from (4, 2) to (2, 2, 2) in both directions between the
packages.  JAX is imported inside the fixtures only, so the spawned ranks
never load it.
"""
import os
import pkgutil

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fabric import init_rank, run_ranks

from repro_torch import bridge
from repro_torch import configs as port_configs
from repro_torch.configs import get_config
from repro_torch.fabric import Fabric
from repro_torch.models import transformer as tf
from repro_torch.models.layers import cross_entropy
from repro_torch.parallel import sharding
from repro_torch.parallel.tensor import ModelAxis
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.step import (TrainSetup, compressed_pod_allreduce, ef_init, gather_tree,
                                   make_train_step)
from repro_torch.tree import leaves

B, S, WORLD = 8, 16, 8
GRAD_RTOL = 1e-4   # per leaf, relative RMS
FAMILIES = ("paligemma_3b", "seamless_m4t_medium")
REGISTRY = sorted(m.name for m in pkgutil.iter_modules(port_configs.__path__) if m.name != "base")
# yi-9b's runs: (mesh shape, mesh dims, TrainSetup fields) and the JAX
# package's gradient-norm tolerance for each (tests/test_train_step.py)
YI_RUNS = {"photonic": ((4, 2), ("data", "model"), {}),
           "eps": ((4, 2), ("data", "model"), {"fabric": "eps"}),
           "pod_fsdp": ((2, 2, 2), ("pod", "data", "model"), {}),
           "pod_hsdp": ((2, 2, 2), ("pod", "data", "model"), {"hsdp": True}),
           "pod_hsdp_int8": ((2, 2, 2), ("pod", "data", "model"),
                             {"hsdp": True, "compress_pod_grads": True})}
GN_RTOL = {"photonic": 1e-3, "eps": 1e-3, "pod_fsdp": 2e-3, "pod_hsdp": 2e-3,
           "pod_hsdp_int8": 0.02}
LOSS_TOL = {"photonic": 1e-4, "eps": 1e-4}   # the multi-pod variants: 2e-4
# The int8 exchange's direct case on (pod 2, data 2, model 2): per-pod
# gradients of leaves sharded over data (fd) and model (td), f32 and bf16.
EXCHANGE = {"a": ((8, 6), 0, 1, "float32"), "b": ((4, 4), 1, 0, "float32"),
            "c": ((6, 3), None, 0, "float32"), "d": ((4, 6), 0, 1, "bfloat16"),
            "e": ((5,), None, None, "float32")}
# granite-moe-1b-a400m's vocab: 499 in 512 padded rows, so model rank 1 of 2
# holds 243 tokens and 13 rows of padding
CE_VOCAB, CE_PADDED = 499, 512


def _rel_rms(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def _flat(tree) -> dict:
    import jax

    from repro.parallel.sharding import _path_str
    return {_path_str(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_cfg(arch: str):
    from repro.configs.base import get_config as jax_config
    return jax_config(arch, smoke=True).replace(dtype="float32")


def _port_cfg(arch: str):
    return get_config(arch, smoke=True).replace(dtype="float32")


def _shards(ref: dict, step, cfg) -> dict:
    """This rank's stored shards of the global parameters ``ref``."""
    fab, tp = step.fabric, step.model
    return bridge.shards_from_numpy(ref, fab.axis_index(), fab.n_shards, "cpu", "float32",
                                    model_index=tp.rank, model_size=tp.size)


def _gathered(tree, step) -> dict:
    return bridge.to_numpy(gather_tree(tree, step.fd_tree, step.fabric, step.td_tree,
                                       step.model))


def _metrics(m) -> list:
    return [float(m["loss"]), float(m["grad_norm"])]


def grads_on(mesh, cfg, ref, batch, out, label, setup_kw=None):
    """The gathered gradients (after the pod sum under HSDP), the loss and
    the MoE aux loss of one ``grads_fn`` on ``mesh`` into ``out`` under
    ``label``; returns the step."""
    setup = TrainSetup(cfg=cfg, **(setup_kw or {}))
    step = make_train_step(setup, mesh, tf.init_lm(cfg, device="meta"))
    params = _shards(ref, step, cfg)
    grads, m = step.grads_fn(params, batch)
    grads, _ = step.pod_sync(grads, ef_init(setup, params))
    out[f"{label}/loss"], out[f"{label}/moe_aux"] = float(m["loss"]), float(m["moe_aux"])
    for path, g in _gathered(grads, step).items():
        out[f"{label}/grad/{path}"] = g
    return step


def _exchange_inputs():
    """Per-pod gradients [2, ...] and error feedback [2, ...] of each leaf."""
    rng = np.random.default_rng(8)
    g = {k: (rng.standard_normal((2,) + shape) * 10.0 ** rng.integers(-3, 2, (2,) + shape)
             ).astype(np.float32) for k, (shape, *_) in EXCHANGE.items()}
    e = {k: (rng.standard_normal((2,) + shape) * 1e-3).astype(np.float32)
         for k, (shape, *_) in EXCHANGE.items()}
    g["d"] = torch.from_numpy(g["d"]).to(torch.bfloat16).float().numpy()
    return g, e


def _exchange_rank(mesh) -> dict:
    """The port's int8 exchange on (pod 2, data 2, model 2), each rank with
    its data and model shard of its pod's leaves: the summed gradients and
    each pod's new error feedback, gathered back to whole leaves."""
    fab, pod_fab = Fabric.from_mesh(mesh, ("data",)), Fabric.from_mesh(mesh, ("pod",))
    tp = ModelAxis.from_mesh(mesh)
    pod, data = pod_fab.axis_index(), fab.axis_index()
    g, e = _exchange_inputs()

    def shard(x, fd, td):
        t = torch.from_numpy(x[pod].copy())
        if td is not None:
            t = t.chunk(2, td)[tp.rank]
        return (t if fd is None else t.chunk(2, fd)[data]).contiguous()

    def whole(t, fd, td):
        t = t if fd is None else fab.all_gather(t, fd)
        return t if td is None else tp.gather(t, td)
    grads = {k: shard(g[k], fd, td).to(getattr(torch, dt)) for k, (_, fd, td, dt) in
             EXCHANGE.items()}
    ef = {k: shard(e[k], fd, td) for k, (_, fd, td, _) in EXCHANGE.items()}
    summed = compressed_pod_allreduce(grads, ef, fab, pod_fab, tp)
    out = {}
    for k, (_, fd, td, _) in EXCHANGE.items():
        out[f"exchange/sum/{k}"] = whole(summed[k], fd, td).float().numpy()
        out[f"exchange/ef/{k}"] = pod_fab.all_gather(whole(ef[k], fd, td)[None], 0).numpy()
    return out


def _ce_rank(mesh, tmp) -> dict:
    """The vocab-parallel cross-entropy on the (4, 2) mesh's model group:
    each rank's slice of the same logits; its loss, ce and the logits'
    gradient gathered over the model axis."""
    tp = ModelAxis.from_mesh(mesh)
    d = np.load(os.path.join(tmp, "ce.npz"))
    logits = torch.from_numpy(d["logits"]).chunk(tp.size, -1)[tp.rank].clone().requires_grad_()
    loss, ce = cross_entropy(logits, torch.from_numpy(d["targets"]), CE_VOCAB, tp=tp)
    loss.backward()
    return {"ce/loss": float(loss), "ce/ce": float(ce),
            "ce/grad": tp.gather(logits.grad, logits.dim() - 1).numpy()}


def _rank_main(rank, world, store, tmp):
    from torch.distributed.device_mesh import init_device_mesh
    init_rank(rank, world, store)
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(tmp, "batch.npz")).items()}
    yi = dict(np.load(os.path.join(tmp, "yi.npz")))
    cfg = _port_cfg("yi_9b")
    tpl = tf.init_lm(cfg, device="meta")
    mesh42 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    mesh222 = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    meshes = {(4, 2): mesh42, (2, 2, 2): mesh222}
    out = {}

    # yi-9b: gradients and one step on each mesh and setup
    for label, (shape, _, kw) in YI_RUNS.items():
        step = grads_on(meshes[shape], cfg, yi, batch, out, f"yi/{label}", kw)
        params = _shards(yi, step, cfg)
        setup = TrainSetup(cfg=cfg, **kw)
        params, opt, ef, m = step(params, topt.adamw_init(params), ef_init(setup, params), batch)
        out[f"yi/{label}/step1"] = _metrics(m)
        if label == "photonic":  # the trajectory the checkpoint continues
            ck_port = os.path.join(tmp, "ck_port")
            ckpt.save(ck_port, params, opt, ef, fd_tree=step.fd_tree, fabric=step.fabric,
                      td_tree=step.td_tree, model=step.model, extra={"step": 1})
            out["ckpt/port_step2"] = _metrics(step(params, opt, ef, batch)[3])

    # M = 1: a model dim of size 1 against no model dim, bit for bit
    for label, shape, dims in (("m1/with_dim", (8, 1), ("data", "model")),
                               ("m1/without", (8,), ("data",))):
        grads_on(init_device_mesh("cpu", shape, mesh_dim_names=dims), cfg, yi, batch, out, label)

    # the checkpoint: the port's from (4, 2) and the JAX package's from its
    # mesh8, each restored on (2, 2, 2), and the second step taken
    step222 = make_train_step(TrainSetup(cfg=cfg), mesh222, tpl)
    for label, ck in (("port", "ck_port"), ("jax", "ck_jax")):
        p2, o2, e2, extra = ckpt.restore(os.path.join(tmp, ck), TrainSetup(cfg=cfg), mesh222,
                                         tpl, "cpu")
        out[f"ckpt/{label}_restored_step"] = [extra["step"], o2["step"]]
        out[f"ckpt/{label}_resharded_step2"] = _metrics(step222(p2, o2, e2, batch)[3])

    # the VLM and audio families on (4, 2) and on its data sub-mesh (M = 1)
    for arch in FAMILIES:
        fcfg = _port_cfg(arch)
        ref = dict(np.load(os.path.join(tmp, f"{arch}.npz")))
        extra = "patches" if fcfg.family == "vlm" else "frames"
        fb = {"tokens": batch["tokens"], "targets": batch["targets"],
              extra: batch[f"{arch}/{extra}"]}
        grads_on(mesh42, fcfg, ref, fb, out, f"{arch}/m2")
        grads_on(mesh42["data"], fcfg, ref, fb, out, f"{arch}/m1")

    out.update(_exchange_rank(mesh222))
    out.update(_ce_rank(mesh42, tmp))
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_run(mesh8, tmp_path_factory):
    """yi-9b's parameters and batch; the loss, gradients and norm on one
    device; the JAX package's step on ``mesh8`` (step 1, checkpoint, step 2);
    the VLM and audio families' parameters and gradients on one device; the
    cross-entropy's logits and targets."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as T
    from repro.train.checkpoint import save
    from repro.train.step import TrainSetup as JSetup
    from repro.train.step import init_sharded_state as jinit
    from repro.train.step import make_train_step as jmake
    tmp = tmp_path_factory.mktemp("tp")
    cfg, rng = _jax_cfg("yi_9b"), jax.random.PRNGKey(0)
    params = T.init_lm(rng, cfg)
    batch = {"tokens": jax.random.randint(rng, (B, S), 0, cfg.vocab_size, jnp.int32),
             "targets": jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size,
                                           jnp.int32)}
    (loss, _), g = jax.value_and_grad(lambda p: T.lm_loss(p, batch, cfg), has_aux=True)(params)
    grads = _flat(g)
    out = {"tmp": tmp, "cfg": cfg, "loss": float(loss), "grads": grads,
           "grad_norm": float(np.sqrt(sum(np.sum(np.square(x, dtype=np.float64))
                                          for x in grads.values()))),
           "tpl": jax.eval_shape(lambda: T.init_lm(rng, cfg)), "batch": batch}
    np.savez(tmp / "yi.npz", **_flat(params))
    with jax.set_mesh(mesh8):
        setup = JSetup(cfg=cfg)
        state = jinit(setup, mesh8, rng)
        step = jax.jit(jmake(setup, mesh8, out["tpl"]))
        p1, o1, e1, m1 = step(*state, batch)
        save(str(tmp / "ck_jax"), p1, o1, e1, extra={"step": 1})
        out["step1"] = _metrics(m1)
        out["step2"] = _metrics(step(p1, o1, e1, batch)[3])
    nprng = np.random.default_rng(10)
    batch_npz = {k: np.asarray(v) for k, v in batch.items()}
    for arch in FAMILIES:
        fcfg = _jax_cfg(arch)
        extra = "patches" if fcfg.family == "vlm" else "frames"
        feats = nprng.standard_normal((B, fcfg.frontend.n_tokens, fcfg.frontend.d_embed),
                                      dtype=np.float32)
        batch_npz[f"{arch}/{extra}"] = feats
        fparams = T.init_lm(rng, fcfg)
        fb = dict(batch, **{extra: jnp.asarray(feats)})
        (floss, _), fg = jax.value_and_grad(lambda p: T.lm_loss(p, fb, fcfg),  # noqa: B023
                                            has_aux=True)(fparams)
        np.savez(tmp / f"{arch}.npz", **_flat(fparams))
        out[arch] = {"loss": float(floss), "grads": _flat(fg)}
    np.savez(tmp / "batch.npz", **batch_npz)
    np.savez(tmp / "ce.npz", logits=(nprng.standard_normal((2, 5, CE_PADDED)) * 3
                                     ).astype(np.float32),
             targets=nprng.integers(0, CE_VOCAB, (2, 5)).astype(np.int32))
    return out


@pytest.fixture(scope="module")
def port(jax_run):
    tmp = jax_run["tmp"]
    run_ranks(_rank_main, WORLD, tmp, str(tmp))
    return dict(np.load(tmp / "out.npz"))


# ---- leaf specs (no ranks) ----

@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("arch", REGISTRY)
def test_leaf_specs_match_jax(arch, model_size):
    """(spec, FSDP dim, TP dim) of every leaf of every smoke configuration,
    on one rail axis of 4 and on ("pod", "data") of 2 x 2, equal the JAX
    package's ``leaf_spec``'s (its PartitionSpec read as a tuple)."""
    import jax

    from repro.models import transformer as T
    from repro.parallel import sharding as jsh
    tpl = jax.eval_shape(lambda: T.init_lm(jax.random.PRNGKey(0), _jax_cfg(arch)))
    flat = {k: v.shape for k, v in _flat_shapes(tpl).items()}
    assert flat.keys() == bridge.flatten(tf.init_lm(_port_cfg(arch), device="meta")).keys()
    n_split = 0
    for rails in (("data",), ("pod", "data")):
        for path, shape in flat.items():
            kw = dict(n_rails=4, rail_axes=rails, model_size=model_size,
                      stacked=path.startswith("layers") or "/layers/" in path)
            got, want = sharding.leaf_spec(path, shape, **kw), jsh.leaf_spec(path, shape, **kw)
            assert got == (tuple(want[0]), want[1], want[2]), path
            n_split += got[2] is not None
    assert n_split > 0


def _flat_shapes(tpl) -> dict:
    import jax

    from repro.parallel.sharding import _path_str
    return {_path_str(p): x for p, x in jax.tree_util.tree_flatten_with_path(tpl)[0]}


# ---- yi-9b: the dense family ----

@pytest.mark.parametrize("label", list(YI_RUNS))
def test_loss_and_grad_norm_match_jax(jax_run, port, label):
    """Each mesh and setup's first step against the JAX package's loss and
    norm on one device; the dense (4, 2) runs also against its own step on
    ``mesh8``."""
    loss, gn = port[f"yi/{label}/step1"]
    assert abs(loss - jax_run["loss"]) < LOSS_TOL.get(label, 2e-4)
    assert abs(gn - jax_run["grad_norm"]) / jax_run["grad_norm"] < GN_RTOL[label]
    if label in LOSS_TOL:
        assert abs(loss - jax_run["step1"][0]) < 1e-4
        assert abs(gn - jax_run["step1"][1]) / jax_run["step1"][1] < 1e-3


@pytest.mark.parametrize("label", [k for k in YI_RUNS if k != "pod_hsdp_int8"])
def test_gradients_match_jax(jax_run, port, label):
    """Every gathered gradient leaf, after every collective of the step
    (under HSDP the pod AllReduce too; the int8 exchange perturbs them, so
    its run is held by its norm only)."""
    assert abs(port[f"yi/{label}/loss"] - jax_run["loss"]) < 2e-4
    for path, want in jax_run["grads"].items():
        assert _rel_rms(port[f"yi/{label}/grad/{path}"], want) <= GRAD_RTOL, path


def test_model_dim_of_one_is_bit_equal(port):
    """A ("data", "model") mesh of (8, 1) and a ("data",) mesh of 8: the
    same loss and gradients, bit for bit."""
    assert port["m1/with_dim/loss"] == port["m1/without/loss"]
    keys = [k for k in port if k.startswith("m1/without/grad/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(port[k.replace("without", "with_dim")], port[k])


# ---- the VLM and audio families ----

@pytest.mark.parametrize("arch", FAMILIES)
def test_families_match_jax_and_the_port_without_a_model_axis(jax_run, port, arch):
    """paligemma (one kv head: wk/wv replicated over the model axis, each
    rank's query heads read it) and seamless (cross-attention, the encoder's
    stack) on (4, 2): the loss and every gathered gradient leaf against the
    JAX package's and against the port's own run on the data sub-mesh."""
    want = jax_run[arch]
    for label in ("m2", "m1"):
        assert abs(port[f"{arch}/{label}/loss"] - want["loss"]) < 1e-4, label
        for path, w in want["grads"].items():
            assert _rel_rms(port[f"{arch}/{label}/grad/{path}"], w) <= GRAD_RTOL, (label, path)
    for path in want["grads"]:
        assert _rel_rms(port[f"{arch}/m2/grad/{path}"], port[f"{arch}/m1/grad/{path}"]) \
            <= GRAD_RTOL, path


# ---- the checkpoint across meshes and packages ----

def _close(got, want, loss_tol, gn_tol):
    assert abs(got[0] - want[0]) <= loss_tol, (got, want)
    assert abs(got[1] - want[1]) <= gn_tol * abs(want[1]), (got, want)


def test_checkpoint_restart_from_4x2_on_2x2x2(port):
    """The twin of tests/test_train_step.py::test_checkpoint_restart_and_
    elastic_reshard: saved on (4, 2), restored on (2, 2, 2), the continued
    step matches the original trajectory within 1e-4 / 1e-3."""
    assert list(port["ckpt/port_restored_step"]) == [1, 1]
    _close(port["ckpt/port_resharded_step2"], port["ckpt/port_step2"], 1e-4, 1e-3)


def test_port_restores_a_jax_checkpoint_from_4x2(jax_run, port):
    assert list(port["ckpt/jax_restored_step"]) == [1, 1]
    _close(port["ckpt/jax_resharded_step2"], jax_run["step2"], 1e-4, 1e-3)


def test_jax_restores_a_port_checkpoint_on_2x2x2(jax_run, port, mesh_pod):
    import jax

    from repro.train.checkpoint import restore
    from repro.train.step import TrainSetup as JSetup
    from repro.train.step import make_train_step as jmake
    with jax.set_mesh(mesh_pod):
        setup = JSetup(cfg=jax_run["cfg"])
        params, opt, ef, extra = restore(str(jax_run["tmp"] / "ck_port"), setup, mesh_pod,
                                         jax_run["tpl"])
        m = jax.jit(jmake(setup, mesh_pod, jax_run["tpl"]))(params, opt, ef,
                                                              jax_run["batch"])[3]
    assert extra == {"step": 1}
    _close(_metrics(m), jax_run["step2"], 1e-4, 1e-3)
    _close(_metrics(m), list(port["ckpt/port_step2"]), 1e-4, 1e-3)


# ---- the int8 exchange with the scale over the model shards ----

@pytest.fixture(scope="module")
def exchange_reference():
    """``repro.train.step.compressed_pod_allreduce`` under ``shard_map`` on a
    two-pod CPU mesh, each pod with its whole leaves."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.core.fabric import Fabric as JFabric
    from repro.train.step import compressed_pod_allreduce as jax_exchange
    g, e = _exchange_inputs()
    jg = {k: jnp.asarray(v, dtype=EXCHANGE[k][3]) for k, v in g.items()}
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
def test_int8_codes_match_jax_with_the_scale_over_model_shards(port, exchange_reference, leaf):
    """Each pod's int8 codes equal the JAX package's, whose scale is the
    largest |x| of the whole leaf: here over its data AND model shards.
    Tolerances as tests/test_torch_train.py's exchange test."""
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
    rtol = 2 ** -8 if EXCHANGE[leaf][3] == "bfloat16" else 0
    for pod in range(2):
        np.testing.assert_allclose(port[f"exchange/sum/{leaf}"], want_sum[leaf][pod], rtol=rtol,
                                   atol=2 * ulp)


# ---- the vocab-parallel cross-entropy ----

def test_vocab_parallel_cross_entropy_matches_jax(jax_run, port):
    """Over two model ranks with granite's vocab of 499 padded to 512 (rank
    1's slice holds 13 rows of padding): the loss with its z-loss, the mean
    ce and the logits' gradient against the JAX package's ``cross_entropy``."""
    import jax
    import jax.numpy as jnp

    from repro.models.layers import cross_entropy as jax_ce
    d = np.load(jax_run["tmp"] / "ce.npz")
    logits, targets = jnp.asarray(d["logits"]), jnp.asarray(d["targets"])
    (loss, ce), g = jax.value_and_grad(lambda lg: jax_ce(lg, targets, CE_VOCAB), has_aux=True)(
        logits)
    np.testing.assert_allclose(port["ce/loss"], float(loss), rtol=1e-6)
    np.testing.assert_allclose(port["ce/ce"], float(ce), rtol=1e-6)
    np.testing.assert_allclose(port["ce/grad"], np.asarray(g), rtol=1e-5, atol=1e-9)
    assert not port["ce/grad"][..., CE_VOCAB:].any()
