"""The port's checkpoint (``repro_torch.train.checkpoint``) against the JAX
package's, on the CPU: the same on-disk format both ways, restart and
elastic reshard on another mesh, HSDP's error feedback.

yi-9b's smoke configuration in f32 on B=8, S=16, as in
tests/test_train_step.py.  The JAX package trains one step on its 8-device
CPU mesh (``mesh8``), saves, and takes a second step: its own continued
trajectory.  Four spawned gloo ranks (``run_ranks`` from
test_torch_fabric.py) start the port from the same parameters, train one
step on ("data",) of 4, save and step again; restore that checkpoint on
("pod", "data") of 2 x 2 and take the second step again; and restore the
JAX package's checkpoint on 2 x 2 and take it from there.  The JAX package
restores the port's checkpoint and takes the second step.  Tolerances are
the reference's: the restarted step within 1e-4 (loss) and 1e-3 (grad
norm) of the original trajectory, and a step across packages within 2e-4
and 2e-3 relative (tests/test_train_step.py:70-71).  JAX is imported inside
the fixtures only, so the spawned ranks never load it.
"""
import json
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
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.step import TrainSetup, ef_init, init_sharded_state, make_train_step
from repro_torch.tree import leaves

CFG = get_config("yi_9b", smoke=True).replace(dtype="float32")
B, S, WORLD = 8, 16, 4
REGISTRY = sorted(m.name for m in pkgutil.iter_modules(port_configs.__path__) if m.name != "base")


def _step_metrics(m) -> list:
    return [float(m["loss"]), float(m["grad_norm"])]


def _rank_main(rank, world, store, tmp):
    from torch.distributed.device_mesh import init_device_mesh
    init_rank(rank, world, store)
    ref = dict(np.load(os.path.join(tmp, "params.npz")))
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(tmp, "batch.npz")).items()}
    tpl = tf.init_lm(CFG, device="meta")
    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    fsdp = TrainSetup(cfg=CFG)
    hsdp = TrainSetup(cfg=CFG, hsdp=True, compress_pod_grads=True)
    out = {}

    # one step on ("data",) of 4, save, a second step: the port's trajectory
    step4 = make_train_step(fsdp, mesh4, tpl)
    params = bridge.shards_from_numpy(ref, step4.fabric.axis_index(), 4, "cpu", "float32")
    params, opt, ef, m = step4(params, topt.adamw_init(params), {}, batch)
    out["port/step1"] = _step_metrics(m)
    ck_port = os.path.join(tmp, "ck_port")
    ckpt.save(ck_port, params, opt, ef, fd_tree=step4.fd_tree, fabric=step4.fabric,
              extra={"step": 1})
    out["port/step2"] = _step_metrics(step4(params, opt, ef, batch)[3])

    # restart on 2 x 2, re-sharded: the second step again
    step22 = make_train_step(fsdp, mesh22, tpl)
    p2, o2, e2, extra = ckpt.restore(ck_port, fsdp, mesh22, tpl, "cpu")
    out["resharded/extra_step"], out["resharded/opt_step"] = extra["step"], o2["step"]
    out["resharded/step2"] = _step_metrics(step22(p2, o2, e2, batch)[3])

    # the JAX package's checkpoint, restored on 2 x 2
    p3, o3, e3, extra = ckpt.restore(os.path.join(tmp, "ck_jax"), fsdp, mesh22, tpl, "cpu")
    out["from_jax/extra_step"], out["from_jax/ef_empty"] = extra["step"], e3 == {}
    out["from_jax/step2"] = _step_metrics(step22(p3, o3, e3, batch)[3])

    # an FSDP checkpoint restored under HSDP with compression: ef starts at
    # zeros; one step fills it; HSDP's checkpoint round-trips (pod 0's ef)
    steph = make_train_step(hsdp, mesh22, tpl)
    ph, oh, eh, _ = ckpt.restore(ck_port, hsdp, mesh22, tpl, "cpu")
    out["hsdp/ef_zero_at_restore"] = all(not e.any() for e in leaves(eh))
    ph, oh, eh, m = steph(ph, oh, eh, batch)
    out["hsdp/ef_abs_sum"] = sum(float(e.abs().sum()) for e in leaves(eh))
    ck_h = os.path.join(tmp, "ck_hsdp")
    ckpt.save(ck_h, ph, oh, eh, fd_tree=steph.fd_tree, fabric=steph.fabric, extra={"step": 2})
    ph2, oh2, eh2, _ = ckpt.restore(ck_h, hsdp, mesh22, tpl, "cpu")
    pod_fab = Fabric.from_mesh(mesh22, ("pod",))
    pod0 = [pod_fab.all_gather(e[None], 0)[0] for e in leaves(eh)]  # pod 0's ef shards
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))  # noqa: E731
    out["hsdp/params_round_trip"] = same(ph, ph2) and same(oh["m"], oh2["m"]) \
        and same(oh["v"], oh2["v"]) and oh["step"] == oh2["step"] == 2
    # pod 0 reads its own back; pod 1, whose ef differs, reads pod 0's
    out["hsdp/ef_is_pod0s"] = same(eh2, pod0) and (
        same(eh2, eh) if pod_fab.axis_index() == 0 else not same(eh, pod0))
    out["hsdp/step3"] = _step_metrics(steph(ph2, oh2, eh2, batch)[3])
    # every rank's answers, so that each pod's are checked
    answers = [None] * world
    dist.all_gather_object(answers, {k: v for k, v in out.items() if k.startswith("hsdp/")})
    out["hsdp/all_ranks"] = [a["hsdp/ef_is_pod0s"] and a["hsdp/params_round_trip"]
                             for a in answers]

    # a stale <dir>.tmp is cleared, and an existing checkpoint replaced
    ck_a = os.path.join(tmp, "ck_atomic")
    if rank == 0:
        os.makedirs(ck_a + ".tmp")
        open(os.path.join(ck_a + ".tmp", "stale.npy"), "w").close()
        os.makedirs(ck_a)
        open(os.path.join(ck_a, "old.npy"), "w").close()
    dist.barrier()
    ckpt.save(ck_a, params, opt, ef, fd_tree=step4.fd_tree, fabric=step4.fabric,
              extra={"step": 7})
    if rank == 0:
        out["atomic/files"] = sorted(os.listdir(ck_a))
        out["atomic/tmp_left"] = os.path.exists(ck_a + ".tmp")
        out["atomic/want_files"] = sorted(os.listdir(ck_port))
        with open(os.path.join(tmp, "out.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_run(mesh8, tmp_path_factory):
    """The JAX package's trajectory: init, step 1, save, step 2; the
    parameters at init and the batch for the port."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_config
    from repro.models import transformer as T
    from repro.parallel.sharding import _path_str
    from repro.train.checkpoint import save
    from repro.train.step import TrainSetup as JSetup
    from repro.train.step import init_sharded_state as jinit
    from repro.train.step import make_train_step as jmake

    tmp = tmp_path_factory.mktemp("ckpt")
    cfg = jax_config("yi_9b", smoke=True).replace(dtype="float32")
    rng = jax.random.PRNGKey(0)
    batch = {"tokens": jax.random.randint(rng, (B, S), 0, cfg.vocab_size, jnp.int32),
             "targets": jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size,
                                           jnp.int32)}
    tpl = jax.eval_shape(lambda: T.init_lm(rng, cfg))
    np.savez(tmp / "params.npz", **{_path_str(p): np.asarray(x) for p, x in
                                    jax.tree_util.tree_flatten_with_path(T.init_lm(rng, cfg))[0]})
    np.savez(tmp / "batch.npz", **{k: np.asarray(v) for k, v in batch.items()})
    with jax.set_mesh(mesh8):
        setup = JSetup(cfg=cfg)
        params, opt, ef = jinit(setup, mesh8, rng)
        step = jax.jit(jmake(setup, mesh8, tpl))
        params, opt, ef, m1 = step(params, opt, ef, batch)
        save(str(tmp / "ck_jax"), params, opt, ef, extra={"step": 1})
        _, _, _, m2 = step(params, opt, ef, batch)
    return {"tmp": tmp, "cfg": cfg, "tpl": tpl, "batch": batch, "step1": _step_metrics(m1),
            "step2": _step_metrics(m2)}


@pytest.fixture(scope="module")
def port(jax_run):
    tmp = jax_run["tmp"]
    run_ranks(_rank_main, WORLD, tmp, str(tmp))
    with open(tmp / "out.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_from_port(jax_run, port, mesh_pod):
    """The JAX package restores the port's checkpoint on its (2, 2, 2) mesh
    and takes the second step."""
    import jax

    from repro.train.checkpoint import restore
    from repro.train.step import TrainSetup as JSetup
    from repro.train.step import make_train_step as jmake
    with jax.set_mesh(mesh_pod):
        setup = JSetup(cfg=jax_run["cfg"])
        params, opt, ef, extra = restore(str(jax_run["tmp"] / "ck_port"), setup, mesh_pod,
                                         jax_run["tpl"])
        _, _, _, m = jax.jit(jmake(setup, mesh_pod, jax_run["tpl"]))(params, opt, ef,
                                                                     jax_run["batch"])
    return {"extra": extra, "step2": _step_metrics(m)}


def _close(got, want, loss_tol, gn_tol, relative):
    assert abs(got[0] - want[0]) <= loss_tol * (abs(want[0]) if relative else 1), (got, want)
    assert abs(got[1] - want[1]) <= gn_tol * (abs(want[1]) if relative else 1), (got, want)


def test_first_step_matches_jax(jax_run, port):
    _close(port["port/step1"], jax_run["step1"], 2e-4, 2e-3, relative=True)


def test_checkpoint_restart_and_elastic_reshard(port):
    """The twin of tests/test_train_step.py::test_checkpoint_restart_and_
    elastic_reshard: saved on ("data",) of 4, restored on ("pod", "data") of
    2 x 2, the continued step matches the original trajectory."""
    assert port["resharded/extra_step"] == 1 and port["resharded/opt_step"] == 1
    _close(port["resharded/step2"], port["port/step2"], 1e-4, 1e-3, relative=False)


def test_port_restores_a_jax_checkpoint(jax_run, port):
    assert port["from_jax/extra_step"] == 1 and port["from_jax/ef_empty"]
    _close(port["from_jax/step2"], jax_run["step2"], 2e-4, 2e-3, relative=True)


def test_jax_restores_a_port_checkpoint(jax_run, jax_from_port):
    assert jax_from_port["extra"] == {"step": 1}
    _close(jax_from_port["step2"], jax_run["step2"], 2e-4, 2e-3, relative=True)


def test_written_manifests_are_the_same(jax_run, port):
    """The manifests the two packages wrote for the same configuration list
    the same leaves, keys, files, dtypes and shapes in the same order."""
    def manifest(name):
        with open(jax_run["tmp"] / name / "manifest.json") as f:
            return json.load(f)
    got, want = manifest("ck_port"), manifest("ck_jax")
    assert got == want
    assert {r["tree"] for r in got["leaves"]} == {"params", "opt"}


@pytest.mark.parametrize("arch", REGISTRY)
def test_manifest_spelling_matches_jax(arch):
    """For every configuration: the port's keys (the JAX ``keystr`` of each
    leaf), file names, dtypes and shapes of params, the AdamW state and
    HSDP's error feedback, in the JAX flattening order, are the JAX
    package's (``tree_flatten_with_path`` of ``jax.eval_shape(init_lm)`` and
    of ``adamw_init``; the file name by the reference's formula)."""
    import jax

    from repro.configs.base import get_config as jax_config
    from repro.models import transformer as T
    from repro.train.optimizer import adamw_init as jax_adamw_init
    tpl = jax.eval_shape(lambda: T.init_lm(jax.random.PRNGKey(0), jax_config(arch)))
    jtrees = {"params": tpl, "opt": jax.eval_shape(jax_adamw_init, tpl),
              "ef": jax.tree_util.tree_map(lambda p: jax.ShapeDtypeStruct(p.shape, "float32"), tpl)}
    want = []
    for name, tree in jtrees.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = jax.tree_util.keystr(path)
            fname = f"{name}{key}".replace("/", "_").replace("'", "").replace("[", "_") \
                .replace("]", "") + ".npy"
            want.append((name, key, fname, str(leaf.dtype), list(leaf.shape)))
    params = tf.init_lm(get_config(arch), device="meta")
    setup = TrainSetup(cfg=get_config(arch), hsdp=True, compress_pod_grads=True)
    got = [(name, key, ckpt.file_name(name, key),
            "int32" if isinstance(leaf, int) else str(leaf.dtype).removeprefix("torch."),
            [] if isinstance(leaf, int) else list(leaf.shape))
           for name, key, leaf in ckpt.manifest_records(params, topt.adamw_init(params),
                                                        ef_init(setup, params))]
    assert got == want


def test_stale_tmp_is_cleared_and_a_checkpoint_replaced(port):
    assert not port["atomic/tmp_left"]
    assert port["atomic/files"] == port["atomic/want_files"]


def test_hsdp_error_feedback_round_trips(port):
    """An FSDP checkpoint restores under HSDP with compression (ef from
    zeros); after a step the error feedback is non-zero; the HSDP checkpoint
    restores the parameters, moments and step exactly, and on every pod the
    error feedback of pod 0 (the one written, as the JAX package writes the
    replica it reads back); the restored state steps on."""
    assert port["hsdp/ef_zero_at_restore"]
    assert port["hsdp/ef_abs_sum"] > 0
    assert port["hsdp/all_ranks"] == [True] * WORLD
    assert np.isfinite(port["hsdp/step3"]).all()


def test_restore_runs_on_one_process(tmp_path):
    """``init_sharded_state`` -> save -> restore on a group of one: every
    leaf comes back with its dtype, bf16 included."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = get_config("yi_9b", smoke=True)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        setup = TrainSetup(cfg=cfg)
        params, opt, ef = init_sharded_state(setup, mesh, seed=0, device="cpu")
        step = make_train_step(setup, mesh, tf.init_lm(cfg, device="meta"))
        ckpt.save(str(tmp_path / "ck"), params, opt, ef, fd_tree=step.fd_tree,
                  fabric=step.fabric, extra={"step": 0})
        p2, o2, e2, extra = ckpt.restore(str(tmp_path / "ck"), setup, mesh,
                                         tf.init_lm(cfg, device="meta"), "cpu")
    finally:
        dist.destroy_process_group()
    assert extra == {"step": 0} and e2 == {} and o2["step"] == 0
    for a, b in zip(leaves(params) + leaves(opt["m"]), leaves(p2) + leaves(o2["m"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert {t.dtype for t in leaves(p2)} == {torch.bfloat16, torch.float32}


def test_end_to_end_twin_restarts_on_another_mesh():
    """``python -m repro_torch.launch.end_to_end --tiny`` (the twin of
    examples/train_end_to_end.py) on four spawned gloo ranks: phase 1 on 4x1
    with a checkpoint, phase 2 resumed from it on 2x2x1."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.end_to_end", "--tiny",
                          "--device", "cpu", "--steps", "4"], cwd=root, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "checkpointed @ 2" in out and "resumed from step 2" in out, out
    assert "step    3 loss" in out and "trained 4 steps across a mesh change" in out, out
