"""The port's GPipe pipeline against the JAX package's, on the CPU.

The twin of tests/test_serve.py::test_pipeline_parallel_loss: yi-9b's smoke
configuration cut to 4 layers, f32, B=8, S=16, 4 microbatches, on 4 stages
(4 spawned gloo ranks, ``run_ranks`` from test_torch_fabric.py), and
mamba2-370m's (tied embeddings, 2 periods) on 2 stages of a (2, 2) mesh.
The parameters are the JAX package's ``init_lm``, bridged.  The JAX step's
gradient is ``n_stages`` times the loss's (its loss ``psum`` is transposed
as another ``psum``: ROADMAP.md, Queue 3), so the port's update at ``lr``
equals the JAX step's at ``lr / n_stages``, and ``p - lr * grad lm_loss``.
Rank 0 also runs the 4 stages in turn in its own process
(``pipeline.LocalPipe``), as chip_smoke.py's phase 29 does on the card, with
the script's planted faults.
"""
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fabric import init_rank, run_ranks

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.parallel import pipeline

CFG = get_config("yi_9b", smoke=True).replace(dtype="float32", n_layers=4)
SSM_CFG = get_config("mamba2_370m", smoke=True).replace(dtype="float32")
B, S, N_MICRO, LR, WORLD = 8, 16, 4, 0.25, 4
# (label, config, stages)
RUNS = {"yi": (CFG, 4), "mamba": (SSM_CFG, 2)}
ARCHS = {"yi": "yi_9b", "mamba": "mamba2_370m"}
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stage_out(params, stage: int, k: int, label: str) -> dict:
    """{label/offset/path: array}: copies of this stage's rows of the layer
    leaves under their global row offset, the replicated leaves whole."""
    out = {}
    for path, arr in bridge.to_numpy(params).items():
        key = f"{label}/{stage * k}/{path}" if path.startswith("layers") else f"{label}/{path}"
        out[key] = arr.copy()
    return out


def _rank_main(rank, world, store, tmp):
    from torch.distributed.device_mesh import init_device_mesh
    init_rank(rank, world, store)
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(tmp, "batch.npz")).items()}
    out = {}
    for label, (cfg, n_stages) in RUNS.items():
        ref = dict(np.load(os.path.join(tmp, f"{label}_params.npz")))
        shape, axes = ((4,), ("pipe",)) if n_stages == 4 else ((2, 2), ("rep", "pipe"))
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        step = pipeline.make_pipeline_train_step(cfg, mesh, pipe_axis="pipe", n_micro=N_MICRO,
                                                 lr=LR)
        stage = step.pipe.stages[0]
        params = pipeline.stage_params(bridge.from_numpy(ref, "cpu"), stage, n_stages)
        out[f"{label}/fwd_loss"] = float(pipeline.pipeline_loss(
            [params], batch, cfg, pipe=step.pipe, n_micro=N_MICRO)[0])
        grads, out[f"{label}/grad_loss"] = step.grads_fn(params, batch)
        k = pipeline.stage_layers(cfg, n_stages)
        out.update({f"grad/{k_}": v for k_, v in _stage_out(grads, stage, k, label).items()})
        params, loss = step(params, batch)
        out[f"{label}/loss"] = float(loss)
        out.update(_stage_out(params, stage, k, label))
        out[f"{label}/loss2"] = float(step(params, batch)[1])
    outs = [None] * world
    dist.all_gather_object(outs, out)
    if rank == 0:
        _local_runs(tmp, batch, outs)
    dist.destroy_process_group()


def _local_runs(tmp, batch, outs):
    """The 4 stages of yi in turn on rank 0 (``LocalPipe``) and with each
    of chip_smoke.py's planted faults: each leaf's gradient beside the
    ranks' (their stages' rows concatenated)."""
    cs = _chip_smoke()
    ref = bridge.from_numpy(dict(np.load(os.path.join(tmp, "yi_params.npz"))), "cpu")
    trees = [pipeline.stage_params(ref, s, 4) for s in range(4)]
    res = {}
    for rank, o in enumerate(outs):
        for key, v in o.items():
            res[key] = np.asarray(v)
            if not key.split("/")[1].isdigit() and not key.startswith("grad/"):
                res[f"rank{rank}/{key}"] = np.asarray(v)
    for name, pipe in [("local", pipeline.LocalPipe(4))] + list(cs.pipe_faults(4).items()):
        grads, loss = pipeline.pipeline_grads(trees, batch, CFG, pipe=pipe, n_micro=N_MICRO)
        res[f"{name}/loss"] = float(loss[0])
        for path, g in cs.stages_joined(grads).items():
            res[f"{name}/{path}"] = g.numpy()
    np.savez(os.path.join(tmp, "out.npz"), **res)


def _global(out: dict, prefix: str, k: int, n_stages: int) -> dict:
    """{path: array} of the global tree from the stages' pieces."""
    tree = {}
    for key, arr in out.items():
        if not key.startswith(prefix + "/"):
            continue
        rest = key[len(prefix) + 1:]
        head, _, path = rest.partition("/")
        if head.isdigit():
            tree.setdefault(path, {})[int(head)] = arr
        elif rest not in ("loss", "loss2", "fwd_loss", "grad_loss"):
            tree[rest] = arr
    return {p: (np.concatenate([v[s * k] for s in range(n_stages)]) if isinstance(v, dict)
                else v) for p, v in tree.items()}


@pytest.fixture(scope="module")
def reference():
    """For each run: the JAX package's parameters, batch, ``lm_loss``
    (aux_weight 0) and its gradient, and its pipeline step's loss and
    parameters at lr / n_stages and (yi) at lr."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.base import get_config as jax_config
    from repro.models import transformer as T
    from repro.parallel.pipeline import make_pipeline_train_step
    from repro.parallel.sharding import _path_str

    rng = jax.random.PRNGKey(0)
    flat = lambda t: {_path_str(p): np.asarray(x)  # noqa: E731
                      for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
    out = {}
    for label, (cfg_t, n_stages) in RUNS.items():
        cfg = jax_config(ARCHS[label], smoke=True).replace(dtype="float32",
                                                          n_layers=cfg_t.n_layers)
        params = T.init_lm(rng, cfg)
        batch = {"tokens": jax.random.randint(rng, (B, S), 0, cfg.vocab_size, jnp.int32),
                 "targets": jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                               cfg.vocab_size, jnp.int32)}
        loss, g = jax.value_and_grad(lambda p: T.lm_loss(p, batch, cfg, aux_weight=0.0)[0])(
            params)
        mesh = jax.make_mesh((n_stages,), ("pipe",), devices=jax.devices()[:n_stages],
                             axis_types=(jax.sharding.AxisType.Auto,))
        r = {"params": flat(params), "batch": {k: np.asarray(v) for k, v in batch.items()},
             "loss": float(loss), "grads": flat(g)}
        lrs = {"jax_lr_over_n": LR / n_stages, "jax_lr": LR} if label == "yi" else \
            {"jax_lr_over_n": LR / n_stages}
        for tag, lr in lrs.items():
            with jax.set_mesh(mesh):
                pp = jax.tree_util.tree_map(lambda x: jax.device_put(x, NamedSharding(mesh, P())),
                                            params)
                pp["layers"] = jax.tree_util.tree_map(
                    lambda x: jax.device_put(x, NamedSharding(mesh, P("pipe"))),
                    params["layers"])
                step = jax.jit(make_pipeline_train_step(cfg, mesh, pipe_axis="pipe",
                                                        n_micro=N_MICRO, lr=lr))
                p2, l1 = step(pp, batch)
            r[tag] = {"params": flat(p2), "loss": float(l1)}
        out[label] = r
    # one batch serves both runs (both smoke vocabularies are 512)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(out["yi"]["batch"][k], out["mamba"]["batch"][k])
    return out


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    for label in RUNS:
        np.savez(tmp / f"{label}_params.npz", **reference[label]["params"])
    np.savez(tmp / "batch.npz", **reference["yi"]["batch"])
    run_ranks(_rank_main, WORLD, tmp, str(tmp))
    return dict(np.load(tmp / "out.npz"))


def _updated(port, label):
    cfg, n_stages = RUNS[label]
    return _global(port, label, pipeline.stage_layers(cfg, n_stages), n_stages)


@pytest.mark.parametrize("label", list(RUNS))
def test_loss_matches_jax_pipeline_and_lm_loss(reference, port, label):
    r = reference[label]
    assert abs(port[f"{label}/loss"] - r["jax_lr_over_n"]["loss"]) < 1e-4
    assert abs(port[f"{label}/loss"] - r["loss"]) < 1e-4
    assert abs(port[f"{label}/fwd_loss"] - port[f"{label}/loss"]) < 1e-6


@pytest.mark.parametrize("label", list(RUNS))
def test_update_equals_jax_step_at_lr_over_n_stages(reference, port, label):
    got, want = _updated(port, label), reference[label]["jax_lr_over_n"]["params"]
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("label", list(RUNS))
def test_update_is_sgd_on_the_lm_loss_gradient(reference, port, label):
    r = reference[label]
    got = _updated(port, label)
    for path, p0 in r["params"].items():
        np.testing.assert_allclose(got[path], p0 - LR * r["grads"][path], rtol=0, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("label", list(RUNS))
def test_second_step_lowers_the_loss(port, label):
    assert port[f"{label}/loss2"] < port[f"{label}/loss"]


@pytest.mark.parametrize("label", list(RUNS))
def test_replicated_leaves_agree_on_every_stage(port, label):
    """The embedding, final norm and unembedding (or the tied embedding)
    come out of the step equal on every rank of the pipe group."""
    _, n_stages = RUNS[label]
    for path in ("embed", "final_norm") + (("unembed",) if label == "yi" else ()):
        key = f"{label}/{path}"
        assert key in port
        for r in range(n_stages):
            np.testing.assert_array_equal(port[f"rank{r}/{key}"], port[key])


def test_reference_pipeline_gradient_is_n_stages_times_the_loss_gradient(reference, port):
    """ROADMAP.md, Queue 3: at the same lr, the JAX step's update of every
    leaf is 4.000 times the port's (per-leaf projection), on 4 stages."""
    r = reference["yi"]
    got = _updated(port, "yi")
    for path, p0 in r["params"].items():
        port_step = (p0 - got[path]).astype(np.float64)
        jax_step = (p0 - r["jax_lr"]["params"][path]).astype(np.float64)
        ratio = float((jax_step * port_step).sum() / (port_step * port_step).sum())
        assert abs(ratio - 4.0) < 1e-4, (path, ratio)


def test_local_stages_equal_the_ranks_bit_for_bit(port):
    """4 stages run in turn in one process (a local hand-off in place of the
    shift) give the ranks' loss and every gradient leaf bit for bit."""
    want = _global(port, "grad/yi", 1, 4)
    assert port["local/loss"] == port["yi/grad_loss"]
    for path, w in want.items():
        np.testing.assert_array_equal(port[f"local/{path}"], w, err_msg=path)


@pytest.mark.parametrize("fault", ["microbatch_dropped", "cotangent_not_shifted",
                                   "shift_by_two"])
def test_planted_faults_move_the_gradients(port, fault):
    """chip_smoke.py's planted faults of the hand-off each move some leaf's
    gradient by more than the script's limit (relative RMS)."""
    want = _global(port, "grad/yi", 1, 4)
    rel = [float(np.sqrt(np.mean((port[f"{fault}/{p}"] - w) ** 2)) / np.sqrt(np.mean(w ** 2)))
           for p, w in want.items()]
    limit = _chip_smoke().PIPE_LIMIT
    assert not all(np.isfinite(r) and r <= limit for r in rel), max(rel)


def test_stage_layers_refuses_an_uneven_split():
    assert pipeline.stage_layers(CFG, 2) == 2
    with pytest.raises(ValueError, match="do not split"):
        pipeline.stage_layers(CFG, 3)
    with pytest.raises(ValueError, match="do not split"):
        pipeline.stage_params({"layers": [{"w": torch.zeros(4, 2)}]}, 0, 3)


def test_refuses_a_batch_that_does_not_split_into_microbatches():
    params = pipeline.stage_params(bridge.from_numpy({"layers/0/norm1": np.zeros((4, 64))},
                                                     "cpu"), 0, 1)
    batch = {"tokens": torch.zeros((6, 4), dtype=torch.long),
             "targets": torch.zeros((6, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_loss([params], batch, CFG, pipe=pipeline.LocalPipe(1), n_micro=4)

