"""The port's model axis against the JAX package on the CPU: expert
parallelism (deepseek-moe-16b, granite-moe-1b-a400m), the SSD mixer's head
split (mamba2-370m) and the hybrid (jamba-v0.1-52b).

Smoke configurations in f32 on B=8, S=16.  Eight gloo ranks are spawned once
for the module (``run_ranks`` from test_torch_fabric.py).  Each model trains
one ``grads_fn`` on the reference's mesh and on its sub-mesh without the
model axis: deepseek, granite and mamba on ("data", "model") of (4, 2) and
its ("data",) of 4; jamba on ("pod", "data", "model") of (2, 2, 2), where
both the misaligned w_in split (296 columns, 148 a rank, against z's 128)
and B/C replicated over the axis (one group on two ranks) occur, and its
("pod", "data") of 2 x 2.  The references: ``jax.grad`` of the JAX
package's ``lm_loss`` on one device for mamba; for the MoE models the
distributed step's exact objective, (1/4) times the sum over the four
data-parallel ranks of ``lm_loss`` on each rank's rows (each rank's aux
loss is over its own rows), and the loss on one device within 1e-2, as
tests/test_train_step.py holds the JAX step.  Gradients per leaf by
relative RMS <= 1e-4 (tests/test_torch_train.py).  JAX is imported inside
the fixtures only.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fabric import init_rank, run_ranks
from test_torch_tp import GRAD_RTOL, _flat, _jax_cfg, _port_cfg, _rel_rms, grads_on

from repro_torch.configs import get_config
from repro_torch.models import ssm as ssm_mod

B, S, WORLD, N_DP = 8, 16, 8, 4
# arch -> (mesh shape, mesh dims, the sub-mesh's dims without the model axis)
RUNS = {"deepseek_moe_16b": ((4, 2), ("data", "model"), ("data",)),
        "granite_moe_1b_a400m": ((4, 2), ("data", "model"), ("data",)),
        "mamba2_370m": ((4, 2), ("data", "model"), ("data",)),
        "jamba_v0_1_52b": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"))}


def _rank_main(rank, world, store, tmp):
    from torch.distributed.device_mesh import init_device_mesh
    init_rank(rank, world, store)
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(tmp, "batch.npz")).items()}
    out = {}
    for arch, (shape, dims, sub) in RUNS.items():
        cfg = _port_cfg(arch)
        ref = dict(np.load(os.path.join(tmp, f"{arch}.npz")))
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=dims)
        for label, m in (("m2", mesh), ("m1", mesh[sub])):
            step = grads_on(m, cfg, ref, batch, out, f"{arch}/{label}")
            out[f"{arch}/{label}/model_size"] = step.model.size
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per model: parameters, the objective's value and gradients (the MoE
    models: the distributed objective over the four data-parallel ranks'
    rows; mamba: the loss of the whole batch, the same thing without an aux
    term) and the loss on one device."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as T
    tmp = tmp_path_factory.mktemp("tp_moe_ssm")
    rng = np.random.default_rng(11)
    batch = {k: rng.integers(0, 499, (B, S), dtype=np.int32) for k in ("tokens", "targets")}
    np.savez(tmp / "batch.npz", **batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rows = B // N_DP
    out = {"tmp": tmp}
    for arch in RUNS:
        cfg = _jax_cfg(arch)
        params = T.init_lm(jax.random.PRNGKey(0), cfg)

        def objective(p, cfg=cfg):
            return sum(T.lm_loss(p, {k: v[r * rows:(r + 1) * rows] for k, v in jb.items()},
                                 cfg)[0] for r in range(N_DP)) / N_DP
        value, g = jax.value_and_grad(objective)(params)
        np.savez(tmp / f"{arch}.npz", **_flat(params))
        out[arch] = {"objective": float(value), "grads": _flat(g),
                     "loss": float(T.lm_loss(params, jb, cfg)[0])}
    return out


@pytest.fixture(scope="module")
def port(reference):
    tmp = reference["tmp"]
    run_ranks(_rank_main, WORLD, tmp, str(tmp))
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("arch", list(RUNS))
def test_matches_jax_and_the_port_without_a_model_axis(reference, port, arch):
    """The loss and every gathered gradient leaf (the router, the experts,
    the shared expert, the SSM's leaves) on the model axis against the JAX
    package's objective and against the port's run on the sub-mesh; for
    the MoE models also the loss on one device within 1e-2."""
    want = reference[arch]
    assert port[f"{arch}/m2/model_size"] == 2 and port[f"{arch}/m1/model_size"] == 1
    for label in ("m2", "m1"):
        assert abs(port[f"{arch}/{label}/loss"] - want["objective"]) < 1e-4, label
        for path, w in want["grads"].items():
            assert _rel_rms(port[f"{arch}/{label}/grad/{path}"], w) <= GRAD_RTOL, (label, path)
    for path in want["grads"]:
        assert _rel_rms(port[f"{arch}/m2/grad/{path}"], port[f"{arch}/m1/grad/{path}"]) \
            <= GRAD_RTOL, path
    if "moe" in arch or "jamba" in arch:
        assert abs(port[f"{arch}/m2/loss"] - want["loss"]) < 1e-2


@pytest.mark.parametrize("arch", [a for a in RUNS if a != "mamba2_370m"])
def test_router_and_aux_loss_as_without_a_model_axis(port, arch):
    """Expert parallelism gathers the router and routes on every rank as one
    rank does: the same aux loss, and the router's gradient (through the
    gates each rank's experts combine, summed over the axis, and the aux
    loss) as without the axis."""
    assert abs(port[f"{arch}/m2/moe_aux"] - port[f"{arch}/m1/moe_aux"]) < 1e-6
    routers = [k for k in port if k.startswith(f"{arch}/m2/grad/") and k.endswith("ffn/router")]
    assert routers
    for k in routers:
        assert _rel_rms(port[k], port[k.replace("/m2/", "/m1/")]) <= GRAD_RTOL, k


@pytest.mark.parametrize("arch,size", [("mamba2_370m", 2), ("jamba_v0_1_52b", 2),
                                       ("mamba2_370m", 8)])
def test_mixer_columns_split_the_segments(arch, size):
    """``ssm.mixer_columns`` over the ranks: the z, x and dt columns of w_in
    (and the x channels of the conv) split evenly and each once, and every
    rank reads the B/C columns of its heads' group: all of them, the groups
    (one) being fewer than the ranks; w_in's stored even blocks do not line
    up with the segments."""
    cfg = get_config(arch, smoke=size == 2)
    d_inner, h, pdim, n = ssm_mod.ssm_dims(cfg)
    g = cfg.ssm.n_groups
    width = 2 * d_inner + 2 * g * n + h
    assert (width // size) % d_inner != 0  # even blocks straddle the segments
    cols = [ssm_mod.mixer_columns(cfg, size, r) for r in range(size)]
    bc = set(range(2 * d_inner, 2 * d_inner + 2 * g * n))
    own = sorted(int(c) for r in cols for c in r["w_in"] if int(c) not in bc)
    assert own == [c for c in range(width) if c not in bc]
    assert g < size
    for r in cols:
        assert {int(c) for c in r["w_in"]} >= bc
        assert len(r["norm_w"]) == d_inner // size
        assert len(r["conv_w"]) == d_inner // size + 2 * g * n
