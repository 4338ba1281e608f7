"""The port's rail collectives (``repro_torch.fabric``) against the JAX
package's ``Fabric`` under ``shard_map``, on the CPU.

Eight gloo ranks are spawned once for the module; each runs every case on
its shard of inputs made from a seed with numpy and writes what it got.  The
JAX package's rings run on the conftest's 8-device mesh (and a (pod 2,
data 4) mesh) as the reference.  Everything is f32 and compared for
equality: the gathers move data, and the port's reduce-scatter sums in the
order of the JAX package's linear transpose.  JAX is imported inside the
fixtures only, so the spawned ranks never load it.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.fabric import Fabric

N = 8


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 240.0):
    """Run fn(rank, world, store_path, *args) on ``world`` spawned gloo ranks
    that meet through a FileStore under ``tmp_path``; raise if any fails or
    the run outlasts ``timeout`` seconds."""
    ctx = mp.start_processes(fn, args=(world, str(tmp_path / "store")) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


def init_rank(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)


def _data():
    """Global inputs of every case, from one seed."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"ag0": f(32, 3), "ag1": f(4, 32), "ag0_bi": f(64, 3), "ag1_bi": f(4, 64),
            "rs": f(N, 32, 3), "rs_bi": f(N, 64, 3), "ar": f(N, 33), "a2a": f(N, N, 5),
            "shift": f(N, 6), "pod_ag": f(16, 2), "pod_rs": f(N, 16, 2),
            "adj_x": f(32, 3), "adj_w": f(N, 32, 3)}


def _shard(x, axis: int, i: int, n: int):
    size = x.shape[axis] // n
    return torch.from_numpy(np.take(x, np.arange(i * size, (i + 1) * size), axis=axis).copy())


def _rank_main(rank, world, store, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    init_rank(rank, world, store)
    d = _data()
    mesh = init_device_mesh("cpu", (N,), mesh_dim_names=("data",))
    mesh_pod = init_device_mesh("cpu", (2, N // 2), mesh_dim_names=("pod", "data"))
    out = {}
    for kind in ("photonic", "eps"):
        fab = Fabric.from_mesh(mesh, ("data",), kind)
        bi = Fabric.from_mesh(mesh, ("data",), kind, bidirectional=True)
        pod = Fabric.from_mesh(mesh_pod, ("pod", "data"), kind)
        mine = lambda name: torch.from_numpy(d[name][rank])  # noqa: E731
        r = {"ag0": fab.all_gather(_shard(d["ag0"], 0, rank, N), 0),
             "ag1": fab.all_gather(_shard(d["ag1"], 1, rank, N), 1),
             "ag0_bi": bi.all_gather(_shard(d["ag0_bi"], 0, rank, N), 0),
             "ag1_bi": bi.all_gather(_shard(d["ag1_bi"], 1, rank, N), 1),
             "rs": fab.reduce_scatter(mine("rs"), 0),
             "rs_bi": bi.reduce_scatter(mine("rs_bi"), 0),
             "ar": fab.all_reduce(mine("ar")),
             "a2a": fab.all_to_all(mine("a2a")),
             "shift": fab.shift(mine("shift"), 1),
             "shift_back": fab.shift(mine("shift"), -1),
             "pod_ag": pod.all_gather(_shard(d["pod_ag"], 0, pod.axis_index(), N), 0),
             "pod_rs": pod.reduce_scatter(mine("pod_rs"), 0),
             "axis_index": torch.tensor([fab.axis_index(), pod.axis_index()]),
             "pmax": pod.pmax(torch.tensor([float(rank)]))}
        # the adjoint: d/dx sum(w * AG(x)) is RS(w)
        x = _shard(d["adj_x"], 0, rank, N).requires_grad_()
        (mine("adj_w") * fab.all_gather(x, 0)).sum().backward()
        r["adj_grad"], r["adj_rs"] = x.grad, fab.reduce_scatter(mine("adj_w"), 0)
        out.update({f"{kind}/{k}": v.detach().numpy() for k, v in r.items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fabric")
    run_ranks(_rank_main, N, tmp, str(tmp))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]


@pytest.fixture(scope="module")
def jax_ref(mesh_data8):
    """Each rank's result of the JAX package's photonic rings, stacked [N, ...]."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core.fabric import Fabric as JFabric

    mesh_pod = jax.make_mesh((2, N // 2), ("pod", "data"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    d = _data()

    def per_rank(mesh, axes, f, x, in_spec):
        g = lambda s: f(s)[None]  # noqa: E731
        out = P(axes if len(axes) > 1 else axes[0])
        return np.asarray(jax.jit(jax.shard_map(g, mesh=mesh, in_specs=in_spec, out_specs=out,
                                                axis_names=set(axes), check_vma=False))(
            jnp.asarray(x)))

    fab = JFabric(("data",), (N,), "photonic")
    bi = JFabric(("data",), (N,), "photonic", bidirectional=True)
    pod = JFabric(("pod", "data"), (2, N // 2), "photonic")
    m, ax = mesh_data8, ("data",)
    rows, cols = P("data", None), P(None, "data")
    stack = lambda f: lambda s: f(s[0])  # noqa: E731  one rank's slice of a [N, ...] input
    return {
        "ag0": per_rank(m, ax, lambda s: fab.all_gather(s, 0), d["ag0"], rows),
        "ag1": per_rank(m, ax, lambda s: fab.all_gather(s, 1), d["ag1"], cols),
        "ag0_bi": per_rank(m, ax, lambda s: bi.all_gather(s, 0), d["ag0_bi"], rows),
        "ag1_bi": per_rank(m, ax, lambda s: bi.all_gather(s, 1), d["ag1_bi"], cols),
        "rs": per_rank(m, ax, stack(lambda s: fab.reduce_scatter(s, 0)), d["rs"], P("data")),
        "rs_bi": per_rank(m, ax, stack(lambda s: bi.reduce_scatter(s, 0)), d["rs_bi"],
                          P("data")),
        "ar": per_rank(m, ax, stack(fab.all_reduce), d["ar"], P("data")),
        "a2a": per_rank(m, ax, stack(fab.all_to_all), d["a2a"], P("data")),
        "shift": per_rank(m, ax, stack(lambda s: fab.shift(s, 1)), d["shift"], P("data")),
        "shift_back": per_rank(m, ax, stack(lambda s: fab.shift(s, -1)), d["shift"],
                               P("data")),
        "pod_ag": per_rank(mesh_pod, ("pod", "data"), lambda s: pod.all_gather(s, 0),
                           d["pod_ag"], P(("pod", "data"), None)),
        "pod_rs": per_rank(mesh_pod, ("pod", "data"), stack(lambda s: pod.reduce_scatter(s, 0)),
                           d["pod_rs"], P(("pod", "data"))),
    }


@pytest.mark.parametrize("case", ["ag0", "ag1", "ag0_bi", "ag1_bi", "rs", "rs_bi", "ar",
                                  "a2a", "shift", "shift_back", "pod_ag", "pod_rs"])
def test_photonic_rings_match_jax(port, jax_ref, case):
    for r in range(N):
        np.testing.assert_array_equal(port[r][f"photonic/{case}"], jax_ref[case][r],
                                      err_msg=f"rank {r}")


def test_gathers_rebuild_the_global_array(port):
    d = _data()
    for r in range(N):
        for case in ("ag0", "ag1", "ag0_bi", "ag1_bi", "pod_ag"):
            np.testing.assert_array_equal(port[r][f"photonic/{case}"], d[case])
        assert tuple(port[r]["photonic/axis_index"]) == (r, r)  # pod-major flat index
        assert port[r]["photonic/pmax"][0] == N - 1


@pytest.mark.parametrize("kind", ["photonic", "eps"])
def test_reduce_scatter_is_the_adjoint_of_all_gather(port, kind):
    """Autograd of sum(w * AG(x)) gives RS(w): the gather's backward is the
    ring reduce-scatter."""
    for r in range(N):
        np.testing.assert_array_equal(port[r][f"{kind}/adj_grad"], port[r][f"{kind}/adj_rs"])


@pytest.mark.parametrize("case", ["ag0", "ag1", "ag0_bi", "ag1_bi", "rs", "rs_bi", "ar",
                                  "a2a", "shift", "shift_back", "pod_ag", "pod_rs"])
def test_eps_agrees_with_photonic(port, case):
    """The native collectives give the rings' results (sums to f32 rounding)."""
    for r in range(N):
        np.testing.assert_allclose(port[r][f"eps/{case}"], port[r][f"photonic/{case}"],
                                   rtol=1e-6, atol=1e-6)


def test_size_one_axes_return_their_input():
    fab = Fabric(("pod", "data"), (1, 1))
    x = torch.randn(4, 3)
    for y in (fab.all_gather(x, 1), fab.reduce_scatter(x, 0), fab.all_reduce(x),
              fab.shift(x), Fabric(("data",), (1,)).all_to_all(x)):
        assert y is x
    assert fab.axis_index() == 0
