"""The port's rail-sharded serving against the JAX package's, on the CPU:
batch- and context-sharded decode, prefill and serving's model axis.

Smoke configurations in f32.  Eight gloo ranks are spawned once for the
module (``run_ranks`` from test_torch_fabric.py) and take the reference's
meshes, ("data", "model") of (4, 2) and ("pod", "data", "model") of
(2, 2, 2), and for the model axis ("data", "model") of (2, 4) and (1, 8).
The references: the JAX package's ``make_decode_step`` and
``make_prefill_step`` on ``mesh8`` and ``mesh_pod`` (the twins of
tests/test_serve.py:39-101), and its unsharded ``decode_step`` and
``lm_forward``, on the same parameters (bridged) and tokens (numpy, one
seed); the reference's tolerance, atol 1e-4.  Where the JAX package's
context-sharded decode of a sliding-window model is off (its offset comes
from the step's capacity, not the cache's slots: ROADMAP Queue 3), the port
is held to the unsharded decode and the JAX step's error is shown.  The
driver runs under the 8 ranks as ``examples/serve_decode.py`` runs it, held
to its own run on one process, and its ``--plane-report`` to the JAX
driver's.  Weight-resident decode (``weight_resident``) runs every decode
case again and is held to the gathered step's logits (and yi on mesh8 to
the JAX package's resident step), seamless-m4t-medium's too over its cross
state; each path's rail bytes of one step, read from the fabric's counter
on a mesh of 8 rails, are held to the count its leaves' FSDP dims give
(chip_smoke.py's ``rail_bytes_by_fsdp_dims``).  JAX is imported inside the
fixtures only, so the spawned ranks never load it.
"""
import importlib.util
import io
import json
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fabric import init_rank, run_ranks

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.serve.step import (ServeSetup, init_serve_state, make_decode_step,
                                    make_prefill_step)

ATOL = 1e-4
WORLD, VOCAB = 8, 512  # every smoke configuration's (padded) vocabulary
MESHES = {"4x2": ((4, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")), "1x8": ((1, 8), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
# label -> (arch, mesh, fabric, context_shard, batch, steps, capacity)
DECODES = {"yi/batch/4x2": ("yi_9b", "4x2", "photonic", False, 8, 12, 16),
           "yi/batch/2x2x2": ("yi_9b", "2x2x2", "photonic", False, 8, 12, 16),
           "yi/batch/4x2/eps": ("yi_9b", "4x2", "eps", False, 8, 12, 16),
           "yi/context/4x2": ("yi_9b", "4x2", "photonic", True, 1, 12, 16),
           "mamba/context/4x2": ("mamba2_370m", "4x2", "photonic", True, 1, 6, 16),
           "danube/context/4x2": ("h2o_danube_3_4b", "4x2", "photonic", True, 1, 24, 32),
           "deepseek/model/2x4": ("deepseek_moe_16b", "2x4", "photonic", False, 4, 8, 16),
           "deepseek/model/1x8": ("deepseek_moe_16b", "1x8", "photonic", False, 4, 8, 16),
           "jamba/model/2x4": ("jamba_v0_1_52b", "2x4", "photonic", False, 4, 8, 16),
           "jamba/model/2x2x2": ("jamba_v0_1_52b", "2x2x2", "photonic", False, 4, 8, 16),
           "paligemma/model/2x4": ("paligemma_3b", "2x4", "photonic", False, 4, 8, 16)}
# an encoder-decoder over its cross state: (arch, mesh, batch, steps, capacity, frames)
CROSS_DECODE = ("seamless_m4t_medium", "4x2", 8, 6, 16, 8)
# the rail bytes of one step, gathered and resident, on 8 rails: (arch, batch, capacity)
BYTES = ("yi_9b", 8, 16)
# the JAX package's sharded decode of each case that has a twin in tests/test_serve.py
JAX_STEPS = {"yi/batch/4x2": "mesh8", "yi/batch/2x2x2": "mesh_pod", "yi/context/4x2": "mesh8",
             "mamba/context/4x2": "mesh8", "danube/context/4x2": "mesh8"}
# label -> (arch, mesh, batch, seq)
PREFILLS = {"yi/prefill/4x2": ("yi_9b", "4x2", 8, 12),
            "yi/prefill/2x2x2": ("yi_9b", "2x2x2", 8, 12),
            "jamba/prefill/2x2x2": ("jamba_v0_1_52b", "2x2x2", 4, 16)}
# examples/serve_decode.py's three runs (without --plane-report)
DRIVER = {"yi": ["--arch", "yi_9b", "--batch", "8", "--prompt-len", "12", "--gen", "20"],
          "danube": ["--arch", "h2o_danube_3_4b", "--batch", "1", "--prompt-len", "16",
                     "--gen", "16", "--context-shard"],
          "mamba": ["--arch", "mamba2_370m", "--batch", "8", "--prompt-len", "12",
                    "--gen", "20"]}
ARCHS = sorted({a for a, *_ in DECODES.values()} | {a for a, *_ in PREFILLS.values()}
               | {CROSS_DECODE[0]})


def _port_cfg(arch: str):
    return get_config(arch, smoke=True).replace(dtype="float32")


def _f32_config(arch: str, smoke: bool = False):
    """The driver's configuration in f32, as every case here runs."""
    return get_config(arch, smoke=smoke).replace(dtype="float32")


def _tokens(b: int, s: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, VOCAB, (8, 24)).astype(np.int32)[:b, :s]


def _shards(ref_params: dict, step) -> dict:
    fab, tp = step.fabric, step.model
    return bridge.shards_from_numpy(ref_params, fab.axis_index(), fab.n_shards, "cpu", "float32",
                                    model_index=0 if tp is None else tp.rank,
                                    model_size=1 if tp is None else tp.size)


def _decode_rank(mesh, label, tmp, resident: bool = False) -> np.ndarray:
    """The global batch's logits [B, steps, V] of one decode case."""
    arch, _, fabric, context, b, s, cap = DECODES[label]
    cfg = _port_cfg(arch)
    setup = ServeSetup(cfg=cfg, fabric=fabric, context_shard=context, weight_resident=resident)
    step = make_decode_step(setup, mesh, tf.init_lm(cfg, device="meta"), batch=b, capacity=cap)
    params = _shards(dict(np.load(os.path.join(tmp, f"{arch}.npz"))), step)
    state = init_serve_state(setup, mesh, params, b, cap)
    toks = torch.from_numpy(_tokens(b, s)).long()
    outs = []
    for t in range(s):
        lg, state = step(params, state, toks[:, t:t + 1], t)
        outs.append(lg[:, 0] if context else step.fabric.all_gather(lg[:, 0], 0))
    return torch.stack(outs, 1).numpy()


def _cross_decode_rank(mesh, tmp, resident: bool) -> np.ndarray:
    """seamless-m4t-medium's decode over the cross state of encoded frames
    (the whole batch's, made from the global parameters on every rank)."""
    arch, _, b, s, cap, n_frames = CROSS_DECODE
    cfg = _port_cfg(arch)
    ref_params = dict(np.load(os.path.join(tmp, f"{arch}.npz")))
    frames = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, n_frames, cfg.frontend.d_embed)).astype(np.float32))
    full = bridge.from_numpy(ref_params, "cpu", "float32")
    cross = tf.init_cross_state(full, tf.encode(full, frames, cfg), cfg)
    setup = ServeSetup(cfg=cfg, weight_resident=resident)
    step = make_decode_step(setup, mesh, tf.init_lm(cfg, device="meta"), batch=b, capacity=cap)
    params = _shards(ref_params, step)
    state = init_serve_state(setup, mesh, params, b, cap)
    toks = torch.from_numpy(_tokens(b, s)).long()
    outs = []
    for t in range(s):
        lg, state = step(params, state, toks[:, t:t + 1], t, cross)
        outs.append(step.fabric.all_gather(lg[:, 0], 0))
    return torch.stack(outs, 1).numpy()


def _bytes_rank(mesh, tmp) -> dict:
    """Each path's bytes this rank sends over the rails in one decode step
    (the fabric's counter), the gathered's and the resident's."""
    arch, b, cap = BYTES
    cfg = _port_cfg(arch)
    out = {}
    for resident in (False, True):
        setup = ServeSetup(cfg=cfg, weight_resident=resident)
        step = make_decode_step(setup, mesh, tf.init_lm(cfg, device="meta"), batch=b,
                                capacity=cap)
        params = _shards(dict(np.load(os.path.join(tmp, f"{arch}.npz"))), step)
        state = init_serve_state(setup, mesh, params, b, cap)
        step.fabric.reset_bytes()
        step(params, state, torch.from_numpy(_tokens(b, 1)).long(), 0)
        out[f"bytes/{'resident' if resident else 'gathered'}"] = step.fabric.bytes_sent
    return out


def _prefill_rank(mesh, label, tmp) -> np.ndarray:
    arch, _, b, s = PREFILLS[label]
    cfg = _port_cfg(arch)
    step = make_prefill_step(ServeSetup(cfg=cfg), mesh, tf.init_lm(cfg, device="meta"))
    params = _shards(dict(np.load(os.path.join(tmp, f"{arch}.npz"))), step)
    lg = step(params, {"tokens": torch.from_numpy(_tokens(b, s)).long()})
    return step.fabric.all_gather(lg, 0).numpy()


def _layout_rank(mesh) -> dict:
    """Cache shapes on (4, 2) (danube: a 16-slot ring of 2 kv heads, model
    2; mamba: 8 SSD heads) and the refusals a mesh makes."""
    out = {}
    for arch, context in (("h2o_danube_3_4b", False), ("h2o_danube_3_4b", True),
                          ("mamba2_370m", True)):
        cfg = _port_cfg(arch)
        params = {"embed": torch.zeros(1)}
        st = init_serve_state(ServeSetup(cfg=cfg, context_shard=context), mesh, params,
                              8 if not context else 1, 32)
        out[f"layout/{arch}/{context}"] = json.dumps([list(v.shape) for v in st[0].values()])
    cfg = _port_cfg("yi_9b")
    tpl = tf.init_lm(cfg, device="meta")
    for label, fn in (("decode", lambda: make_decode_step(ServeSetup(cfg=cfg), mesh, tpl,
                                                          batch=6, capacity=16)),
                      ("state", lambda: init_serve_state(ServeSetup(cfg=cfg), mesh,
                                                         {"embed": torch.zeros(1)}, 6, 16)),
                      ("context", lambda: make_decode_step(
                          ServeSetup(cfg=cfg, context_shard=True), mesh, tpl, batch=1,
                          capacity=18))):
        try:
            fn()
            out[f"refused/{label}"] = ""
        except ValueError as e:
            out[f"refused/{label}"] = str(e)
    return out


def _rank_main(rank, world, store, tmp):
    from torch.distributed.device_mesh import init_device_mesh
    init_rank(rank, world, store)
    meshes = {k: init_device_mesh("cpu", shape, mesh_dim_names=dims)
              for k, (shape, dims) in MESHES.items()}
    out = {}
    for label, (_, mesh, *_) in DECODES.items():
        out[label] = _decode_rank(meshes[mesh], label, tmp)
        out[f"{label}/resident"] = _decode_rank(meshes[mesh], label, tmp, resident=True)
    for resident in (False, True):
        out[f"cross/{resident}"] = _cross_decode_rank(meshes[CROSS_DECODE[1]], tmp, resident)
    out.update(_bytes_rank(meshes["8x1"], tmp))
    for label, (_, mesh, *_) in PREFILLS.items():
        out[label] = _prefill_rank(meshes[mesh], label, tmp)
    out.update(_layout_rank(meshes["4x2"]))
    launch_serve.get_config = _f32_config
    for name, argv in DRIVER.items():
        printed = io.StringIO()
        with redirect_stdout(printed):
            res = launch_serve.main(argv + ["--smoke", "--device", "cpu", "--mesh", "4x2",
                                            "--plane-report"])
        out[f"driver/{name}/logits"] = res["logits"].numpy()
        out[f"driver/{name}/continuation"] = res["continuation"].numpy()
        reports = [None] * world
        dist.all_gather_object(reports, printed.getvalue())
        out[f"driver/{name}/printed"] = np.array(reports)
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), **out)
    dist.destroy_process_group()


def _flat(tree) -> dict:
    import jax

    from repro.parallel.sharding import _path_str
    return {_path_str(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_run(mesh8, mesh_pod, tmp_path_factory):
    """Every case's parameters; the JAX package's unsharded decode and
    forward of each case, and its sharded steps on its meshes."""
    import jax

    from repro import compat
    tmp = tmp_path_factory.mktemp("serve_sharded")
    rng = jax.random.PRNGKey(0)
    # the sharded steps' capability probe, made outside any mesh context
    # (inside one it reads False and the steps fall back to GSPMD)
    saved, compat._PARTIAL_MANUAL = compat._PARTIAL_MANUAL, None
    try:
        assert compat.supports_partial_manual()
        return _jax_references(tmp, rng, mesh8, mesh_pod)
    finally:
        compat._PARTIAL_MANUAL = saved


def _jax_references(tmp, rng, mesh8, mesh_pod) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_config
    from repro.models import transformer as T
    from repro.serve.step import ServeSetup as JServe
    from repro.serve.step import init_serve_state as jinit_state
    from repro.serve.step import make_decode_step as jdecode
    from repro.serve.step import make_prefill_step as jprefill
    from repro.train.step import TrainSetup as JTrain
    from repro.train.step import init_sharded_state as jinit
    cfgs = {a: jax_config(a, smoke=True).replace(dtype="float32") for a in ARCHS}
    params = {a: T.init_lm(rng, c) for a, c in cfgs.items()}
    for a, p in params.items():
        np.savez(tmp / f"{a}.npz", **_flat(p))
    meshes = {"mesh8": mesh8, "mesh_pod": mesh_pod}
    out, unsharded = {"tmp": tmp}, {}
    for label, (arch, _, fabric, context, b, s, cap) in DECODES.items():
        cfg, toks = cfgs[arch], _tokens(b, s)
        if (arch, b, s, cap) not in unsharded:
            step = jax.jit(lambda p, st, tok, pos, cfg=cfg: T.decode_step(p, st, tok, pos, cfg))
            st, outs = T.init_decode_state(cfg, b, cap), []
            for t in range(s):
                lg, st = step(params[arch], st, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
                outs.append(np.asarray(lg[:, 0]))
            unsharded[arch, b, s, cap] = np.stack(outs, 1)
        out[f"{label}/unsharded"] = unsharded[arch, b, s, cap]
        if label not in JAX_STEPS:
            continue
        mesh = meshes[JAX_STEPS[label]]
        tpl = jax.eval_shape(lambda cfg=cfg: T.init_lm(rng, cfg))
        with jax.set_mesh(mesh):
            sp, _, _ = jinit(JTrain(cfg=cfg, fabric=fabric), mesh, rng)
            setup = JServe(cfg=cfg, fabric=fabric, context_shard=context)
            st = jinit_state(setup, mesh, sp, b, cap)
            dstep = jax.jit(jdecode(setup, mesh, tpl, batch=b, capacity=cap))
            outs = []
            for t in range(s):
                lg, st = dstep(sp, st, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
                outs.append(np.asarray(lg[:, 0]))
        out[f"{label}/jax_step"] = np.stack(outs, 1)
        if label != "yi/batch/4x2":
            continue
        with jax.set_mesh(mesh):  # the JAX package's weight-resident step (GSPMD)
            sp, _, _ = jinit(JTrain(cfg=cfg, fabric=fabric), mesh, rng)
            setup = JServe(cfg=cfg, fabric=fabric, weight_resident=True)
            st = jinit_state(setup, mesh, sp, b, cap)
            dstep = jax.jit(jdecode(setup, mesh, tpl, batch=b, capacity=cap))
            outs = []
            for t in range(s):
                lg, st = dstep(sp, st, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
                outs.append(np.asarray(lg[:, 0]))
        out[f"{label}/jax_resident"] = np.stack(outs, 1)
    for label, (arch, mesh, b, s) in PREFILLS.items():
        cfg, toks = cfgs[arch], jnp.asarray(_tokens(b, s))
        out[f"{label}/unsharded"] = np.asarray(
            T.lm_forward(params[arch], {"tokens": toks}, cfg, last_only=True)[0])
        if arch != "yi_9b":
            continue
        jm = meshes["mesh8" if mesh == "4x2" else "mesh_pod"]
        tpl = jax.eval_shape(lambda cfg=cfg: T.init_lm(rng, cfg))
        with jax.set_mesh(jm):
            sp, _, _ = jinit(JTrain(cfg=cfg), jm, rng)
            out[f"{label}/jax_step"] = np.asarray(
                jax.jit(jprefill(JServe(cfg=cfg), jm, tpl))(sp, {"tokens": toks}))
    return out


@pytest.fixture(scope="module")
def port(jax_run):
    tmp = jax_run["tmp"]
    run_ranks(_rank_main, WORLD, tmp, str(tmp), timeout=420.0)
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def one_process():
    """The driver's runs on one process (a gloo group of one, 1 x 1)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launch_serve, "get_config", _f32_config)
        return {name: launch_serve.main(argv + ["--smoke", "--device", "cpu"])
                for name, argv in DRIVER.items()}


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ---- decode and prefill on the reference's meshes ----

@pytest.mark.parametrize("label", ["yi/batch/4x2", "yi/batch/2x2x2", "yi/batch/4x2/eps"])
def test_batch_sharded_decode_matches_jax(jax_run, port, label):
    """The twin of tests/test_serve.py::test_batch_sharded_decode, on (4, 2)
    and (2, 2, 2), photonic and eps: the JAX package's sharded step and its
    unsharded decode."""
    _close(port[label], jax_run[f"{label}/unsharded"])
    if f"{label}/jax_step" in jax_run:
        _close(port[label], jax_run[f"{label}/jax_step"])


def test_context_sharded_decode_matches_jax(jax_run, port):
    """The twin of test_context_sharded_decode (yi, B=1, 16 slots as 4
    shards of 4, a model axis of 2)."""
    _close(port["yi/context/4x2"], jax_run["yi/context/4x2/jax_step"])
    _close(port["yi/context/4x2"], jax_run["yi/context/4x2/unsharded"])


def test_context_sharded_ssm_decode_matches_jax(jax_run, port):
    """The twin of test_context_sharded_ssm_decode: the SSM caches are
    whole on every rail, the SSD heads split over the model axis."""
    _close(port["mamba/context/4x2"], jax_run["mamba/context/4x2/jax_step"])
    _close(port["mamba/context/4x2"], jax_run["mamba/context/4x2/unsharded"])


@pytest.mark.parametrize("label", list(PREFILLS))
def test_prefill_matches_jax(jax_run, port, label):
    """The twin of test_prefill on (4, 2) and (2, 2, 2), and jamba's
    (SSD, MoE and attention) on (2, 2, 2)."""
    _close(port[label], jax_run[f"{label}/unsharded"])
    if f"{label}/jax_step" in jax_run:
        _close(port[label], jax_run[f"{label}/jax_step"])


@pytest.mark.parametrize("label", [k for k in DECODES if "/model/" in k])
def test_model_axis_decode_matches_jax(jax_run, port, label):
    """Decode with a model axis of 4 or 8: deepseek (heads and experts
    split at 4; at 8 the heads do not split and attention runs replicated,
    one expert a rank), jamba (kv replicated at 4, SSD heads split) and
    paligemma (one kv head replicated), against the unsharded decode."""
    _close(port[label], jax_run[f"{label}/unsharded"])


def test_sliding_window_context_shard_follows_the_unsharded_decode(jax_run, port):
    """h2o-danube smoke (window 16) on (4, 2) at capacity 32: the port
    matches the unsharded decode at every position; the JAX package's
    sharded step loses the tokens from position 4 on (ROADMAP Queue 3)."""
    got, want = port["danube/context/4x2"], jax_run["danube/context/4x2/unsharded"]
    jstep = jax_run["danube/context/4x2/jax_step"]
    _close(got, want)
    err = np.abs(jstep - want).max(-1)[0]
    assert err[:4].max() < ATOL and err[4:].min() > 1.0, err


def test_cache_layouts_and_refusals(port):
    """danube on (4, 2): batch-sharded 8 -> 2 rows of a 16-slot ring, one
    kv head of 2 a model rank; context-sharded 16 / 4 rails = 4 slots;
    mamba context-sharded: the SSM caches whole over the rails, 4 of 8 SSD
    heads and their conv channels (2 x 64 + 2 x 16 of 160) a model rank.  A
    batch or a cache the rails do not divide raises."""
    def shapes(key):
        return json.loads(str(port[key]))
    assert shapes("layout/h2o_danube_3_4b/False") == [[2, 2, 16, 1, 8], [2, 2, 16, 1, 8],
                                                      [2, 16]]
    assert shapes("layout/h2o_danube_3_4b/True") == [[2, 1, 4, 1, 8], [2, 1, 4, 1, 8], [2, 4]]
    assert shapes("layout/mamba2_370m/True") == [[2, 1, 3, 96], [2, 1, 4, 16, 16]]
    for label in ("decode", "state", "context"):
        assert "do not split over 4" in str(port[f"refused/{label}"]) or \
            "does not split over 4" in str(port[f"refused/{label}"]), label


# ---- the driver: examples/serve_decode.py's runs on 8 ranks ----

@pytest.mark.parametrize("name", list(DRIVER))
def test_serve_driver_on_8_ranks_matches_one_process(port, one_process, name):
    _close(port[f"driver/{name}/logits"], one_process[name]["logits"].numpy())
    np.testing.assert_array_equal(port[f"driver/{name}/continuation"],
                                  one_process[name]["continuation"].numpy())


# ---- the stats pass and its merge (no ranks) ----

def _decode_inputs(b, c, h, kv, dh, seed, n_valid=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, c, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, c, kv, dh)).astype(np.float32)
    valid = rng.random((b, c)) < 0.8
    if n_valid is not None:
        valid[:, n_valid:] = False
    return q, k, v, valid


@pytest.mark.parametrize("b,c,h,kv,dh", [(2, 96, 8, 2, 16), (1, 1000, 4, 4, 32),
                                         (3, 300, 16, 1, 8)])
def test_decode_stats_match_jax(b, c, h, kv, dh):
    """``ops.decode_attention(return_stats=True)`` on CPU tensors (the plain
    version) against the JAX package's ``ref.decode_attention``'s stats, a
    ragged cache (1000, 300 slots) included; it launches nothing."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    q, k, v, valid = _decode_inputs(b, c, h, kv, dh, seed=c)
    ops.reset_launch_counts()
    got = ops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v, valid)),
                               return_stats=True)
    want = jref.decode_attention(*(jnp.asarray(x) for x in (q, k, v, valid)),
                                 return_stats=True)
    assert set(ops.launch_counts().values()) == {0}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    assert ref.stats_tolerance_ratio(got, tuple(torch.from_numpy(np.array(w)) for w in want),
                                     torch.float32) <= 1


class _Stacked:
    """The rails as a stacked leading dim: pmax and all_reduce over dim 0."""

    @staticmethod
    def pmax(x):
        return x.amax(0, keepdim=True).expand_as(x)

    @staticmethod
    def all_reduce(x):
        return x.sum(0, keepdim=True).expand_as(x)


@pytest.mark.parametrize("n_valid", [380, 100, 384])
def test_merge_over_4_emulated_shards_matches_jax(n_valid):
    """A 384-slot cache as 4 shards of 96: each shard's stats (the plain
    version), merged by ``merge_decode_stats``, against the JAX package's
    whole-cache ``ref.decode_attention``.  At 100 valid slots shards 2 and
    3 hold none; dropping a live shard, or the rescale, must fail."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    q, k, v, valid = _decode_inputs(2, 384, 8, 2, 16, seed=n_valid, n_valid=n_valid)
    want = np.asarray(jref.decode_attention(*(jnp.asarray(x) for x in (q, k, v, valid))))
    qt = torch.from_numpy(q)
    shards = [ops.decode_attention(qt, torch.from_numpy(k[:, i:i + 96]),
                                   torch.from_numpy(v[:, i:i + 96]),
                                   torch.from_numpy(valid[:, i:i + 96]), return_stats=True)
              for i in range(0, 384, 96)]
    acc, m, l = (torch.stack(x) for x in zip(*shards))
    empty = (m <= ref.NEG_INF / 2).flatten(1).all(1).tolist()
    assert empty == [False, False, n_valid <= 192, n_valid <= 288]
    got = attn.merge_decode_stats(acc, m, l, _Stacked)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    dropped = attn.merge_decode_stats(acc[1:], m[1:], l[1:], _Stacked)[0]
    assert np.abs(dropped.numpy() - want).max() > 1e-2
    plain_sum = (acc.sum(0) / l.sum(0)[..., None]).flatten(-3, -2).unsqueeze(-3)
    assert np.abs(plain_sum.numpy() - want).max() > 1e-2


def test_context_slot_follows_the_ring():
    """Full cache: position p on shard p // local_cap; a sliding window's
    ring of n * local_cap slots wraps first, then splits."""
    assert attn.context_slot(13, 4, 3, 4, None) == (True, 1)
    assert attn.context_slot(13, 4, 2, 4, None)[0] is False
    pos = torch.arange(40)
    owners = [attn.context_slot(pos, 4, i, 4, 16)[0] for i in range(4)]
    assert torch.stack(owners).sum(0).tolist() == [1] * 40
    owned, slot = attn.context_slot(pos, 4, 1, 4, 16)
    assert pos[owned].tolist() == [4, 5, 6, 7, 20, 21, 22, 23, 36, 37, 38, 39]
    assert slot[owned].tolist() == [0, 1, 2, 3] * 3


def test_weight_resident_is_refused_by_name(yi_params):
    """``weight_resident``, refused until weight-resident decode was ported,
    changes nothing but the decode step: ``init_serve_state`` lays out the
    same caches and ``make_prefill_step`` runs the gathered prefill (the
    reference's ignores the flag); a batch the rails do not divide still
    raises."""
    cfg, params = yi_params
    resident, gathered = ServeSetup(cfg=cfg, weight_resident=True), ServeSetup(cfg=cfg)
    for setup in (resident, ServeSetup(cfg=cfg, context_shard=True, weight_resident=True)):
        plain = ServeSetup(cfg=cfg, context_shard=setup.context_shard)
        got = init_serve_state(setup, (1, 1), params, 2, 16)
        want = init_serve_state(plain, (1, 1), params, 2, 16)
        assert [[v.shape for v in c.values()] for c in got] == \
            [[v.shape for v in c.values()] for c in want]
    toks = {"tokens": torch.from_numpy(_tokens(2, 12)).long()}
    assert torch.equal(make_prefill_step(resident, (1, 1), params)(params, toks),
                       make_prefill_step(gathered, (1, 1), params)(params, toks))
    with pytest.raises(ValueError, match="batch 6 does not split over 8 rails"):
        make_decode_step(resident, _EightRails(), params, batch=6, capacity=16)


class _EightRails:
    """A mesh's shape without its process groups: 8 rails, a model axis of 1."""
    mesh_dim_names, shape = ("data", "model"), (8, 1)

    def size(self, i: int) -> int:
        return self.shape[i]

    def get_group(self, name):
        return None


@pytest.fixture(scope="module")
def yi_params():
    cfg = _port_cfg("yi_9b")
    return cfg, tf.init_lm(cfg, seed=0, device="cpu")


# ---- weight-resident decode on the 8 ranks ----

@pytest.mark.parametrize("label", list(DECODES))
def test_resident_decode_matches_the_gathered_step(jax_run, port, label):
    """Every decode case with the weights resident: the gathered step's
    logits (and the JAX package's unsharded decode's), at atol 1e-4."""
    _close(port[f"{label}/resident"], port[label])
    _close(port[f"{label}/resident"], jax_run[f"{label}/unsharded"])


def test_resident_decode_matches_the_jax_resident_step(jax_run, port):
    """yi on (4, 2): the JAX package's ``make_decode_step(weight_resident=True)``
    (its GSPMD step) on the same bridged parameters."""
    _close(port["yi/batch/4x2/resident"], jax_run["yi/batch/4x2/jax_resident"])


def test_resident_decode_over_a_cross_state(port):
    """seamless-m4t-medium on (4, 2), the cross state of encoded frames
    passed whole: the resident step gives the gathered step's logits."""
    _close(port["cross/True"], port["cross/False"])
    assert np.isfinite(port["cross/True"]).all()


def test_rail_bytes_a_step_follow_the_fsdp_dims(port):
    """yi smoke (f32) on 8 rails, B=8: the fabric's byte counter of one step
    equals the count by the leaves' FSDP dims, for the gathered step (every
    sharded leaf, 7/8 of it) and the resident one (activation partials and
    slices, the small leaves, the attention rows); the resident moves less."""
    cs = _chip_smoke()
    arch, b, _ = BYTES
    for path, resident in (("gathered", False), ("resident", True)):
        assert int(port[f"bytes/{path}"]) == cs.rail_bytes_by_fsdp_dims(
            _port_cfg(arch), b, 8, resident), path
    assert int(port["bytes/resident"]) < int(port["bytes/gathered"])


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(DRIVER))
def test_serve_driver_plane_report_on_8_ranks(port, name):
    """``--plane-report`` under 8 ranks of ``--mesh 4x2``: rank 0 prints what
    the JAX driver's ``plane_report`` prints for that mesh, with the decode
    capacity as the sequence length; the other ranks print no report."""
    from test_torch_plane import jax_report
    argv = DRIVER[name]
    batch = int(argv[argv.index("--batch") + 1])
    cap = int(argv[argv.index("--prompt-len") + 1]) + int(argv[argv.index("--gen") + 1])
    printed = [str(x) for x in port[f"driver/{name}/printed"]]
    want, _ = jax_report(argv[1], {"data": 4, "model": 2}, batch, cap, 0.05)
    assert printed[0].endswith(want)
    assert all("control plane report" not in p for p in printed[1:])
