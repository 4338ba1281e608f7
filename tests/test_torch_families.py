"""The port's VLM and audio families (paligemma-3b's and seamless-m4t-medium's
SMOKE) and the whole model zoo against the JAX package, on the CPU.

Parameters come from the JAX package's ``init_lm`` and reach the port
through ``repro_torch.bridge``; tokens, patches and frames are made with
numpy from a seed.  f32 throughout but where a test says bf16.  Tolerances
as for the other families: logits within ``ATOL`` = 1e-4
(tests/test_torch_serve.py), gradients per leaf by relative RMS <=
``GRAD_RTOL`` = 1e-4 (tests/test_torch_train.py), decode against the
forward within 2e-3 (tests/test_models.py).  The distributed gradients run
on four spawned gloo ranks once for the module (``run_ranks`` from
tests/test_torch_fabric.py); JAX is imported inside fixtures and tests only,
so the ranks never load it.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fabric import init_rank, run_ranks

from repro_torch import bridge
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tf
from repro_torch.serve.step import (ServeSetup, init_serve_state, make_decode_step,
                                    make_prefill_step)
from repro_torch.train.data import DataConfig, synth_batch
from repro_torch.train.step import TrainSetup, gather_tree, make_train_step
from repro_torch.tree import tree_map

ATOL = 1e-4
GRAD_RTOL = 1e-4   # per leaf, relative RMS
FAMILIES = ("paligemma_3b", "seamless_m4t_medium")
B, S, WORLD = 8, 16, 4   # the distributed step's global batch, as in test_torch_train.py


def _flat(params, leaf=np.asarray) -> dict:
    import jax

    from repro.parallel.sharding import _path_str
    return {_path_str(p): leaf(x) for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}


def _rel_rms(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def _cfgs(arch: str, dtype: str = "float32"):
    from repro.configs.base import get_config as jax_config
    return (jax_config(arch, smoke=True).replace(dtype=dtype),
            get_config(arch, smoke=True).replace(dtype=dtype))


def _batch(cfg, b: int, s: int, seed: int = 1) -> dict:
    """numpy tokens, targets and the family's patches or frames."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
           for k in ("tokens", "targets")}
    extra = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
    if extra:
        out[extra] = rng.standard_normal((b, cfg.frontend.n_tokens, cfg.frontend.d_embed),
                                         dtype=np.float32)
    return out


def _jax(batch: dict) -> dict:
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(JAX config, port config, JAX parameters, port parameters), f32."""
    import jax

    from repro.models import transformer as T
    jcfg, tcfg = _cfgs(request.param)
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, bridge.from_numpy(_flat(jparams), "cpu", "float32")


class _Spy:
    """Counts calls of an ``ops`` entry, to show which branch the path took."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        fn = getattr(ops, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        monkeypatch.setattr(ops, name, wrapped)


# ---- the parameter tree and the bridge ----

@pytest.mark.parametrize("arch", FAMILIES)
def test_bridge_keeps_the_jax_dtypes_and_shapes_in_bf16(arch):
    """The JAX package's bf16 SMOKE tree bridges leaf by leaf with its dtypes
    and shapes (the norms, the cross-attention's pre-norm ``norm_x`` among
    them, f32; the rest bf16) and its values, and comes back with its paths
    (``frontend_proj``, ``encoder/layers/<i>/...``)."""
    import jax

    from repro.models import transformer as T
    jcfg, _ = _cfgs(arch, "bfloat16")
    jflat = _flat(T.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = bridge.flatten(bridge.from_numpy(jflat, "cpu", dtype="bfloat16"))
    assert set(tp) == set(jflat) == set(bridge.to_numpy(bridge.from_numpy(jflat, "cpu")))
    assert "frontend_proj" in tp
    for path, arr in jflat.items():
        leaf = tp[path]
        assert str(leaf.dtype).replace("torch.", "") == str(arr.dtype), path
        assert tuple(leaf.shape) == arr.shape, path
        assert torch.equal(leaf.float(), torch.from_numpy(np.array(arr, np.float32))), path
    norm_x = [p for p in tp if p.endswith("/norm_x")]
    assert bool(norm_x) == (arch == "seamless_m4t_medium")
    assert all(tp[p].dtype == torch.float32 for p in norm_x)
    if arch == "seamless_m4t_medium":
        assert {"encoder/final_norm", "encoder/layers/0/mixer/wq", "layers/0/cross/wk"} <= set(tp)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_builds_the_jax_tree(arch, dtype):
    """Paths, shapes and dtypes of the port's ``init_lm``, real and on the meta
    device, equal the JAX package's, at SMOKE and (on the meta device) at the
    full configuration."""
    import jax

    from repro.configs.base import get_config as jax_config
    from repro.models import transformer as T
    jcfg, tcfg = _cfgs(arch, dtype)
    for jc, tc, devices in ((jcfg, tcfg, ("cpu", "meta")),
                            (jax_config(arch).replace(dtype=dtype),
                             get_config(arch).replace(dtype=dtype), ("meta",))):
        want = jax.eval_shape(lambda c=jc: T.init_lm(jax.random.PRNGKey(0), c))
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(want, lambda x: x).items()}
        for device in devices:
            got = bridge.flatten(tf.init_lm(tc, device=device))
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in got.items()} == want, (device, tc.name)


# ---- forward and gradient over the whole zoo ----

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_smoke_forward_and_grad_match_jax(arch):
    """The twin of tests/test_models.py::test_smoke_forward_and_grad over
    every architecture of the zoo: the logits, the loss and every leaf's
    gradient against the JAX package's ``lm_forward`` and
    ``jax.value_and_grad`` of its ``lm_loss``, B=2, S=16."""
    import jax

    from repro.models import transformer as T
    jcfg, tcfg = _cfgs(arch)
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    batch = _batch(tcfg, 2, 16)
    jb = _jax(batch)

    def loss_and_logits(p, b):  # one compiled function: the loss, its metrics, the logits
        loss, m = T.lm_loss(p, b, jcfg)
        return loss, (m, T.lm_forward(p, b, jcfg)[0])
    (jloss, (jm, jl)), jg = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))(
        jparams, jb)
    params = tree_map(lambda t: t.requires_grad_(),
                      bridge.from_numpy(_flat(jparams), "cpu", "float32"))
    tb = _torch(batch)
    logits, _ = tf.lm_forward(params, tb, tcfg)
    assert logits.shape[:2] == (2, 16)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    loss, m = tf.lm_loss(params, tb, tcfg)
    assert np.isfinite(loss.item())
    assert abs(loss.item() - float(jloss)) < 1e-4
    assert abs(m["ce"].item() - float(jm["ce"])) < 1e-4
    loss.backward()
    grads = bridge.to_numpy(tree_map(lambda t: t.grad, params))
    want = _flat(jg)
    assert set(grads) == set(want)
    for path, w in want.items():
        assert np.isfinite(grads[path]).all(), path
        assert _rel_rms(grads[path], w) <= GRAD_RTOL, path


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradient_through_the_flash_path_match_jax(arch, monkeypatch):
    """At 1024 positions (paligemma: 16 patches + 1008 text tokens) the
    decoder's self-attention takes ``ops.mha``'s autograd function, with the
    prefix block's sdpa over it for the VLM; the encoder's 16 frames and the
    cross-attention stay on the plain sdpa.  Loss and every leaf's gradient
    against the JAX package's, B=1."""
    import jax

    from repro.models import transformer as T
    jcfg, tcfg = _cfgs(arch)
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    s = 1024 - (tcfg.frontend.n_tokens if tcfg.family == "vlm" else 0)
    batch = _batch(tcfg, 1, s, seed=3)
    (jloss, _), jg = jax.jit(jax.value_and_grad(lambda p, b: T.lm_loss(p, b, jcfg),
                                                has_aux=True))(jparams, _jax(batch))
    params = tree_map(lambda t: t.requires_grad_(),
                      bridge.from_numpy(_flat(jparams), "cpu", "float32"))
    spy = _Spy(monkeypatch, "mha")
    loss, _ = tf.lm_loss(params, _torch(batch), tcfg)
    assert spy.calls == tcfg.n_layers
    assert abs(loss.item() - float(jloss)) < 1e-4
    loss.backward()
    grads = bridge.to_numpy(tree_map(lambda t: t.grad, params))
    for path, w in _flat(jg).items():
        assert _rel_rms(grads[path], w) <= GRAD_RTOL, path


# ---- serving: prefill ----

@pytest.mark.parametrize("branch", ["mask", "flash"])
def test_prefill_matches_jax(pair, branch, monkeypatch):
    """``make_prefill_step`` with the batch's patches or frames against the
    JAX package's last-token logits: on 12 text tokens the mask branch (28
    positions with paligemma's 16 patches), at 1024 positions (paligemma: 16
    patches + 1008 text tokens) the flash branch, one ``ops.mha`` call a
    decoder layer (the encoder's 16 frames stay plain)."""
    import jax

    from repro.models import transformer as T
    jcfg, tcfg, jparams, tparams = pair
    n_prefix = tcfg.frontend.n_tokens if tcfg.family == "vlm" else 0
    s = 12 if branch == "mask" else 1024 - n_prefix
    batch = _batch(tcfg, 2, s, seed=4)
    batch.pop("targets")
    want, _ = jax.jit(lambda p, b: T.lm_forward(p, b, jcfg, last_only=True))(jparams, _jax(batch))
    spy = _Spy(monkeypatch, "mha")
    got = make_prefill_step(ServeSetup(cfg=tcfg), (1, 1), tparams)(tparams, _torch(batch))
    assert got.shape == (2, 1, tcfg.vocab_size + (-tcfg.vocab_size) % 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert spy.calls == (tcfg.n_layers if branch == "flash" else 0)
    # the full forward's text positions, and hidden=True, agree with it
    full, _ = tf.lm_forward(tparams, _torch(batch), tcfg)
    hid, _ = tf.lm_forward(tparams, _torch(batch), tcfg, hidden=True)
    assert full.shape[1] == hid.shape[1] == s
    torch.testing.assert_close(full[:, -1:], got, atol=ATOL, rtol=0)
    torch.testing.assert_close(tf.unembed(tparams, hid, tcfg), full, atol=ATOL, rtol=0)


@pytest.mark.parametrize("s", [12, 1024])
def test_attention_prefix_mask_unit(s):
    """The twin of tests/test_models.py::test_attention_prefix_mask_unit, on
    the mask branch (S=12) and the flash branch (S=1024): under prefix-LM row
    0 sees rows 1..3 of a 4-row prefix, causally it does not; the outputs
    equal the JAX package's ``attention``."""
    import jax

    from repro.configs.base import get_config as jax_config
    from repro.models.attention import attention, attn_init
    jcfg = jax_config("yi_9b", smoke=True).replace(dtype="float32")
    tcfg = get_config("yi_9b", smoke=True).replace(dtype="float32")
    jp = attn_init(jax.random.PRNGKey(0), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal((1, s, tcfg.d_model)).astype(np.float32)
    x2 = x.copy()
    x2[0, 3] += 1.0
    pos = np.arange(s)[None]

    jattn = jax.jit(lambda xv, prefix: attention(jp, xv, pos, jcfg, causal=True,
                                                 prefix_len=prefix), static_argnums=1)

    def both(xv, prefix):
        want = jattn(xv, prefix)
        got = tattn.attention(tp, torch.from_numpy(xv), torch.from_numpy(pos), tcfg,
                              causal=True, prefix_len=prefix)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        return got[0, 0]
    assert (both(x, 4) - both(x2, 4)).abs().max().item() > 1e-6
    torch.testing.assert_close(both(x, 0), both(x2, 0), atol=1e-6, rtol=0)


def test_prefix_lm_bidirectional_prefix():
    """The twin of tests/test_models.py::test_prefix_lm_bidirectional_prefix:
    perturbing paligemma's last patch changes the logits, the first text
    position's among them; the port's logits equal the JAX package's."""
    import jax

    from repro.models import transformer as T
    jcfg, tcfg = _cfgs("paligemma_3b")
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_numpy(_flat(jparams), "cpu", "float32")
    batch = _batch(tcfg, 1, 8, seed=6)
    batch2 = dict(batch, patches=batch["patches"].copy())
    batch2["patches"][0, -1] += 10.0
    outs = []
    for b in (batch, batch2):
        want, _ = T.lm_forward(jparams, _jax(b), jcfg)
        got, _ = tf.lm_forward(tparams, _torch(b), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        outs.append(got)
    assert (outs[0][0, 0] - outs[1][0, 0]).abs().max().item() > 1e-6


def test_audio_encdec_cross_attention_used():
    """The twin of tests/test_models.py::test_audio_encdec_cross_attention_used:
    seamless' encoder reaches the logits (frames + 1 changes them), and the
    port's logits equal the JAX package's for both."""
    import jax

    from repro.models import transformer as T
    jcfg, tcfg = _cfgs("seamless_m4t_medium")
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_numpy(_flat(jparams), "cpu", "float32")
    batch = _batch(tcfg, 2, 16, seed=7)
    outs = []
    for b in (batch, dict(batch, frames=batch["frames"] + 1.0)):
        want, _ = T.lm_forward(jparams, _jax(b), jcfg)
        got, _ = tf.lm_forward(tparams, _torch(b), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        outs.append(got)
    assert (outs[0] - outs[1]).abs().max().item() > 1e-6


# ---- serving: decode ----

def _cross(tf_or_T, params, batch, cfg, to):
    """The cross state of the batch's frames (None for a decoder-only model)."""
    if cfg.encoder is None:
        return None
    return tf_or_T.init_cross_state(params, tf_or_T.encode(params, to(batch)["frames"], cfg), cfg)


@pytest.mark.parametrize("cap", [16, 4096])
def test_decode_matches_jax_decode_step(pair, cap, monkeypatch):
    """Teacher-forced ``make_decode_step`` against the JAX package's
    ``decode_step``, both given ``init_cross_state`` of the same frames for
    seamless; at capacity 4096 through ``ops.decode_attention``, once per
    self-attention layer and step (the cross-attention stays plain)."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as T
    jcfg, tcfg, jparams, tparams = pair
    batch = _batch(tcfg, 4, 10, seed=8)
    toks = batch["tokens"]
    jcross = _cross(T, jparams, batch, jcfg, _jax)
    jstep = jax.jit(lambda p, st, tok, pos, cr: T.decode_step(p, st, tok, pos, jcfg,
                                                              cross_state=cr))
    st = T.init_decode_state(jcfg, 4, cap)
    want = []
    for t in range(toks.shape[1]):
        lg, st = jstep(jparams, st, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), jcross)
        want.append(np.asarray(lg[:, 0]))
    setup = ServeSetup(cfg=tcfg)
    state = init_serve_state(setup, (1, 1), tparams, 4, cap)
    step = make_decode_step(setup, (1, 1), tparams, batch=4, capacity=cap)
    cross = _cross(tf, tparams, batch, tcfg, _torch)
    spy = _Spy(monkeypatch, "decode_attention")
    got = []
    for t in range(toks.shape[1]):
        lg, state = step(tparams, state, torch.from_numpy(toks[:, t:t + 1]).long(), t, cross)
        got.append(lg[:, 0].numpy())
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1), atol=ATOL, rtol=0)
    assert spy.calls == (tcfg.n_layers * toks.shape[1] if cap >= 4096 else 0)


def test_seamless_decode_matches_its_prefill():
    """Seamless' teacher-forced decode with the cross state of the frames
    gives its own forward's logits at every position (atol 2e-3, as
    tests/test_models.py::test_decode_matches_forward); the cross state is
    stacked [n_periods, B, frames, KV, dh] and decode leaves it unchanged;
    decode without it raises."""
    import jax

    from repro.models import transformer as T
    jcfg, tcfg = _cfgs("seamless_m4t_medium")
    tparams = bridge.from_numpy(_flat(T.init_lm(jax.random.PRNGKey(0), jcfg)), "cpu", "float32")
    batch = _torch(_batch(tcfg, 2, 12, seed=9))
    fwd, _ = tf.lm_forward(tparams, batch, tcfg)
    cross = tf.init_cross_state(tparams, tf.encode(tparams, batch["frames"], tcfg), tcfg)
    assert [c["k"].shape for c in cross] == [(tcfg.n_layers, 2, tcfg.frontend.n_tokens,
                                             tcfg.n_kv_heads, tcfg.resolved_head_dim)]
    kept = [c["k"].clone() for c in cross]
    state = tf.init_decode_state(tcfg, 2, 12, device="cpu")
    out = []
    for t in range(12):
        lg, state = tf.decode_step(tparams, state, batch["tokens"][:, t:t + 1], t, tcfg,
                                   cross_state=cross)
        out.append(lg)
    np.testing.assert_allclose(torch.cat(out, 1).numpy(), fwd.numpy(), atol=2e-3, rtol=0)
    assert all(torch.equal(c["k"], k) for c, k in zip(cross, kept))
    with pytest.raises(ValueError, match="cross_state"):
        tf.decode_step(tparams, state, batch["tokens"][:, :1], 0, tcfg)


# ---- training ----

@pytest.mark.parametrize("arch", FAMILIES)
def test_synth_batch_matches_jax(arch):
    """Tokens, targets and the patches or frames, bit for bit."""
    from repro.train.data import DataConfig as JDataConfig
    from repro.train.data import synth_batch as jax_synth
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    for step in (0, 7):
        got = synth_batch(tcfg, DataConfig(seq_len=S, global_batch=B), step, device="cpu")
        want = jax_synth(jcfg, JDataConfig(seq_len=S, global_batch=B), step)
        assert set(got) == set(want) == {"tokens", "targets",
                                         "patches" if arch == "paligemma_3b" else "frames"}
        for k, w in want.items():
            assert got[k].numpy().dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))


def _rank_main(rank, world, store, tmp):
    from torch.distributed.device_mesh import init_device_mesh
    init_rank(rank, world, store)
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(tmp, "batch.npz")).items()}
    out = {}
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True).replace(dtype="float32")
        ref = dict(np.load(os.path.join(tmp, f"{arch}.npz")))
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        step = make_train_step(TrainSetup(cfg=cfg), mesh, tf.init_lm(cfg, device="meta"))
        fab = step.fabric
        params = bridge.shards_from_numpy(ref, fab.axis_index(), fab.n_shards, "cpu", "float32")
        extra = "patches" if cfg.family == "vlm" else "frames"
        grads, m = step.grads_fn(params, {k: batch[k] for k in ("tokens", "targets")}
                                 | {extra: batch[f"{arch}/{extra}"]})
        out[f"{arch}/loss"] = float(m["loss"])
        for path, g in bridge.to_numpy(gather_tree(grads, step.fd_tree, fab)).items():
            out[f"{arch}/grad/{path}"] = g
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def distributed(tmp_path_factory):
    """The JAX package's loss and gradients of both families' SMOKE on one
    global batch (B=8, S=16), and the port's from ``grads_fn`` on four gloo
    ranks, each on its two rows, gathered."""
    import jax

    from repro.models import transformer as T
    tmp = tmp_path_factory.mktemp("families")
    rng = np.random.default_rng(10)
    tokens = {k: rng.integers(0, 512, (B, S), dtype=np.int32) for k in ("tokens", "targets")}
    batch_npz, want = dict(tokens), {}
    for arch in FAMILIES:
        jcfg, tcfg = _cfgs(arch)
        extra = "patches" if tcfg.family == "vlm" else "frames"
        feats = rng.standard_normal((B, tcfg.frontend.n_tokens, tcfg.frontend.d_embed),
                                    dtype=np.float32)
        batch_npz[f"{arch}/{extra}"] = feats
        jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
        (loss, _), g = jax.value_and_grad(
            lambda p: T.lm_loss(p, _jax(dict(tokens, **{extra: feats})), jcfg),
            has_aux=True)(jparams)
        np.savez(tmp / f"{arch}.npz", **_flat(jparams))
        want[arch] = {"loss": float(loss), "grads": _flat(g)}
    np.savez(tmp / "batch.npz", **batch_npz)
    run_ranks(_rank_main, WORLD, tmp, str(tmp))
    return want, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("arch", FAMILIES)
def test_distributed_gradients_match_jax(distributed, arch):
    """FSDP over four ranks, the encoder's stack gathered one period at a
    time: the loss (the mean over ranks of each rank's loss on its rows: the
    loss of the whole batch, no aux term here) and every leaf's gathered
    gradient against ``jax.value_and_grad`` of the JAX package's ``lm_loss``.
    A rank that took the whole batch's patches or frames with its two rows of
    tokens would fail on the shapes."""
    want, got = distributed
    assert abs(float(got[f"{arch}/loss"]) - want[arch]["loss"]) < 1e-4
    assert {p for p in want[arch]["grads"]} == {k.split("/grad/", 1)[1] for k in got
                                                if k.startswith(f"{arch}/grad/")}
    for path, w in want[arch]["grads"].items():
        assert _rel_rms(got[f"{arch}/grad/{path}"], w) <= GRAD_RTOL, path


# ---- the drivers ----

@pytest.mark.parametrize("arch", FAMILIES)
def test_train_main_runs_both_families_on_cpu(arch, capsys):
    try:
        loss = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                                  "--batch", "4", "--seq", "16"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert np.isfinite(loss)
    assert "step    1 loss" in capsys.readouterr().out


def test_serve_main_serves_paligemma_on_cpu(capsys):
    """Text-only decode from an empty cache, as the JAX package's driver."""
    out = launch_serve.main(["--arch", "paligemma_3b", "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    assert out["continuation"].shape == (2, 4)
    assert torch.isfinite(out["logits"]).all()
    assert "served 2 seqs x 9 steps" in capsys.readouterr().out


def test_serve_main_refuses_an_encoder_decoder():
    with pytest.raises(NotImplementedError, match="cross state"):
        launch_serve.main(["--arch", "seamless_m4t_medium", "--smoke", "--device", "cpu"])
