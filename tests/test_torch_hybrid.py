"""The port's hybrid family (jamba-v0.1-52b's SMOKE: Mamba-2 and attention
layers, MoE on every other one) against the JAX package's, on the CPU.

Parameters come from the JAX package's ``init_lm`` and reach the port
through ``repro_torch.bridge``; tokens are made with numpy from a seed.  f32
throughout.  Tolerances as for the other families: logits within 1e-4 and
the aux loss within 1e-5 (tests/test_torch_moe.py), gradients per leaf by
relative RMS <= 1e-4 (tests/test_torch_train.py), decode against the
forward at capacity factor 8 within 2e-3 (tests/test_models.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tf
from repro_torch.serve.step import ServeSetup, make_prefill_step
from repro_torch.tree import tree_map

ARCH = "jamba_v0_1_52b"
GRAD_RTOL = 1e-4


def _flat(params, leaf=np.asarray) -> dict:
    import jax

    from repro.parallel.sharding import _path_str
    return {_path_str(p): leaf(x) for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}


def _rel_rms(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def _cfgs(**moe_kw):
    from repro.configs.base import get_config as jax_config
    jcfg = jax_config(ARCH, smoke=True).replace(dtype="float32")
    tcfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    """(JAX config, port config, JAX parameters, port parameters)."""
    import jax

    from repro.models import transformer as T
    jcfg, tcfg = _cfgs()
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, bridge.from_numpy(_flat(jparams), "cpu", "float32")


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


def test_init_lm_builds_the_jax_tree_of_a_mixed_period():
    """One period of the pattern: a Mamba-2 mixer at the "mamba" positions, an
    attention mixer at the "attn" ones, an MoE FFN on the odd positions and a
    dense FFN on the others; paths, shapes and dtypes equal the JAX
    package's, in f32 and bf16, real and on the meta device."""
    import jax

    from repro.configs.base import get_config as jax_config
    from repro.models import transformer as T
    for arch_cfg in (get_config(ARCH, smoke=True), get_config(ARCH).replace(n_layers=8)):
        spec = tf.period_spec(arch_cfg)
        assert [k for k, _ in spec] == list(arch_cfg.pattern)[:len(spec)]
        assert [f for _, f in spec] == ["moe" if i % 2 else "dense" for i in range(len(spec))]
    jcfg, tcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    for dtype in ("float32", "bfloat16"):
        want = jax.eval_shape(lambda c=jcfg.replace(dtype=dtype): T.init_lm(
            jax.random.PRNGKey(0), c))
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(want, lambda x: x).items()}
        for device in ("cpu", "meta"):
            got = bridge.flatten(tf.init_lm(tcfg.replace(dtype=dtype), device=device))
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in got.items()} == want, (dtype, device)
    params = tf.init_lm(tcfg, device="meta")
    assert set(params["layers"][0]["mixer"]) >= {"w_in", "conv_w", "a_log", "dt_bias"}
    assert set(params["layers"][1]["mixer"]) == {"wq", "wk", "wv", "wo"}
    assert "router" in params["layers"][1]["ffn"] and "router" not in params["layers"][0]["ffn"]


def test_bridge_keeps_the_jax_dtypes_of_a_hybrid_tree():
    """A bf16 tree bridges leaf by leaf with the JAX dtypes: the conv, decay,
    skip, norm and router leaves f32, the rest bf16, every value equal."""
    import jax

    from repro.configs.base import get_config as jax_config
    from repro.models import transformer as T
    jcfg = jax_config(ARCH, smoke=True)
    assert jcfg.dtype == "bfloat16"
    jflat = _flat(T.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = bridge.flatten(bridge.from_numpy(jflat, "cpu", dtype="bfloat16"))
    assert set(tp) == set(jflat)
    f32 = {"conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm_w", "norm1", "norm2",
           "final_norm", "router"}
    for path, arr in jflat.items():
        leaf = tp[path]
        assert str(leaf.dtype).replace("torch.", "") == str(arr.dtype), path
        assert (leaf.dtype == torch.float32) == (path.split("/")[-1] in f32), path
        assert torch.equal(leaf.float(), torch.from_numpy(np.array(arr, np.float32))), path


def test_lm_forward_loss_and_gradients_match_jax(pair):
    """The twin of tests/test_models.py::test_smoke_forward_and_grad for
    jamba: logits and aux of the forward, then the loss and every leaf's
    gradient against ``jax.value_and_grad`` (S=16 spans two chunks of 8)."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as T
    jcfg, tcfg, jparams, tparams = pair
    toks, tgts = _tokens(2, 16, jcfg.vocab_size), _tokens(2, 16, jcfg.vocab_size, seed=2)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    jl, jaux = T.lm_forward(jparams, jb, jcfg)
    (jloss, jm), jg = jax.value_and_grad(lambda p: T.lm_loss(p, jb, jcfg), has_aux=True)(jparams)
    params = tree_map(lambda t: t.clone().requires_grad_(), tparams)
    tb = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)}
    logits, aux = tf.lm_forward(params, tb, tcfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert abs(aux.item() - float(jaux)) < 1e-5
    loss, m = tf.lm_loss(params, tb, tcfg)
    assert abs(loss.item() - float(jloss)) < 1e-4
    assert abs(m["ce"].item() - float(jm["ce"])) < 1e-4
    loss.backward()
    grads = bridge.to_numpy(tree_map(lambda t: t.grad, params))
    want = _flat(jg)
    assert set(grads) == set(want)
    for path, w in want.items():
        assert np.isfinite(grads[path]).all(), path
        assert _rel_rms(grads[path], w) <= GRAD_RTOL, path


def test_decode_matches_forward_at_big_capacity_factor():
    """The twin of tests/test_models.py::test_jamba_decode_matches_with_big_
    capacity_factor: at capacity factor 8 no token drops, so the cached
    decode (SSM states, a KV cache, MoE as groups of one token) gives the
    forward's logits, the JAX package's and the port's own."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as T
    jcfg, tcfg = _cfgs(capacity_factor=8.0)
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_numpy(_flat(jparams), "cpu", "float32")
    b, s = 2, 12
    toks = _tokens(b, s, jcfg.vocab_size)
    want, _ = T.lm_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    own, _ = tf.lm_forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    state = tf.init_decode_state(tcfg, b, s, device="cpu")
    assert [set(c) for c in state] == [{"conv", "state"}, {"k", "v", "slot_pos"}]
    got = []
    for t in range(s):
        lg, state = tf.decode_step(tparams, state, torch.from_numpy(toks[:, t:t + 1]), t, tcfg)
        got.append(lg[:, 0])
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3)
    np.testing.assert_allclose(got, own.numpy(), atol=2e-3)


def test_decode_step_matches_jax_decode_step(pair):
    """Step by step at the default capacity factor (each token a group of
    one), ragged against the chunk of 8."""
    import jax.numpy as jnp

    from repro.models import transformer as T
    jcfg, tcfg, jparams, tparams = pair
    b, s = 3, 10
    toks = _tokens(b, s, jcfg.vocab_size, seed=3)
    jstate = T.init_decode_state(jcfg, b, capacity=s)
    state = tf.init_decode_state(tcfg, b, s, device="cpu")
    for t in range(s):
        jl, jstate = T.decode_step(jparams, jstate, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t),
                                   jcfg)
        lg, state = tf.decode_step(tparams, state, torch.from_numpy(toks[:, t:t + 1]), t, tcfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-4, rtol=0,
                                   err_msg=f"step {t}")


def test_prefill_runs_each_mixer_through_its_kernel(pair, monkeypatch):
    """``make_prefill_step`` gives the JAX forward's last logits, with one
    ``ops.ssd`` call per Mamba-2 layer and one ``ops.mha`` call per attention
    layer (S=1030: attention takes the flash path from S=1024 on; ragged
    against the chunk of 8)."""
    import jax.numpy as jnp

    from repro.models import transformer as T
    jcfg, tcfg, jparams, tparams = pair
    calls = {"ssd": 0, "mha": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    toks = _tokens(1, 1030, jcfg.vocab_size, seed=4)
    want, _ = T.lm_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    step = make_prefill_step(ServeSetup(cfg=tcfg), (1, 1), tparams)
    last = step(tparams, {"tokens": torch.from_numpy(toks)})
    kinds = [tcfg.layer_kind(i) for i in range(tcfg.n_layers)]
    assert calls == {"ssd": kinds.count("mamba"), "mha": kinds.count("attn")} == {"ssd": 2,
                                                                                 "mha": 2}
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:], atol=1e-4, rtol=0)


def test_serve_and_train_entry_points_run_jamba_on_cpu(capsys):
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "5", "--gen", "4"])
    assert torch.isfinite(out["logits"]).all() and out["continuation"].shape == (2, 4)
    try:
        loss = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                                  "--batch", "4", "--seq", "16"])
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    assert np.isfinite(loss)
    assert "step    1 loss" in capsys.readouterr().out
