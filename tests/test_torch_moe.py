"""The port's MoE FFN and MoE models against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; parameters come from the JAX
package's initialisers and reach the port through ``repro_torch.bridge``.
Tolerances: integer results (capacities, expert ids, buffer positions) are
equal; the router's gates and probabilities within 1e-6; buffers and the
MoE output within 1e-5 in f32 (the two packages sum in other orders), and in
bf16 equal (each live slot holds one row, copied); logits within 1e-4 and the
aux loss within 1e-5, as tests/test_torch_serve.py holds the dense models;
gradients per leaf by relative RMS <= 1e-4, as tests/test_torch_train.py.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.tree import leaves, tree_map

MOE_ARCHS = ["deepseek_moe_16b", "granite_moe_1b_a400m", "deepseek_v3_16b"]
GRAD_RTOL = 1e-4


def _flat(params, leaf=np.asarray) -> dict:
    import jax

    from repro.parallel.sharding import _path_str
    return {_path_str(p): leaf(x) for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}


def _rel_rms(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def _jax_cfg(arch, **moe_kw):
    from repro.configs.base import get_config as jax_config
    cfg = jax_config(arch, smoke=True).replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw)) if moe_kw else cfg


def _torch_cfg(arch, **moe_kw):
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw)) if moe_kw else cfg


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    """(arch, JAX config, port config, JAX parameters, port parameters)."""
    import jax

    from repro.models import transformer as T
    arch = request.param
    jcfg, tcfg = _jax_cfg(arch), _torch_cfg(arch)
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    return arch, jcfg, tcfg, jparams, bridge.from_numpy(_flat(jparams), "cpu", "float32")


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


@pytest.mark.parametrize("tokens,top_k,cf,e", [
    (1, 6, 1.25, 64), (16, 2, 1.25, 8), (4096, 6, 1.25, 64), (8192, 8, 1.25, 32),
    (7, 3, 0.5, 5), (100, 2, 8.0, 4), (33, 1, 1.0, 16)])
def test_moe_capacity_matches_jax(tokens, top_k, cf, e):
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.models.moe import moe_capacity as jax_capacity
    kw = dict(n_experts=e, top_k=top_k, capacity_factor=cf)
    assert moe.moe_capacity(MoEConfig(**kw), tokens) == jax_capacity(JMoEConfig(**kw), tokens)


@pytest.mark.parametrize("g,t,k,e", [(2, 16, 3, 6), (8, 1, 6, 64), (3, 64, 2, 4)])
def test_choice_positions_match_jax_and_the_onehot_oracle(g, t, k, e):
    """Many ties: few experts for many choices (the twin of
    tests/test_phases.py::test_moe_choice_positions_match_onehot_oracle)."""
    import jax.numpy as jnp

    from repro.models.moe import choice_positions as jax_positions
    idx = np.random.default_rng(0).integers(0, e, (g, t, k))
    got = moe.choice_positions(torch.from_numpy(idx), e).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_positions(jnp.asarray(idx), e)))
    onehot = np.eye(e, dtype=np.int64)[idx].reshape(g, t * k, e)
    cum = np.cumsum(onehot, axis=1) - onehot
    np.testing.assert_array_equal(got, (cum * onehot).sum(-1).reshape(g, t, k))


def test_router_topk_matches_jax():
    import jax.numpy as jnp

    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.models.moe import router_topk as jax_topk
    logits = np.random.default_rng(2).standard_normal((3, 20, 8)).astype(np.float32) * 2
    got = moe.router_topk(torch.from_numpy(logits), MoEConfig(n_experts=8, top_k=3))
    want = jax_topk(jnp.asarray(logits), JMoEConfig(n_experts=8, top_k=3), None)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_router_jitter_moves_logits_only_with_a_generator():
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 32, 8))
                              .astype(np.float32))
    plain = moe.router_topk(logits, MoEConfig(n_experts=8, top_k=2))
    cfg = MoEConfig(n_experts=8, top_k=2, router_jitter=0.5)
    without = moe.router_topk(logits, cfg)
    for a, b in zip(plain, without):
        assert torch.equal(a, b)
    jittered = moe.router_topk(logits, cfg, torch.Generator().manual_seed(0))
    assert not torch.allclose(jittered[2], plain[2])
    again = moe.router_topk(logits, cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(jittered, again))


def _routing(g, t, k, e, seed):
    """idx [G,T,K] of distinct experts per token, gates [G,T,K] and x [G,T,D]."""
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.random((g, t, e)), axis=-1)[..., :k]
    gates = rng.random((g, t, k)).astype(np.float32)
    x = rng.standard_normal((g, t, 24)).astype(np.float32)
    return idx, gates, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_and_gather_match_jax(dtype):
    import jax.numpy as jnp

    from repro.models.moe import choice_positions as jax_positions
    from repro.models.moe import gather_combine as jax_gather
    from repro.models.moe import scatter_dispatch as jax_scatter
    g, t, k, e = 3, 16, 2, 4
    cap = 6  # below t * k / e = 8: choices drop
    idx, gates, x = _routing(g, t, k, e, seed=4)
    jdt = jnp.dtype(dtype)
    jx = jnp.asarray(x).astype(jdt)
    jpos = jax_positions(jnp.asarray(idx), e)
    jfits = jpos < cap
    jbuf = jax_scatter(jx, jnp.asarray(idx), jpos, jfits, e, cap)
    jy = jax_gather(jbuf, jnp.asarray(idx), jpos, jfits, jnp.asarray(gates))
    tx = bridge.from_numpy({"x": np.asarray(jx)}, "cpu")["x"]
    tidx = torch.from_numpy(idx)
    pos = moe.choice_positions(tidx, e)
    fits = pos < cap
    assert not fits.all()
    buf = moe.scatter_dispatch(tx, tidx, pos, fits, e, cap)
    assert buf.dtype == tx.dtype
    np.testing.assert_array_equal(bridge.to_numpy({"b": buf})["b"],
                                  np.asarray(jbuf.astype(jnp.float32)))
    y = moe.gather_combine(buf, tidx, pos, fits, torch.from_numpy(gates))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-6)


def test_scatter_and_gather_match_the_onehot_oracle_with_drops():
    """At capacity factor 0.5 choices drop: the sort/scatter dispatch and
    combine equal ``make_dispatch``'s einsums, and the port's oracle equals
    the JAX package's."""
    import jax.numpy as jnp

    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.models.moe import make_dispatch as jax_dispatch
    g, t, k, e = 2, 32, 2, 8
    m = MoEConfig(n_experts=e, top_k=k, capacity_factor=0.5)
    cap = moe.moe_capacity(m, t)
    idx, gates, x = _routing(g, t, k, e, seed=5)
    tidx, tg, tx = (torch.from_numpy(a) for a in (idx, gates, x))
    disp, comb = moe.make_dispatch(tidx, tg, m, cap)
    jd, jc = jax_dispatch(jnp.asarray(idx), jnp.asarray(gates),
                          JMoEConfig(n_experts=e, top_k=k, capacity_factor=0.5), cap)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jc), atol=1e-7)
    pos = moe.choice_positions(tidx, e)
    fits = pos < cap
    assert 0 < int((~fits).sum()) < fits.numel()
    buf = moe.scatter_dispatch(tx, tidx, pos, fits, e, cap)
    want_buf = torch.einsum("gtec,gtd->gecd", disp, tx)
    np.testing.assert_allclose(buf.numpy(), want_buf.numpy(), atol=1e-6)
    y = moe.gather_combine(buf, tidx, pos, fits, tg)
    np.testing.assert_allclose(y.numpy(), torch.einsum("gtec,gecd->gtd", comb, buf).numpy(),
                               atol=1e-5)


def test_dropped_choices_get_no_gradient():
    g, t, k, e = 1, 16, 2, 4
    idx, gates, x = _routing(g, t, k, e, seed=6)
    tidx = torch.from_numpy(idx)
    tx = torch.from_numpy(x).requires_grad_()
    pos = moe.choice_positions(tidx, e)
    fits = pos < 2
    buf = moe.scatter_dispatch(tx, tidx, pos, fits, e, 2)
    buf.sum().backward()
    kept = fits.sum(-1)[0].numpy()  # choices of each token that fit
    np.testing.assert_array_equal(tx.grad[0].numpy(), np.repeat(kept[:, None], 24, 1)
                                  .astype(np.float32))
    assert (kept == 0).any() and (kept > 0).any()


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "granite_moe_1b_a400m"])
def test_moe_apply_and_load_balance_loss_match_jax(arch):
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    jcfg, tcfg = _jax_cfg(arch, capacity_factor=1.0), _torch_cfg(arch, capacity_factor=1.0)
    jp = jmoe.moe_init(jax.random.PRNGKey(7), jcfg, jnp.float32)
    tp = bridge.from_numpy(_flat(jp), "cpu", "float32")
    assert tp["router"].dtype == torch.float32
    x = np.random.default_rng(8).standard_normal((3, 24, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    assert abs(aux.item() - float(jaux)) < 1e-5
    probs = np.random.default_rng(9).dirichlet(np.ones(jcfg.moe.n_experts), (3, 24))
    idx = np.argsort(-probs, -1)[..., :jcfg.moe.top_k]
    want = jmoe.load_balance_loss(jnp.asarray(probs, jnp.float32), jnp.asarray(idx), jcfg.moe)
    got = moe.load_balance_loss(torch.from_numpy(probs.astype(np.float32)),
                                torch.from_numpy(idx), tcfg.moe)
    assert abs(got.item() - float(want)) < 1e-5


def test_init_lm_matches_the_jax_tree(pair):
    """The same leaves, shapes and dtypes as the JAX package's ``init_lm``
    (the router f32), also in bf16 and on the meta device."""
    import jax

    from repro.models import transformer as T
    arch, jcfg, tcfg, jparams, _ = pair
    for dtype in ("float32", "bfloat16"):
        want = jax.eval_shape(lambda c=jcfg.replace(dtype=dtype): T.init_lm(
            jax.random.PRNGKey(0), c))
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(want, lambda x: x).items()}
        for device in ("cpu", "meta"):
            got = bridge.flatten(tf.init_lm(tcfg.replace(dtype=dtype), device=device))
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in got.items()} == want, (arch, dtype, device)


def test_lm_forward_loss_and_gradients_match_jax(pair):
    """The twin of tests/test_models.py::test_smoke_forward_and_grad for the
    MoE archs: logits, aux, loss and every leaf's gradient."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as T
    arch, jcfg, tcfg, jparams, tparams = pair
    toks, tgts = _tokens(2, 16, jcfg.vocab_size), _tokens(2, 16, jcfg.vocab_size, seed=2)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    jl, jaux = T.lm_forward(jparams, jb, jcfg)
    (jloss, _), jg = jax.value_and_grad(lambda p: T.lm_loss(p, jb, jcfg), has_aux=True)(jparams)
    params = tree_map(lambda t: t.clone().requires_grad_(), tparams)
    tb = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)}
    logits, aux = tf.lm_forward(params, tb, tcfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert abs(aux.item() - float(jaux)) < 1e-5
    loss, m = tf.lm_loss(params, tb, tcfg)
    assert abs(loss.item() - float(jloss)) < 1e-4
    assert m["moe_aux"].item() == aux.item()
    loss.backward()
    grads = bridge.to_numpy(tree_map(lambda t: t.grad, params))
    for path, want in _flat(jg).items():
        assert np.isfinite(grads[path]).all(), path
        assert _rel_rms(grads[path], want) <= GRAD_RTOL, (arch, path)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_full_gives_the_same_loss_and_gradients(pair, remat):
    _, _, tcfg, _, tparams = pair
    b = {k: torch.from_numpy(_tokens(2, 16, tcfg.vocab_size, seed=s))
         for k, s in (("tokens", 1), ("targets", 2))}
    out = []
    for cfg in (tcfg, tcfg.replace(remat=remat)):
        params = tree_map(lambda t: t.clone().requires_grad_(), tparams)
        loss, m = tf.lm_loss(params, b, cfg)
        loss.backward()
        out.append((loss.item(), m["moe_aux"].item(), [t.grad for t in leaves(params)]))
    assert out[0][:2] == out[1][:2]
    for g0, g1 in zip(out[0][2], out[1][2]):
        assert torch.equal(g0, g1)


class _Products(TorchDispatchMode):
    """Counts the products run inside the layers (``_apply_sublayer``), by
    phase and kind: "none" (``mm``, ``addmm``, ``bmm`` with batch 1) or
    "batched" (``bmm`` with batch > 1)."""

    def __init__(self):
        super().__init__()
        self.phase, self.in_layer = "forward", 0
        self.counts = {(p, k): 0 for p in ("forward", "backward") for k in ("none", "batched")}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.in_layer:
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                self.counts[self.phase, "none"] += 1
            elif func == torch.ops.aten.bmm.default:
                self.counts[self.phase, "none" if args[0].shape[0] == 1 else "batched"] += 1
        return func(*args, **(kwargs or {}))


def _saved_bytes(params, batch, cfg, monkeypatch) -> int:
    """Bytes held for the backward after the forward: the activations that
    autograd saves outside a checkpointed body (``saved_tensors_hooks``),
    parameters left out, and the outputs that remat "dots" keeps (the
    policy's MUST_SAVE decisions in the forward)."""
    from torch.utils.checkpoint import CheckpointPolicy
    skip = {t.untyped_storage().data_ptr() for t in leaves(params)}
    seen, kept = {}, [0]

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = st.nbytes()
        return t
    policy = tf.save_dots

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept[0] += ctx.op_output.untyped_storage().nbytes()
        return out
    monkeypatch.setattr(tf, "save_dots", counting)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = tf.lm_loss(params, batch, cfg)
    loss.backward()
    return sum(seen.values()) + kept[0]


def test_remat_dots_recomputes_exactly_the_batched_products(pair, monkeypatch):
    """Under "dots" the backward re-runs no product without batch dims of the
    forward (the projections, the router: ``bmm`` with batch 1) and every
    batched one (the experts' ``ecd,edf->ecf``, attention, dispatch); under
    "full" it re-runs both, under "none" neither (the recompute's early stop,
    which skips a body's last products that no backward needs, is off).  The
    bytes kept for the backward order as full < dots < none."""
    from torch.utils.checkpoint import set_checkpoint_early_stop
    _, _, tcfg, _, tparams = pair
    b = {k: torch.from_numpy(_tokens(2, 16, tcfg.vocab_size, seed=s))
         for k, s in (("tokens", 1), ("targets", 2))}
    sub = tf._apply_sublayer
    counts, saved = {}, {}
    for remat in ("none", "full", "dots"):
        mode = _Products()

        def tracked(*a, **kw):
            mode.in_layer += 1
            try:
                return sub(*a, **kw)
            finally:
                mode.in_layer -= 1
        cfg = tcfg.replace(remat=remat)
        params = tree_map(lambda t: t.clone().requires_grad_(), tparams)
        with monkeypatch.context() as mp:
            mp.setattr(tf, "_apply_sublayer", tracked)
            with mode, set_checkpoint_early_stop(False):
                loss, _ = tf.lm_loss(params, b, cfg)
                mode.phase = "backward"
                loss.backward()
        counts[remat] = mode.counts
        with monkeypatch.context() as mp:
            saved[remat] = _saved_bytes(tree_map(lambda t: t.clone().requires_grad_(), tparams),
                                        b, cfg, mp)
    fwd = {k: counts["none"]["forward", k] for k in ("none", "batched")}
    assert fwd["none"] > 0 and fwd["batched"] > 0
    assert counts["none"]["backward", "none"] == 0 == counts["none"]["backward", "batched"]
    assert counts["full"]["backward", "none"] == fwd["none"]
    assert counts["full"]["backward", "batched"] == fwd["batched"]
    assert counts["dots"]["backward", "none"] == 0
    assert counts["dots"]["backward", "batched"] == fwd["batched"]
    assert saved["full"] < saved["dots"] < saved["none"], saved
    with pytest.raises(ValueError, match="remat"):
        tf.lm_loss(tparams, b, tcfg.replace(remat="some"))


def test_decode_matches_jax_forward_when_nothing_drops():
    """The twin of tests/test_models.py::test_jamba_decode_matches_with_big_
    capacity_factor for deepseek-moe: at capacity factor 8 no token drops in
    the forward, so the port's cached decode gives the JAX forward's logits."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as T
    jcfg = _jax_cfg("deepseek_moe_16b", capacity_factor=8.0)
    tcfg = _torch_cfg("deepseek_moe_16b", capacity_factor=8.0)
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_numpy(_flat(jparams), "cpu", "float32")
    b, s = 2, 12
    toks = _tokens(b, s, jcfg.vocab_size)
    want, _ = T.lm_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    state = tf.init_decode_state(tcfg, b, s, device="cpu")
    got = []
    for t in range(s):
        lg, state = tf.decode_step(tparams, state, torch.from_numpy(toks[:, t:t + 1]), t, tcfg)
        got.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_decode_step_matches_jax_decode_step(pair):
    """Step by step at the default capacity factor: each token is a group of
    one, with capacity 8 whatever the experts' load."""
    import jax.numpy as jnp

    from repro.models import transformer as T
    arch, jcfg, tcfg, jparams, tparams = pair
    b, s = 3, 10
    toks = _tokens(b, s, jcfg.vocab_size, seed=3)
    jstate = T.init_decode_state(jcfg, b, capacity=s)
    state = tf.init_decode_state(tcfg, b, s, device="cpu")
    for t in range(s):
        jl, jstate = T.decode_step(jparams, jstate, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t),
                                   jcfg)
        lg, state = tf.decode_step(tparams, state, torch.from_numpy(toks[:, t:t + 1]), t, tcfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-4, rtol=0,
                                   err_msg=f"{arch} step {t}")


def test_serve_main_runs_deepseek_moe_on_cpu(capsys):
    out = launch_serve.main(["--arch", "deepseek_moe_16b", "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "4", "--gen", "4"])
    assert torch.isfinite(out["logits"]).all()
    assert out["continuation"].shape == (2, 4)
    assert "served 2 seqs" in capsys.readouterr().out
