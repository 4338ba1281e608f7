"""The port's Mamba-2 serving and training path against the JAX package's,
on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
weights are made by ``repro.models.transformer.init_lm`` and bridged to the
port with ``repro_torch.bridge``.  f32 throughout.  Tolerances: the plain
SSD scan against the JAX oracle 1e-5 (the JAX package's kernel tolerance)
and against the Pallas kernel in interpret mode 5e-4 (what
tests/test_kernels.py holds the Pallas kernel to); the scan's gradients
1e-4 (tests/test_kernels.py); blocks, prefill and decode 1e-4
(tests/test_serve.py); decode against forward 2e-3 (tests/test_models.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels.ssd_scan import ssd as pl_ssd
from repro.models import ssm as jssm
from repro.models import transformer as T
from repro.parallel.sharding import _path_str
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tf
from repro_torch.serve.step import (ServeSetup, init_serve_state, make_decode_step,
                                    make_prefill_step)

ARCH = "mamba2_370m"
ATOL = 1e-4


def _flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {_path_str(path): np.asarray(x) for path, x in leaves}


def _pair(dtype="float32"):
    jcfg = jax_config(ARCH, smoke=True).replace(dtype=dtype)
    tcfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_numpy(_flat(jparams), "cpu", dtype=dtype)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def mamba():
    return _pair()


def _ssd_inputs(b, s, h, p, g, n, *, h_init=False, seed=0, model_scale=True):
    """x, dt, a, B, C (and h_init) in numpy.  model_scale: dt = softplus(z - 3)
    and a = -(1..H), as the model's init gives; else the unit-normal draws of
    tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    z = rng.standard_normal((b, s, h))
    if model_scale:
        dt = np.log1p(np.exp(z - 3.0)).astype(np.float32)
        a = -np.arange(1, h + 1, dtype=np.float32)
    else:
        dt = np.log1p(np.exp(z)).astype(np.float32)
        a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if h_init else None
    return x, dt, a, bm, cm, h0


def _t(*arrs):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,h_init", [
    (2, 64, 4, 16, 2, 8, 8, False),
    (1, 48, 4, 8, 1, 16, 16, True),
    (2, 64, 4, 16, 2, 8, 32, True),
    (1, 128, 8, 16, 1, 16, 64, False),
])
def test_plain_ssd_matches_jax_oracle(b, s, h, p, g, n, chunk, h_init):
    x, dt, a, bm, cm, h0 = _ssd_inputs(b, s, h, p, g, n, h_init=h_init)
    y, st = tref.ssd_chunked(*_t(x, dt, a, bm, cm), chunk, h_init=_t(h0)[0])
    yj, stj = jssm.ssd_chunked(*_j(x, dt, a, bm, cm), chunk, h_init=_j(h0)[0])
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), atol=1e-5)
    assert tref.ssd_tolerance_ratio(y, torch.from_numpy(np.array(yj))) <= 1
    assert tref.ssd_tolerance_ratio(st, torch.from_numpy(np.array(stj)), head_dim=1) <= 1


@pytest.mark.parametrize("s,chunk,h_init", [(13, 8, False), (50, 16, True)])
def test_plain_ssd_pads_a_ragged_length(s, chunk, h_init):
    """A ragged S gives the JAX oracle's y and state on zero-padded inputs
    (dt = 0 on the padding), as the JAX package's ``ssm_apply`` pads."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(2, s, 4, 8, 2, 8, h_init=h_init, seed=6)
    pad = (-s) % chunk
    padded = [np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2)) for t in (x, dt, bm, cm)]
    y, st = tref.ssd_chunked(*_t(x, dt, a, bm, cm), chunk, h_init=_t(h0)[0])
    yj, stj = jssm.ssd_chunked(*_j(padded[0], padded[1], a, padded[2], padded[3]), chunk,
                               h_init=_j(h0)[0])
    assert y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(yj)[:, :s], atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), atol=1e-5)


# the shapes of tests/test_kernels.py::test_pallas_ssd_vs_chunked, and h_init
@pytest.mark.parametrize("chunk,h_init", [(8, False), (16, False), (32, False), (16, True)])
def test_plain_ssd_matches_pallas_interpret(chunk, h_init):
    x, dt, a, bm, cm, h0 = _ssd_inputs(2, 64, 4, 16, 2, 8, h_init=h_init, seed=1,
                                       model_scale=False)
    y, st = ops.ssd(*_t(x, dt, a, bm, cm), chunk, h_init=_t(h0)[0])
    yp, stp = pl_ssd(*_j(x, dt, a, bm, cm), chunk, h_init=_j(h0)[0], interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), atol=5e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(stp), atol=5e-4)


def _drop_entering_state(x, dt, a, bm, cm, chunk, at):
    """The plain scan with the state entering chunk ``at`` dropped."""
    cut = at * chunk
    y1, _ = tref.ssd_chunked(x[:, :cut], dt[:, :cut], a, bm[:, :cut], cm[:, :cut], chunk)
    y2, st = tref.ssd_chunked(x[:, cut:], dt[:, cut:], a, bm[:, cut:], cm[:, cut:], chunk)
    return torch.cat([y1, y2], 1), st


def _drop_intra(x, dt, a, bm, cm, chunk, at):
    """The plain scan with chunk ``at``'s intra-chunk term dropped: that
    chunk alone from a zero state is exactly its intra-chunk term."""
    y, st = tref.ssd_chunked(x, dt, a, bm, cm, chunk)
    sl = slice(at * chunk, (at + 1) * chunk)
    intra, _ = tref.ssd_chunked(x[:, sl], dt[:, sl], a, bm[:, sl], cm[:, sl], chunk)
    y = y.clone()
    y[:, sl] -= intra
    return y, st


@pytest.mark.parametrize("fault", [_drop_entering_state, _drop_intra])
def test_ssd_tolerance_rejects_planted_faults(fault):
    """The bound the CUDA kernel is held to admits the JAX oracle's other
    summation order and rejects a dropped state or intra-chunk term."""
    x, dt, a, bm, cm, _ = _ssd_inputs(1, 128, 8, 16, 1, 16, seed=2)
    args = _t(x, dt, a, bm, cm)
    want, _ = tref.ssd_chunked(*args, 16)
    yj, _ = jssm.ssd_chunked(*_j(x, dt, a, bm, cm), 16)
    assert tref.ssd_tolerance_ratio(torch.from_numpy(np.array(yj)), want) <= 1
    got, _ = fault(*args, 16, at=4)
    assert tref.ssd_tolerance_ratio(got, want) > 100


def test_bridge_keeps_the_jax_dtypes_of_a_bf16_tree():
    jcfg = jax_config(ARCH, smoke=True)
    assert jcfg.dtype == "bfloat16"
    flat = _flat(T.init_lm(jax.random.PRNGKey(0), jcfg))
    f32_leaves = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm_w", "norm1")
    # as handed over, and after a round trip through to_numpy (bf16 -> f32)
    for tree in (flat, bridge.to_numpy(bridge.from_numpy(flat, "cpu", dtype="bfloat16"))):
        tp = bridge.from_numpy(tree, "cpu", dtype="bfloat16")
        for name in ("w_in", "w_out"):
            assert tp["layers"][0]["mixer"][name].dtype == torch.bfloat16
        assert tp["embed"].dtype == torch.bfloat16
        for name in f32_leaves:
            leaf = tp["layers"][0][name] if name == "norm1" else tp["layers"][0]["mixer"][name]
            assert leaf.dtype == torch.float32, name
        assert tp["final_norm"].dtype == torch.float32
        for path, arr in flat.items():
            node = tp
            for key in path.split("/"):
                node = node[int(key)] if key.isdigit() else node[key]
            want = torch.from_numpy(np.asarray(arr, np.float32))
            assert torch.equal(node.float(), want), path


def test_ssm_apply_matches_jax(mamba):
    jcfg, tcfg, jparams, tparams = mamba
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, tcfg.d_model)).astype(np.float32)  # ragged: chunk 8
    lp_j = jax.tree_util.tree_map(lambda t: t[0], jparams["layers"][0]["mixer"])
    lp_t = tf._period(tparams["layers"][0]["mixer"], 0)
    want = jssm.ssm_apply(lp_j, jnp.asarray(x), jcfg)
    got = tssm.ssm_apply(lp_t, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_ssm_decode_matches_jax(mamba):
    jcfg, tcfg, jparams, tparams = mamba
    rng = np.random.default_rng(4)
    lp_j = jax.tree_util.tree_map(lambda t: t[0], jparams["layers"][0]["mixer"])
    lp_t = tf._period(tparams["layers"][0]["mixer"], 0)
    cache_j = jssm.init_ssm_cache(jcfg, 2)
    cache_t = tssm.init_ssm_cache(tcfg, 2, device="cpu")
    for _ in range(5):
        x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        want, cache_j = jssm.ssm_decode(lp_j, jnp.asarray(x), cache_j, jcfg)
        got, cache_t = tssm.ssm_decode(lp_t, torch.from_numpy(x), cache_t, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(cache_t[k].numpy(), np.asarray(cache_j[k]), atol=ATOL)


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


class _Spy:
    def __init__(self, monkeypatch, name):
        self.calls = 0
        fn = getattr(ops, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        monkeypatch.setattr(ops, name, wrapped)


@pytest.mark.parametrize("s", [12, 16])
def test_prefill_matches_jax_and_scans_once_per_layer(mamba, s, monkeypatch):
    jcfg, tcfg, jparams, tparams = mamba
    toks = _tokens(2, s, tcfg.vocab_size)
    want, _ = T.lm_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = tf.lm_forward(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    spy = _Spy(monkeypatch, "ssd")
    step = make_prefill_step(ServeSetup(cfg=tcfg), (1, 1), tparams)
    last = step(tparams, {"tokens": torch.from_numpy(toks).long()})
    assert spy.calls == tcfg.n_layers
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:], atol=ATOL)


def test_lm_forward_hidden_gives_the_logits_through_unembed(mamba):
    _, tcfg, _, tparams = mamba
    batch = {"tokens": torch.from_numpy(_tokens(2, 12, tcfg.vocab_size, seed=3)).long()}
    logits, _ = tf.lm_forward(tparams, batch, tcfg)
    hidden, _ = tf.lm_forward(tparams, batch, tcfg, hidden=True)
    assert hidden.shape == (2, 12, tcfg.d_model)
    for i in (0, 5):  # a few positions at a time, as chip_smoke.py slices them
        torch.testing.assert_close(tf.unembed(tparams, hidden[:, i:i + 7], tcfg),
                                   logits[:, i:i + 7], rtol=0, atol=0)


def _port_decode(tcfg, tparams, toks):
    setup = ServeSetup(cfg=tcfg)
    state = init_serve_state(setup, (1, 1), tparams, toks.shape[0], toks.shape[1])
    step = make_decode_step(setup, (1, 1), tparams, batch=toks.shape[0],
                            capacity=toks.shape[1])
    outs = []
    for t in range(toks.shape[1]):
        lg, state = step(tparams, state, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        outs.append(lg[:, 0].numpy())
    return np.stack(outs, 1), state


def test_decode_matches_jax(mamba):
    """Teacher-forced decode of S=12 (ragged against chunk 8)."""
    jcfg, tcfg, jparams, tparams = mamba
    toks = _tokens(2, 12, tcfg.vocab_size, seed=2)
    step = jax.jit(lambda p, st, tok, pos: T.decode_step(p, st, tok, pos, jcfg))
    st = T.init_decode_state(jcfg, 2, 12)
    want = []
    for t in range(12):
        lg, st = step(jparams, st, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
    got, state = _port_decode(tcfg, tparams, toks)
    np.testing.assert_allclose(got, np.stack(want, 1), atol=ATOL)
    assert set(state[0]) == {"conv", "state"}
    np.testing.assert_allclose(state[0]["state"].numpy(), np.asarray(st[0]["state"]), atol=ATOL)


def test_decode_matches_forward(mamba):
    """Twin of tests/test_models.py::test_decode_matches_forward for mamba2."""
    _, tcfg, _, tparams = mamba
    toks = _tokens(2, 12, tcfg.vocab_size, seed=5)
    logits_tf, _ = tf.lm_forward(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    got, _ = _port_decode(tcfg, tparams, toks)
    np.testing.assert_allclose(got, logits_tf.numpy(), atol=2e-3)


def test_serve_main_runs_mamba_on_cpu(capsys):
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    assert out["continuation"].shape == (2, 4)
    assert torch.isfinite(out["logits"]).all()
    assert "served 2 seqs x 9 steps" in capsys.readouterr().out


def test_hybrid_and_moe_still_raise():
    """The hybrid family now initialises and runs (forward and decode), as
    does an MoE config; a family="moe" config without a MoEConfig still
    raises and names MoE, and a "vlm" or "audio" config without its frontend
    (and encoder) raises and names the sub-config it needs."""
    hybrid = get_config("mamba2_370m", smoke=True).replace(family="hybrid",
                                                           layer_pattern=("mamba", "attn"),
                                                           n_heads=4, n_kv_heads=4)
    params = tf.init_lm(hybrid, device="cpu")
    assert set(params["layers"][1]["mixer"]) == {"wq", "wk", "wv", "wo"}
    tokens = torch.randint(0, hybrid.vocab_size, (2, 6),
                           generator=torch.Generator().manual_seed(0))
    logits, _ = tf.lm_forward(params, {"tokens": tokens}, hybrid)
    assert torch.isfinite(logits).all()
    state = tf.init_decode_state(hybrid, 2, 8, device="cpu")
    logits, _ = tf.decode_step(params, state, tokens[:, :1], 0, hybrid)
    assert logits.shape[:2] == (2, 1) and torch.isfinite(logits).all()
    dense = get_config("llama3_8b", smoke=True)
    for family, needs in (("vlm", "needs a FrontendConfig"), ("audio", "needs an EncoderConfig")):
        with pytest.raises(NotImplementedError, match=needs):
            tf.init_lm(dense.replace(family=family), device="cpu")
        with pytest.raises(NotImplementedError, match=needs):
            tf.init_decode_state(dense.replace(family=family), 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        tf.init_lm(dense.replace(family="moe"), device="cpu")
    moe = dense.replace(family="moe", moe=MoEConfig(n_experts=4, top_k=2))
    params = tf.init_lm(moe, device="cpu")
    assert params["layers"][0]["ffn"]["w_gate"].shape == (moe.n_layers, 4, moe.d_model, moe.d_ff)
    logits, aux = tf.lm_forward(params, {"tokens": tokens}, moe)
    assert torch.isfinite(logits).all() and aux.item() > 0
    state = tf.init_decode_state(moe, 2, 8, device="cpu")
    logits, _ = tf.decode_step(params, state, tokens[:, :1], 0, moe)
    assert logits.shape[:2] == (2, 1) and torch.isfinite(logits).all()


# ---- the scan's gradient ----

def test_ops_ssd_gradients_match_jax():
    """The twin of tests/test_kernels.py::test_pallas_ssd_grads_match_oracle:
    the same shapes, inputs of the same kind and the same loss; the
    gradients through the port's ``ops.ssd`` autograd function on the CPU
    (``ref.ssd_chunked_bwd``, never a launch) against the Pallas kernel's
    custom VJP in interpret mode and ``jax.grad`` of the oracle."""
    b, s, h, p, g, n, chunk = 1, 32, 4, 16, 2, 8, 16
    x, dt, a, bm, cm, _ = _ssd_inputs(b, s, h, p, g, n, seed=8, model_scale=False)

    def loss(fn):
        def f(*args):
            y, st = fn(*args)
            return jnp.sum(jnp.sin(y)) + jnp.sum(jnp.cos(st))
        return f
    want_pl = jax.grad(loss(lambda *o: pl_ssd(*o, chunk, interpret=True)),
                       argnums=(0, 1, 2, 3, 4))(*_j(x, dt, a, bm, cm))
    want = jax.grad(loss(lambda *o: jssm.ssd_chunked(*o, chunk)),
                    argnums=(0, 1, 2, 3, 4))(*_j(x, dt, a, bm, cm))
    ins = [t.requires_grad_() for t in _t(x, dt, a, bm, cm)]
    ops.reset_launch_counts()
    y, st = ops.ssd(*ins, chunk)
    (y.sin().sum() + st.cos().sum()).backward()
    assert ops.launch_counts()["ssd_scan"] == ops.launch_counts()["ssd_scan_bwd"] == 0
    for t, w1, w2 in zip(ins, want_pl, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w1), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w2), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,h_init", [
    (2, 64, 4, 16, 2, 8, 16, True),      # h_init and its cotangent
    (1, 50, 4, 8, 1, 16, 16, True),      # ragged S, h_init
    (2, 37, 6, 8, 3, 8, 8, False),       # ragged S, G=3
])
def test_plain_ssd_bwd_matches_jax_vjp(b, s, h, p, g, n, chunk, h_init):
    """``ref.ssd_chunked_bwd`` against ``jax.vjp`` of the JAX oracle, with a
    cotangent on the final state; a ragged S against the oracle on inputs
    zero-padded to a chunk multiple (dy zero on the padding), cut back."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(b, s, h, p, g, n, h_init=h_init, seed=9)
    rng = np.random.default_rng(10)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dst = rng.standard_normal((b, h, p, n)).astype(np.float32)
    pad = (-s) % chunk
    padded = [np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2)) for t in (x, dt, bm, cm, dy)]
    args = _j(padded[0], padded[1], a, padded[2], padded[3]) + ([jnp.asarray(h0)] if h_init
                                                                 else [])
    _, vjp = jax.vjp(lambda *o: jssm.ssd_chunked(*o[:5], chunk, h_init=o[5] if h_init else None),
                     *args)
    want = vjp((jnp.asarray(padded[4]), jnp.asarray(dst)))
    got = tref.ssd_chunked_bwd(*_t(x, dt, a, bm, cm), chunk, *_t(dy, dst), h_init=_t(h0)[0])
    assert (got[5] is None) == (not h_init)
    for i, (gt, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if w.ndim >= 2 and i != 5:  # the sequence-long gradients: cut the padding
            w = w[:, :s]
        np.testing.assert_allclose(gt.numpy(), w, atol=1e-4, rtol=1e-4)


def _ssd_bwd_by_segments(x, dt, a, bm, cm, chunk, seg_chunks, dy, dst, h_init=None,
                         drop=None):
    """The backward's segment decomposition (csrc/ssd_scan_bwd.cu, with
    segments of one chunk there), built from the plain versions: the state
    entering each segment by the forward's combine; each segment's local
    state cotangent (its own dy alone, from a zero cotangent: what its
    entering state gets from inside it) and total decay; the reverse
    combine, cot(k-1) = decay(k) cot(k) + local(k) from cot(last) = dst,
    which gives the cotangent leaving each segment and dh_init; then each
    segment's gradients from its entering state and the cotangent leaving
    it.  ``drop``: a planted fault, the cotangent carried out of segment
    ``drop`` + 1 into segment ``drop`` dropped."""
    s, seg = x.shape[1], seg_chunks * chunk
    cuts = [(i, min(s, i + seg)) for i in range(0, s, seg)]
    part = lambda t, lo, hi: t[:, lo:hi]  # noqa: E731
    _, entering = _ssd_by_segments(x, dt, a, bm, cm, chunk, seg_chunks, h_init=h_init,
                                   entering_only=True)
    zero = torch.zeros_like(dst)
    local, decay = [], []
    for lo, hi in cuts:
        args = [part(t, lo, hi) for t in (x, dt)] + [a] + [part(t, lo, hi) for t in (bm, cm)]
        local.append(tref.ssd_chunked_bwd(*args, chunk, part(dy, lo, hi), zero,
                                          h_init=zero)[5])
        decay.append(torch.exp((dt[:, lo:hi] * a).sum(1)))
    cot = [None] * len(cuts)
    cot[-1] = dst
    for k in range(len(cuts) - 1, 0, -1):
        carried = decay[k][..., None, None] * cot[k] + local[k]
        cot[k - 1] = zero if k - 1 == drop else carried
    grads = [tref.ssd_chunked_bwd(*[part(t, lo, hi) for t in (x, dt)], a,
                                  *[part(t, lo, hi) for t in (bm, cm)], chunk,
                                  part(dy, lo, hi), cot[k], h_init=entering[k])
             for k, (lo, hi) in enumerate(cuts)]
    dh0 = decay[0][..., None, None] * cot[0] + local[0]
    cat = lambda i: torch.cat([gr[i] for gr in grads], 1)  # noqa: E731
    return (cat(0), cat(1), sum(gr[2] for gr in grads), cat(3), cat(4),
            dh0 if h_init is not None else None)


@pytest.mark.parametrize("s,chunk,seg_chunks,h_init", [
    (512, 32, 4, False),       # four whole segments
    (500, 32, 3, True),        # ragged last chunk inside a short last segment, h_init
    (300, 16, 1, True),        # segments of one chunk, as the kernel has them
])
def test_ssd_bwd_segment_decomposition_matches_autograd(s, chunk, seg_chunks, h_init):
    """The algebra of the backward kernel's passes (entering states, local
    cotangents, the reverse combine, per-segment gradients) against the
    autograd of ``ref.ssd_chunked`` over the whole sequence, within the
    tolerance the kernel is held to; a cotangent dropped at a segment
    boundary fails it."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(2, s, 4, 16, 2, 32, h_init=h_init, seed=11)
    rng = np.random.default_rng(12)
    dy, dst = _t(rng.standard_normal((2, s, 4, 16)).astype(np.float32),
                 rng.standard_normal((2, 4, 16, 32)).astype(np.float32))
    args = _t(x, dt, a, bm, cm)
    h0 = _t(h0)[0]
    want = tref.ssd_chunked_bwd(*args, chunk, dy, dst, h_init=h0)
    got = _ssd_bwd_by_segments(*args, chunk, seg_chunks, dy, dst, h_init=h0)
    ratios = tref.ssd_grad_ratios(got, want)
    assert len(ratios) == (6 if h_init else 5) and max(ratios.values()) <= 1, ratios
    bad = _ssd_bwd_by_segments(*args, chunk, seg_chunks, dy, dst, h_init=h0, drop=1)
    assert tref.ssd_grad_ratios(bad, want)["dx"] > 1


def _chip_smoke():
    """``chip_smoke.py`` at the root of the repository, whose planted faults
    the SSD backward kernel's checks on the card must see."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ssd_grad_tolerance_rejects_planted_faults():
    """The bound the SSD backward kernel is held to admits the JAX oracle's
    gradients (another summation order) and rejects each of the four faults
    that chip_smoke.py plants on the card: a carried state cotangent dropped
    at a chunk boundary, one chunk's intra-chunk term of du dropped, ddt
    without the decays' gradient, dB from one head of each group.  Each
    fault moves only the gradients it names."""
    cs = _chip_smoke()
    b, s, h, p, g, n, chunk = 1, 256, 8, 16, 2, 16, 32
    x, dt, a, bm, cm, _ = _ssd_inputs(b, s, h, p, g, n, seed=13)
    rng = np.random.default_rng(14)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dst = rng.standard_normal((b, h, p, n)).astype(np.float32)
    args = (*_t(x, dt, a, bm, cm), chunk, *_t(dy, dst), None)
    want = tref.ssd_chunked_bwd(*args[:-1])
    _, vjp = jax.vjp(lambda *o: jssm.ssd_chunked(*o, chunk), *_j(x, dt, a, bm, cm))
    jgrads = [torch.from_numpy(np.array(w)) for w in vjp(tuple(_j(dy, dst)))] + [None]
    assert max(tref.ssd_grad_ratios(jgrads, want).values()) <= 1
    at = s // chunk // 2
    for fault, hit in ((cs.ssd_bwd_drop_carried(*args, at), {"dx", "ddt", "da", "db"}),
                       (cs.ssd_bwd_drop_intra_du(*args, at), {"dx", "ddt"}),
                       (cs.ssd_bwd_drop_decay_grad(*args), {"ddt"}),
                       (cs.ssd_bwd_one_head_per_group(*args), {"db", "dc"})):
        ratios = tref.ssd_grad_ratios(fault, want)
        assert {k for k, v in ratios.items() if v > 1} == hit, ratios


def _da_one_chunk(x, dt, a, bm, cm, dy, kernel_form: bool):
    """da of sequences of one chunk each, from a zero state and with no
    cotangent on the final state, so that d(dA) is the intra-chunk term
    alone, with M = (C B^T) o (dy x^T) dt_j o e^{cs_i - cs_j}.  As
    csrc/ssd_scan_bwd.cu takes it (``kernel_form``): cs scanned in f64 and
    kept as an f32 hi + lo pair for the exponents, and d(dA)_k the sum of M
    over the pairs with j < k <= i.  Otherwise: an f32 cs, and d(dA) the
    reverse cumulative sum of rowsum(M) - colsum(M), diagonal included."""
    dA = dt * a
    if kernel_form:
        c64 = torch.cumsum(dA.double(), 1)
        hi = c64.float()
        lo = (c64 - hi.double()).float()
        ex = (hi[:, :, None] - hi[:, None, :]) + (lo[:, :, None] - lo[:, None, :])
    else:
        cs = torch.cumsum(dA, 1)
        ex = cs[:, :, None] - cs[:, None, :]
    L = x.shape[1]
    low = torch.tril(torch.ones(L, L, dtype=torch.bool), -1 if kernel_form else 0)[None, ..., None]
    e = torch.where(low, torch.exp(torch.where(low, ex, 0.0)), 0.0)       # [B,i,j,H]
    cb = torch.einsum("bin,bjn->bij", cm[:, :, 0], bm[:, :, 0])[..., None]
    m = cb * torch.einsum("bihp,bjhp->bijh", dy, x) * dt[:, None] * e
    if kernel_form:
        pre = torch.cumsum(m, 2) - m  # each row's exclusive prefix over j
        dda = torch.stack([pre[:, k:, k].sum(1) for k in range(L)], 1)
    else:
        dda = torch.flip(torch.cumsum(torch.flip(m.sum(2) - m.sum(1), [1]), 1), [1])
    return (dt * dda).sum((0, 1))


def test_ssd_bwd_decay_gradient_holds_the_tolerance_where_cumsum_differences_do_not():
    """At jamba's fastest decays (a = -(100..107), dt = softplus(z - 3): cs
    reaches a few hundred within a chunk of 64), the backward kernel's way
    of taking da (see ``_da_one_chunk``) stays within
    ``ref.ssd_grad_tolerance_ratio`` of the plain backward; the difference
    of two cumulative sums with an f32 cs does not (on an H100 the kernel
    read 6.6 that way, then 1.2 with the straddling sums alone)."""
    rng = np.random.default_rng(15)
    b, L, h, p, n = 256, 64, 8, 16, 16
    x, dy = (torch.from_numpy(rng.standard_normal((b, L, h, p)).astype(np.float32))
             for _ in range(2))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, L, h)).astype(np.float32)) - 3)
    a = -torch.arange(100, 100 + h, dtype=torch.float32)
    bm, cm = (torch.from_numpy(rng.standard_normal((b, L, 1, n)).astype(np.float32))
              for _ in range(2))
    want = tref.ssd_chunked_bwd(x, dt, a, bm, cm, L, dy, torch.zeros(b, h, p, n))[2]
    ratio = {form: tref.ssd_grad_tolerance_ratio(_da_one_chunk(x, dt, a, bm, cm, dy, form),
                                                 want, (0,))
             for form in (True, False)}
    assert ratio[True] <= 1 < ratio[False], ratio


def _tf32(t):
    """Round f32 to TF32 (10 mantissa bits, to nearest, ties away from zero),
    as ``cvt.rna.tf32.f32`` does."""
    u = t.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_hi_lo(t):
    """The CUDA kernel's 3xTF32 scheme: hi is t with the mantissa bits TF32
    lacks cleared, lo = t - hi with those bits dropped as the tensor cores
    drop them; a product is hi.hi + hi.lo + lo.hi, summed in f32."""
    hi = (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    lo = (t - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def _tf32_once(t):
    """One TF32 product: each operand rounded once."""
    return (_tf32(t),)


def _tc(spec, a, b, parts):
    """A product on the tensor cores: every pair of operand parts whose
    indices sum to less than the number of parts (hi.hi, hi.lo, lo.hi)."""
    pa, pb = parts(a), parts(b)
    return sum(torch.einsum(spec, u, v) for i, u in enumerate(pa) for j, v in enumerate(pb)
               if i + j < len(pa))


def _ssd_as_the_kernel(x, dt, a, bm, cm, chunk, parts):
    """The SSD scan computed as csrc/ssd_scan.cu computes it, with every
    matrix product's operands split by ``parts``: C B^T per group and chunk;
    W = C B^T * exp(cs_i - cs_j) * dt_j on and below the diagonal; y = W X +
    exp(cs) * (C state^T); state' = exp(cs_last) state + (X * dt *
    exp(cs_last - cs))^T B.  Decays, sums and dt stay f32."""
    bsz, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    x, dt, bm, cm = (tref._pad_to(t, chunk, 1)[0] for t in (x, dt, bm, cm))
    nc, rep = x.shape[1] // chunk, h // g
    xc = x.reshape(bsz, nc, chunk, h, p).movedim(3, 2)    # [B,NC,H,L,P]
    dtc = dt.reshape(bsz, nc, chunk, h).movedim(3, 2)    # [B,NC,H,L]
    bc = bm.reshape(bsz, nc, chunk, g, n).movedim(3, 2)   # [B,NC,G,L,N]
    cc = cm.reshape(bsz, nc, chunk, g, n).movedim(3, 2)
    cb = _tc("bcgin,bcgjn->bcgij", cc, bc, parts).repeat_interleave(rep, 2)
    cs = torch.cumsum(dtc * a[:, None], -1)
    low = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    diff = torch.where(low, cs[..., :, None] - cs[..., None, :], 0.0)
    w = torch.where(low, cb * torch.exp(diff) * dtc[..., None, :], 0.0)
    y = _tc("bchij,bchjp->bchip", w, xc, parts)
    xw = xc * (dtc * torch.exp(cs[..., -1:] - cs))[..., None]
    bh, ch = bc.repeat_interleave(rep, 2), cc.repeat_interleave(rep, 2)
    st = torch.zeros(bsz, h, p, n)
    for c in range(nc):
        y[:, c] += _tc("bhin,bhpn->bhip", ch[:, c], st, parts) * torch.exp(cs[:, c])[..., None]
        st = (torch.exp(cs[:, c, :, -1])[..., None, None] * st
              + _tc("bhsp,bhsn->bhpn", xw[:, c], bh[:, c], parts))
    return y.movedim(2, 3).reshape(bsz, nc * chunk, h, p)[:, :s], st


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_kernel_3xtf32_holds_the_tolerance_where_tf32_does_not(seed):
    """The CUDA kernel runs every product of the scan on the TF32 tensor
    cores, each f32 operand split into a TF32 high and low part.  At
    mamba2-370m's head (P=64, N=128, G=1, chunk 64) that stays within
    ``ref.ssd_tolerance_ratio`` <= 1 of the plain version on y and the final
    state; rounding each operand once to TF32 does not."""
    x, dt, a, bm, cm, _ = _ssd_inputs(1, 1024, 4, 64, 1, 128, seed=seed)
    args = _t(x, dt, a, bm, cm)
    y_w, st_w = tref.ssd_chunked(*args, 64)
    y3, st3 = _ssd_as_the_kernel(*args, 64, _tf32_hi_lo)
    y1, st1 = _ssd_as_the_kernel(*args, 64, _tf32_once)
    split = max(tref.ssd_tolerance_ratio(y3, y_w), tref.ssd_tolerance_ratio(st3, st_w, 1))
    once = min(tref.ssd_tolerance_ratio(y1, y_w), tref.ssd_tolerance_ratio(st1, st_w, 1))
    assert split <= 1, split
    assert once > 1, once


def _tc3(spec, a, b, drop=None):
    """A 3xTF32 product hi.hi + hi.lo + lo.hi, hi by truncation (``_tf32_hi_lo``);
    ``drop`` "a_lo" or "b_lo" leaves out that operand's lo term."""
    (ah, al), (bh, bl) = _tf32_hi_lo(a), _tf32_hi_lo(b)
    out = torch.einsum(spec, ah, bh)
    if drop != "b_lo":
        out = out + torch.einsum(spec, ah, bl)
    if drop != "a_lo":
        out = out + torch.einsum(spec, al, bh)
    return out


# The products of csrc/ssd_scan.cu in the orders its `wgmma`s take them
# (A from registers, B from shared memory along k):
# "cb": CB [j][i] = B [j][n] . C [i][n]; "y_inter": y^T [p][i] = S [p][n] . C [i][n];
# "y_intra": y^T [p][i] += X^T [p][j] . W [i][j]; "state": S [p][n] += (X wd)^T [p][s] . B^T [n][s].
_SSD_WGMMA_PRODUCTS = ("cb", "y_inter", "y_intra", "state")


def _ssd_as_the_wgmma_kernel(x, dt, a, bm, cm, chunk, drop=(None, None)):
    """The SSD scan as csrc/ssd_scan.cu's passes compute it: each product of
    ``_SSD_WGMMA_PRODUCTS`` in 3xTF32 in its own order, W formed from C B^T
    taken transposed, y as y^T, the state update from B^T; decays, sums and
    dt in f32.  ``drop`` = (product, "a_lo" or "b_lo") leaves one lo term
    out of that product."""
    bsz, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    x, dt, bm, cm = (tref._pad_to(t, chunk, 1)[0] for t in (x, dt, bm, cm))
    nc, rep = x.shape[1] // chunk, h // g
    xc = x.reshape(bsz, nc, chunk, h, p).movedim(3, 2)    # [B,NC,H,L,P]
    dtc = dt.reshape(bsz, nc, chunk, h).movedim(3, 2)     # [B,NC,H,L]
    bc = bm.reshape(bsz, nc, chunk, g, n).movedim(3, 2)   # [B,NC,G,L,N]
    cc = cm.reshape(bsz, nc, chunk, g, n).movedim(3, 2)

    def tc(name, spec, u, v):
        return _tc3(spec, u, v, drop[1] if drop[0] == name else None)

    cbt = tc("cb", "bcgjn,bcgin->bcgji", bc, cc).repeat_interleave(rep, 2)  # [j][i]
    cs = torch.cumsum(dtc * a[:, None], -1)
    low = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    diff = torch.where(low, cs[..., :, None] - cs[..., None, :], 0.0)
    w = torch.where(low, cbt.transpose(-1, -2) * torch.exp(diff) * dtc[..., None, :], 0.0)
    yt = tc("y_intra", "bchjp,bchij->bchpi", xc, w)                         # y^T [p][i]
    xw = xc * (dtc * torch.exp(cs[..., -1:] - cs))[..., None]
    bt = bc.transpose(-1, -2).repeat_interleave(rep, 2)                     # B^T [n][s]
    ch = cc.repeat_interleave(rep, 2)
    st = torch.zeros(bsz, h, p, n)
    for c in range(nc):
        yt[:, c] += (tc("y_inter", "bhpn,bhin->bhpi", st, ch[:, c])
                     * torch.exp(cs[:, c])[:, :, None, :])
        st = (torch.exp(cs[:, c, :, -1])[..., None, None] * st
              + tc("state", "bhsp,bhns->bhpn", xw[:, c], bt[:, c]))
    y = yt.transpose(-1, -2)
    return y.movedim(2, 3).reshape(bsz, nc * chunk, h, p)[:, :s], st


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_wgmma_kernel_product_orders_hold_the_tolerance(seed):
    """The `wgmma` kernel's product orders (y^T = X^T W^T, the state update
    from a transposed B, C B^T taken transposed), each in 3xTF32 with hi by
    truncation, stay within ``ref.ssd_tolerance_ratio`` <= 1 at mamba2-370m's
    head (P=64, N=128, G=1, chunk 64)."""
    x, dt, a, bm, cm, _ = _ssd_inputs(1, 1024, 4, 64, 1, 128, seed=seed)
    args = _t(x, dt, a, bm, cm)
    y_w, st_w = tref.ssd_chunked(*args, 64)
    y, st = _ssd_as_the_wgmma_kernel(*args, 64)
    assert tref.ssd_tolerance_ratio(y, y_w) <= 1
    assert tref.ssd_tolerance_ratio(st, st_w, 1) <= 1


@pytest.mark.parametrize("which", ["a_lo", "b_lo"])
@pytest.mark.parametrize("product", _SSD_WGMMA_PRODUCTS)
def test_ssd_wgmma_kernel_needs_every_lo_term(product, which):
    """The same emulation with one lo term of one product dropped misses the
    tolerance (1.6-7.7x at this shape): no lo term of the kernel can go."""
    x, dt, a, bm, cm, _ = _ssd_inputs(1, 1024, 4, 64, 1, 128, seed=0)
    args = _t(x, dt, a, bm, cm)
    y_w, st_w = tref.ssd_chunked(*args, 64)
    y, st = _ssd_as_the_wgmma_kernel(*args, 64, drop=(product, which))
    assert max(tref.ssd_tolerance_ratio(y, y_w), tref.ssd_tolerance_ratio(st, st_w, 1)) > 1


# The matrix products of csrc/ssd_scan_bwd.cu, by the names _ssd_bwd_as_the_kernel gives them.
_SSD_BWD_PRODUCTS = ("local", "cb", "q", "du_intra", "du_inter", "db_inter", "db_intra",
                     "dc_inter", "dc_intra")


def _ssd_bwd_as_the_kernel(x, dt, a, bm, cm, chunk, dy, dst, h_init, parts, plain=()):
    """The SSD scan's gradient computed as csrc/ssd_scan_bwd.cu computes it,
    every matrix product's operands split by ``parts`` (those named in
    ``plain`` rounded once to TF32 instead).  Pass 1: per head and chunk the
    local state (dt e^{cs_last - cs} x)^T B and cotangent (e^{cs} dy)^T C
    ("local"), and C B^T once per group and chunk ("cb"), shared by the
    group's heads; pass 2: the states entering and the cotangents leaving
    each chunk; pass 3: Q = dy x^T ("q"), Mq = Q dt_j E, M = (C B^T) o Mq,
    A = (C B^T) o E, du = A^T dy ("du_intra") + (e^{cs_last - cs_j} B) G^T
    ("du_inter"), dB = (dt e^{cs_last - cs} x) G ("db_inter") + Mq^T C
    ("db_intra"), dC = (e^{cs} dy) S ("dc_inter") + Mq B ("dc_intra"), and
    the decays' gradient as straddling sums with cs scanned in f64 and kept
    as an f32 hi + lo pair (``_da_one_chunk``).  A factor that scales an
    operand's rows is applied before the split; decays, sums and dt stay
    f32."""
    def tc(name, spec, u, v):
        return _tc(spec, u, v, _tf32_once if name in plain else parts)

    bsz, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    x, dt, bm, cm, dy = (tref._pad_to(t, chunk, 1)[0] for t in (x, dt, bm, cm, dy))
    nc, rep, L = x.shape[1] // chunk, h // g, chunk
    xc, dyc = (t.reshape(bsz, nc, L, h, p).movedim(3, 2) for t in (x, dy))   # [B,NC,H,L,P]
    dtc = dt.reshape(bsz, nc, L, h).movedim(3, 2)                             # [B,NC,H,L]
    bg, cg = (t.reshape(bsz, nc, L, g, n).movedim(3, 2) for t in (bm, cm))   # [B,NC,G,L,N]
    bc, cc = bg.repeat_interleave(rep, 2), cg.repeat_interleave(rep, 2)
    c64 = torch.cumsum((dtc * a[:, None]).double(), -1)
    hi = c64.float()
    lo = (c64 - hi.double()).float()
    low = torch.tril(torch.ones(L, L, dtype=torch.bool))
    ex = (hi[..., :, None] - hi[..., None, :]) + (lo[..., :, None] - lo[..., None, :])
    e = torch.where(low, torch.exp(torch.where(low, ex, 0.0)), 0.0)
    ein = torch.exp(hi)
    eout = torch.exp((hi[..., -1:] - hi) + (lo[..., -1:] - lo))
    wout = dtc * eout
    dec = torch.exp(hi[..., -1])[..., None, None]                             # [B,NC,H,1,1]
    local_st = tc("local", "bchjp,bchjn->bchpn", xc * wout[..., None], bc)
    local_ct = tc("local", "bchip,bchin->bchpn", dyc * ein[..., None], cc)
    cb = tc("cb", "bcgin,bcgjn->bcgij", cg, bg).repeat_interleave(rep, 2)
    st, ct = torch.empty_like(local_st), torch.empty_like(local_ct)
    carry = torch.zeros(bsz, h, p, n) if h_init is None else h_init
    for c in range(nc):
        st[:, c] = carry
        carry = local_st[:, c] + dec[:, c] * carry
    carry = dst
    for c in range(nc - 1, -1, -1):
        ct[:, c] = carry
        carry = dec[:, c] * carry + local_ct[:, c]
    mq = torch.where(low, tc("q", "bchip,bchjp->bchij", dyc, xc) * dtc[..., None, :] * e, 0.0)
    m = torch.where(torch.tril(low, -1), cb * mq, 0.0)
    du = (tc("du_intra", "bchij,bchip->bchjp", cb * e, dyc)
          + tc("du_inter", "bchjn,bchpn->bchjp", bc * eout[..., None], ct))
    ug = tc("db_inter", "bchjp,bchpn->bchjn", xc * wout[..., None], ct)
    dbh = ug + tc("db_intra", "bchij,bchin->bchjn", mq, cc)
    ys = tc("dc_inter", "bchip,bchpn->bchin", dyc * ein[..., None], st)
    dch = ys + tc("dc_intra", "bchij,bchjn->bchin", mq, bc)
    pre = torch.cumsum(m, -1) - m  # each row's exclusive prefix over j
    dda = (torch.stack([pre[..., k:, k].sum(-1) for k in range(L)], -1)
           + torch.flip(torch.cumsum(torch.flip((cc * ys).sum(-1), [-1]), -1), [-1])
           + torch.cumsum((bc * ug).sum(-1), -1) - (bc * ug).sum(-1)
           + dec[..., 0] * (ct * st).sum((-1, -2))[..., None])
    ddt = (xc * du).sum(-1) + a[:, None] * dda
    def seq(t):  # [B,NC,H or G,L,...] -> [B,S,H or G,...]
        return t.movedim(2, 3).reshape(bsz, nc * L, *t.shape[2:3], *t.shape[4:])[:, :s]

    def grp(t):  # per head -> summed over each group's heads
        return seq(t.reshape(bsz, nc, g, rep, L, n).sum(3))

    return (seq(dtc[..., None] * du), seq(ddt), (dtc * dda).sum((0, 1, 3)), grp(dbh), grp(dch),
            None if h_init is None else carry)


def _ssd_bwd_case(head: str):
    """Inputs, cotangents and the plain backward's gradients at mamba2-370m's
    head (P=64, N=128, chunk 64) or at jamba's (P=64, N=16, chunk 64) with
    its fastest decays, a = -(121..128) of jamba's -(1..128); h_init given,
    so that all six gradients are held."""
    n = 128 if head == "mamba" else 16
    h = 4 if head == "mamba" else 8
    x, dt, a, bm, cm, h0 = _ssd_inputs(1, 512, h, 64, 1, n, h_init=True, seed=21)
    if head == "jamba":
        a = -np.arange(129 - h, 129, dtype=np.float32)
    rng = np.random.default_rng(22)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dst = rng.standard_normal(h0.shape).astype(np.float32)
    args = (*_t(x, dt, a, bm, cm), 64, *_t(dy, dst, h0))
    return args, tref.ssd_chunked_bwd(*args[:-1], h_init=args[-1])


@pytest.mark.parametrize("head", ["mamba", "jamba"])
def test_ssd_bwd_kernel_3xtf32_holds_the_tolerance_where_tf32_does_not(head):
    """The backward kernel's products in 3xTF32, in its passes and with its
    decays' gradient (``_ssd_bwd_as_the_kernel``), stay within
    ``ref.ssd_grad_tolerance_ratio`` <= 1 of the plain backward on all six
    gradients, at mamba2-370m's head and at jamba's fastest decays (at most
    0.05, on da); with every product in plain TF32 the worst gradient reads
    far past it (16.7 on da at mamba's head, 19.4 on ddt at jamba's)."""
    args, want = _ssd_bwd_case(head)
    split = tref.ssd_grad_ratios(_ssd_bwd_as_the_kernel(*args, _tf32_hi_lo), want)
    once = tref.ssd_grad_ratios(_ssd_bwd_as_the_kernel(*args, _tf32_once), want)
    assert len(split) == 6 and max(split.values()) <= 1, split
    assert max(once.values()) > 1, once


@pytest.mark.parametrize("product", _SSD_BWD_PRODUCTS)
def test_ssd_bwd_kernel_needs_3xtf32_in_every_product(product):
    """At mamba2-370m's head no product of the backward kernel may drop to
    plain TF32: that one product rounded once to TF32, the others in 3xTF32,
    takes some gradient past the tolerance (2.0 to 13.6 times it)."""
    args, want = _ssd_bwd_case("mamba")
    ratios = tref.ssd_grad_ratios(_ssd_bwd_as_the_kernel(*args, _tf32_hi_lo, plain=(product,)),
                                  want)
    assert max(ratios.values()) > 1, ratios


def _ssd_by_segments(x, dt, a, bm, cm, chunk, seg_chunks, h_init=None, drop=None,
                     entering_only=False):
    """The kernel's segment-parallel scan, built from ``ref.ssd_chunked``:
    each segment of ``seg_chunks`` chunks is scanned from a zero state (its
    local state) with its total decay exp(sum of dA); the combine gives each
    segment its entering state (segment 0: h_init or 0; then entering(k+1) =
    local(k) + decay(k) * entering(k)); the outputs are each segment scanned
    again from its entering state.  ``drop``: a planted fault, the state
    entering that segment dropped from its outputs.  ``entering_only``:
    (None, the state entering each segment and the final state)."""
    s, seg = x.shape[1], seg_chunks * chunk
    cuts = [(i, min(s, i + seg)) for i in range(0, s, seg)]
    part = lambda t, lo, hi: t[:, lo:hi]  # noqa: E731
    local, decay = [], []
    for lo, hi in cuts:
        _, st = tref.ssd_chunked(*(part(t, lo, hi) for t in (x, dt)), a,
                                 *(part(t, lo, hi) for t in (bm, cm)), chunk)
        local.append(st)
        decay.append(torch.exp((dt[:, lo:hi] * a).sum(1)))  # [B,H]
    entering = [torch.zeros_like(local[0]) if h_init is None else h_init]
    for k in range(len(cuts)):
        entering.append(local[k] + decay[k][..., None, None] * entering[k])
    if entering_only:
        return None, entering
    ys = [tref.ssd_chunked(*(part(t, lo, hi) for t in (x, dt)), a,
                           *(part(t, lo, hi) for t in (bm, cm)), chunk,
                           h_init=None if k == drop else entering[k])[0]
          for k, (lo, hi) in enumerate(cuts)]
    return torch.cat(ys, 1), entering[-1]


@pytest.mark.parametrize("s,chunk,seg_chunks,h_init", [
    (1024, 64, 4, False),      # four whole segments
    (1000, 64, 3, True),       # ragged last chunk inside a short last segment, h_init
    (777, 16, 5, True),        # segment edges that are not a power of two
    (512, 32, 16, False),      # one segment: the plain scan itself
])
def test_ssd_segment_decomposition_matches_the_whole_scan(s, chunk, seg_chunks, h_init):
    """The algebra of the kernel's segment passes (local states, combine,
    outputs) against ``ref.ssd_chunked`` over the whole sequence, within the
    tolerance the kernel is held to."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(2, s, 4, 16, 2, 32, h_init=h_init, seed=7)
    args = _t(x, dt, a, bm, cm)
    h0 = _t(h0)[0]
    y_w, st_w = tref.ssd_chunked(*args, chunk, h_init=h0)
    y, st = _ssd_by_segments(*args, chunk, seg_chunks, h_init=h0)
    assert y.shape == y_w.shape
    assert tref.ssd_tolerance_ratio(y, y_w) <= 1
    assert tref.ssd_tolerance_ratio(st, st_w, head_dim=1) <= 1
    if s > seg_chunks * chunk:  # the state entering segment 1 dropped: a fault it sees
        y_d, _ = _ssd_by_segments(*args, chunk, seg_chunks, h_init=h0, drop=1)
        assert tref.ssd_tolerance_ratio(y_d, y_w) > 1
