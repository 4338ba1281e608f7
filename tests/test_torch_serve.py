"""The port's serving path against the JAX package's, on the CPU, in f32.

Parameters are made by ``repro.models.transformer.init_lm``, flattened to
numpy by path and handed to the port through ``repro_torch.bridge``; tokens
are made with numpy.  Logits agree to atol 1e-4, the tolerance of
tests/test_serve.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import transformer as T
from repro.parallel.sharding import _path_str
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as tf
from repro_torch.serve.step import (ServeSetup, init_serve_state, make_decode_step,
                                    make_prefill_step)

ATOL = 1e-4


def _flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {_path_str(path): np.asarray(x) for path, x in leaves}


def _pair(arch: str):
    jcfg = jax_config(arch, smoke=True).replace(dtype="float32")
    tcfg = get_config(arch, smoke=True).replace(dtype="float32")
    jparams = T.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_numpy(_flat(jparams), "cpu", dtype="float32")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def yi():
    return _pair("yi_9b")


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


class _Spy:
    """Counts calls of an ``ops`` entry, to show which branch the path took."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        fn = getattr(ops, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        monkeypatch.setattr(ops, name, wrapped)


def test_bridge_round_trip_is_bit_exact(yi):
    _, _, jparams, tparams = yi
    flat = _flat(jparams)
    assert set(flat) >= {"embed", "layers/0/mixer/wq", "layers/0/ffn/w_gate",
                         "final_norm", "unembed"}
    assert isinstance(tparams["layers"], list)
    back = bridge.to_numpy(tparams)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_bridge_takes_bf16():
    arr = np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3))
    t = bridge.from_numpy({"layers/0/w": arr}, "cpu")["layers"][0]["w"]
    assert t.dtype == torch.bfloat16
    assert torch.equal(t, torch.arange(6, dtype=torch.bfloat16).reshape(2, 3))


def test_bridge_casts_floating_leaves_only():
    tree = {"embed": np.ones((4, 2), np.float32), "layers/0/ids": np.arange(3)}
    p = bridge.from_numpy(tree, "cpu", dtype="bfloat16")
    assert p["embed"].dtype == torch.bfloat16
    assert p["layers"][0]["ids"].dtype == torch.int64


def test_prefill_matches_jax_prefill(yi):
    jcfg, tcfg, jparams, tparams = yi
    toks = _tokens(2, 12, tcfg.vocab_size, seed=4)
    want, _ = T.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 16)
    got, _ = tf.prefill(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch,b,s", [("yi_9b", 8, 12), ("llama3_8b", 2, 12),
                                      ("yi_9b", 2, 1024),
                                      # GeGLU, tied embeddings, head dim 32 on d_model 64
                                      ("gemma_7b", 2, 12), ("gemma_7b", 2, 1024),
                                      # the paper's Table 3 models and mistral-large
                                      ("llama_80b", 2, 12), ("gpt_80b", 2, 12),
                                      ("mistral_large_123b", 2, 12), ("llama_80b", 1, 1024)])
def test_prefill_matches_jax(arch, b, s, monkeypatch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    toks = _tokens(b, s, tcfg.vocab_size)
    want, _ = jax.jit(lambda p, t: T.lm_forward(p, {"tokens": t}, jcfg, last_only=True))(
        jparams, jnp.asarray(toks))
    spy = _Spy(monkeypatch, "mha")
    step = make_prefill_step(ServeSetup(cfg=tcfg), (1, 1), tparams)
    got = step(tparams, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (b, 1, tcfg.vocab_size + (-tcfg.vocab_size) % 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # S >= 1024 takes the flash branch, once per layer
    assert spy.calls == (tcfg.n_layers if s >= 1024 else 0)


def _jax_decode(jcfg, jparams, toks, cap):
    step = jax.jit(lambda p, st, tok, pos: T.decode_step(p, st, tok, pos, jcfg))
    st = T.init_decode_state(jcfg, toks.shape[0], cap)
    outs = []
    for t in range(toks.shape[1]):
        lg, st = step(jparams, st, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        outs.append(np.asarray(lg[:, 0]))
    return np.stack(outs, 1)


def _port_decode(tcfg, tparams, toks, cap):
    setup = ServeSetup(cfg=tcfg)
    state = init_serve_state(setup, (1, 1), tparams, toks.shape[0], cap)
    step = make_decode_step(setup, (1, 1), tparams, batch=toks.shape[0], capacity=cap)
    outs = []
    for t in range(toks.shape[1]):
        lg, state = step(tparams, state, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        outs.append(lg[:, 0].numpy())
    return np.stack(outs, 1), state


@pytest.mark.parametrize("cap", [16, 4096])
def test_decode_matches_jax(yi, cap, monkeypatch):
    jcfg, tcfg, jparams, tparams = yi
    toks = _tokens(4, 12, tcfg.vocab_size, seed=2)
    want = _jax_decode(jcfg, jparams, toks, cap)
    spy = _Spy(monkeypatch, "decode_attention")
    got, state = _port_decode(tcfg, tparams, toks, cap)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # capacity >= 4096 takes the flash-decode branch, once per layer and step
    assert spy.calls == (tcfg.n_layers * 12 if cap >= 4096 else 0)
    assert state[0]["slot_pos"][:, :12].tolist() == [list(range(12))] * tcfg.n_layers


@pytest.mark.parametrize("arch", ["yi_9b", "h2o_danube_3_4b", "mamba2_370m", "gemma_7b"])
def test_decode_matches_forward(arch):
    """The twin of tests/test_models.py's: the port's cached decode, token by
    token, gives the port's teacher-forced forward logits at every position
    (atol 2e-3, as there), and that forward gives the JAX package's."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    toks = _tokens(2, 12, tcfg.vocab_size, seed=5)
    want, _ = T.lm_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    fwd, _ = tf.lm_forward(tparams, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(want), atol=ATOL)
    got, _ = _port_decode(tcfg, tparams, toks, toks.shape[1])
    np.testing.assert_allclose(got, fwd.numpy(), atol=2e-3)


def test_swa_ring_decode_matches_jax():
    """h2o-danube smoke: window 16, so a ring cache of 16 slots that wraps."""
    jcfg, tcfg, jparams, tparams = _pair("h2o_danube_3_4b")
    toks = _tokens(2, 24, tcfg.vocab_size, seed=3)
    want = _jax_decode(jcfg, jparams, toks, 32)
    got, state = _port_decode(tcfg, tparams, toks, 32)
    assert state[0]["k"].shape[2] == tcfg.sliding_window
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_serve_main_runs_on_cpu(capsys):
    out = launch_serve.main(["--arch", "llama3_8b", "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    assert out["continuation"].shape == (2, 4)
    assert torch.isfinite(out["logits"]).all()
    assert "served 2 seqs x 9 steps" in capsys.readouterr().out


@pytest.mark.parametrize("flags,word", [(["--plane-report"], "OCS 50 ms"),
                                        (["--plane-report", "--ocs-latency", "0.01"],
                                         "OCS 10 ms")])
def test_serve_main_refuses_unported_options(flags, word, capsys):
    """``--plane-report`` and ``--ocs-latency``, refused until the control
    plane was ported: after serving, the driver prints the report that the
    JAX driver's ``plane_report`` prints for its mesh, with the decode
    capacity as the sequence length (serve/train parity)."""
    from test_torch_plane import jax_report
    out = launch_serve.main(["--arch", "llama3_8b", "--smoke", "--device", "cpu", "--batch",
                             "2", "--prompt-len", "5", "--gen", "4", *flags])
    printed = capsys.readouterr().out
    ocs = float(flags[-1]) if "--ocs-latency" in flags else 0.05
    want, p = jax_report("llama3_8b", {"data": 1, "model": 1}, 2, 9, ocs)
    assert word in printed and printed.endswith(want)
    assert out["plane"] == p


def test_serve_main_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        launch_serve.main(["--arch", "llama3_8b", "--smoke"])


class _FourRails:
    """A mesh's shape without its process groups: 4 rails, a model axis of 1."""
    mesh_dim_names, shape = ("data", "model"), (4, 1)

    def size(self, i: int) -> int:
        return self.shape[i]

    def get_group(self, name):
        return None


def test_sharded_serving_and_other_families_raise(yi):
    _, tcfg, _, tparams = yi
    # the resident step on one device runs its products over the rails' one
    # rank (``RailShard``), bit-equal to the gathered step, caches too
    resident = ServeSetup(cfg=tcfg, weight_resident=True)
    step = make_decode_step(resident, (1, 1), tparams, batch=2, capacity=16)
    gathered = make_decode_step(ServeSetup(cfg=tcfg), (1, 1), tparams, batch=2, capacity=16)
    states = [init_serve_state(s, (1, 1), tparams, 2, 16) for s in (resident, ServeSetup(cfg=tcfg))]
    tok = torch.ones((2, 1), dtype=torch.long)
    for pos in range(3):
        got = step(tparams, states[0], tok, pos)[0]
        want = gathered(tparams, states[1], tok, pos)[0]
        assert torch.equal(got, want)
        tok = want.argmax(-1)
    assert all(torch.equal(x, y) for a, b in zip(*states) for x, y in zip(a.values(), b.values()))
    assert step.rails.combines > 0 and not hasattr(gathered, "rails")
    with pytest.raises(ValueError, match="a tuple is one device"):
        make_prefill_step(ServeSetup(cfg=tcfg), (4, 2), tparams)
    for fn in (lambda: make_decode_step(ServeSetup(cfg=tcfg), _FourRails(), tparams, batch=6,
                                        capacity=16),
               lambda: init_serve_state(ServeSetup(cfg=tcfg), _FourRails(), tparams, 6, 16),
               lambda: make_decode_step(resident, _FourRails(), tparams, batch=6, capacity=16)):
        with pytest.raises(ValueError, match="batch 6 does not split over 4 rails"):
            fn()
    with pytest.raises(NotImplementedError, match="MoE"):
        tf.init_lm(tcfg.replace(family="moe"), device="cpu")
