"""The port's layers against ``repro.models.layers`` on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.models import layers as tl

ATOL = 1e-6


def _rng():
    return np.random.default_rng(0)


def test_rms_norm_matches_jax():
    rng = _rng()
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dh,theta", [(16, 10000.0), (120, 500000.0)])
def test_rope_matches_jax(dh, theta):
    rng = _rng()
    x = rng.standard_normal((2, 12, 3, dh)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)[None, :] + 3
    got = tl.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    want = jl.rope_apply(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_gated_mlp_matches_jax(act):
    rng = _rng()
    d, f = 32, 48
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    got = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act).numpy()
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_padded_vocab_and_init_scale():
    cfg = get_config("llama3_8b")
    assert tl.padded_vocab(cfg) == 128256
    assert tl.padded_vocab(cfg.replace(vocab_size=32001)) == 32256
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init((512, 256), torch.bfloat16, gen, "cpu")
    assert w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 1 / np.sqrt(512)) < 2e-3


def test_public_helpers_default_to_the_card_and_take_the_cpu_when_asked():
    """The port's helpers that make tensors default to ``device="cuda"`` like
    ``init_lm`` and ``init_ssm_cache``; the CPU only when the caller asks."""
    import inspect

    from repro_torch.models import attention as ta
    from repro_torch.models import ssm as tssm
    from repro_torch.models import transformer as tf
    for fn in (ta.make_mask, ta.init_kv_cache, tl.rms_norm_init, tf.init_lm,
               tssm.init_ssm_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    m = ta.make_mask(4, 6, causal=True, window=None, q_offset=2, device="cpu")
    assert m.device.type == "cpu" and m.shape == (1, 1, 4, 6)
    assert torch.equal(m[0, 0], torch.arange(6)[None, :] <= torch.arange(4)[:, None] + 2)
    cfg = get_config("llama3_8b", smoke=True)
    cache = ta.init_kv_cache(cfg, 2, 8, torch.float32, device="cpu")
    assert cache["k"].device.type == "cpu"
    assert cache["k"].shape == (2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    w = tl.rms_norm_init(16, device="cpu")
    assert w.device.type == "cpu" and torch.equal(w, torch.zeros(16))
