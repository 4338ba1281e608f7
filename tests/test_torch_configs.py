"""The port's model configurations against the JAX package's, field by field.

``repro_torch.configs`` keeps its own copy of every configuration it runs
(it imports nothing of ``repro``); each copy must equal the reference's
``CONFIG`` and ``SMOKE``.
"""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, get_config

PORTED = ("llama3_8b", "yi_9b", "h2o_danube_3_4b", "gemma_7b", "mistral_large_123b",
          "llama_80b", "gpt_80b", "mamba2_370m", "deepseek_moe_16b", "granite_moe_1b_a400m",
          "deepseek_v3_16b", "jamba_v0_1_52b", "paligemma_3b", "seamless_m4t_medium")


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", PORTED)
def test_ported_configs_equal_jax(arch, smoke):
    got, want = get_config(arch, smoke=smoke), jbase.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if want.n_heads:  # attention layers (mamba2-370m has none)
        assert got.resolved_head_dim == want.resolved_head_dim
    assert got.pattern == want.pattern and got.n_periods == want.n_periods


def test_paper_archs_match_jax():
    assert PAPER_ARCHS == jbase.PAPER_ARCHS


def test_assigned_archs_match_jax():
    """The model zoo, every member of which the port now has."""
    assert ASSIGNED_ARCHS == jbase.ASSIGNED_ARCHS
    assert set(ASSIGNED_ARCHS) <= set(PORTED)


@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_paper_eval_configs_resolve(arch):
    """The twin of tests/test_models.py's: each of the paper's Table 3 models
    resolves in the port."""
    cfg = get_config(arch)
    assert cfg.n_layers > 0 and cfg.d_model > 0
    assert cfg.resolved_head_dim == jbase.get_config(arch).resolved_head_dim
