"""Test harness: 8 virtual CPU devices for the multi-device tests.

Set BEFORE any jax import (device count locks at first init).  The 512-dev
forcing is reserved for launch/dryrun.py only (per the brief); 8 devices
keeps the suite's shard_map/GSPMD coverage honest while smoke tests simply
use device 0.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import importlib.util  # noqa: E402
import sys  # noqa: E402

if importlib.util.find_spec("hypothesis") is None:
    # The container has no `hypothesis` (and installing packages is not an
    # option).  Install a deterministic miniature stand-in that supports
    # exactly the strategy surface the suite uses (lists / integers /
    # sampled_from) so the property tests still run as seeded fuzz tests.
    import functools
    import inspect
    import random
    import types

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _integers(lo, hi):
        return _Strategy(lambda r: r.randint(lo, hi))

    def _sampled_from(seq):
        seq = list(seq)
        return _Strategy(lambda r: r.choice(seq))

    def _lists(elem, min_size=0, max_size=10):
        def draw(r):
            n = r.randint(min_size, max_size)
            return [elem.draw(r) for _ in range(n)]
        return _Strategy(draw)

    def _given(*strategies):
        # like hypothesis: drawn values bind to the RIGHTMOST parameters;
        # the exposed signature keeps only the leading (fixture) params so
        # pytest still injects them in the no-hypothesis container
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kw):
                n = getattr(wrapper, "_max_examples",
                            getattr(fn, "_max_examples", 50))
                rng = random.Random(0)
                for _ in range(n):
                    fn(*args, *(s.draw(rng) for s in strategies), **kw)
            sig = inspect.signature(fn)
            params = list(sig.parameters.values())
            wrapper.__signature__ = sig.replace(
                parameters=params[:len(params) - len(strategies)])
            return wrapper
        return deco

    def _settings(max_examples=50, deadline=None, **_):
        def deco(fn):
            fn._max_examples = max_examples
            return fn
        return deco

    _h = types.ModuleType("hypothesis")
    _h.given = _given
    _h.settings = _settings
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.sampled_from = _sampled_from
    _st.lists = _lists
    _h.strategies = _st
    sys.modules["hypothesis"] = _h
    sys.modules["hypothesis.strategies"] = _st

import jax  # noqa: E402
import pytest  # noqa: E402

from repro import compat  # noqa: E402,F401  (installs jax compat aliases)


@pytest.fixture(scope="session")
def mesh8():
    return jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture(scope="session")
def mesh_pod():
    return jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


@pytest.fixture(scope="session")
def mesh_data8():
    return jax.make_mesh((8,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips elsewhere")
