"""The port and chip_smoke.py import neither JAX nor the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, ".")
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
missing = sorted({"repro_torch.sim.opus_sim", "repro_torch.sim.workload", "repro_torch.core.plane",
                  "repro_torch.core.fabric", "repro_torch.parallel.resident"} - set(names))
assert not missing, missing
"""


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, the copied control plane and simulator
    (``repro_torch.core``, ``repro_torch.sim``) among them, and
    chip_smoke.py import neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 33, res.stdout
