"""The port loads no JAX: every module of lammps_plugins_tpu_torch is
imported, and one Engine.evaluate runs, in a fresh interpreter that must
end with no `jax` in sys.modules."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import lammps_plugins_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from lammps_plugins_tpu.core import units
from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
from lammps_plugins_tpu_torch.fixes.nve import FixNVE
from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
from lammps_plugins_tpu_torch.run.simulation import Engine
eng = Engine(rebomos_bulk(), REBOMoS.from_file(sys.argv[1], ["M", "S"]),
             [FixNVE()], units.METAL)
pe, _ = eng.evaluate()
assert abs(float(pe) / 288 + 3.5787) < 1e-3, float(pe)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print("MODULES", len(names), "JAX", bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    # two threads: the suite's other workers share the cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT,
         os.path.join(REPO, "tests", "data", "MoS.REBO.synthetic")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX []" in res.stdout
