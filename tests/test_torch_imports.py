"""The port loads neither JAX nor the JAX package: every module of
lammps_plugins_tpu_torch (core/region.py, potentials/ljcut.py and none.py,
fixes/bfield.py, the input-script modules api/script.py, equalvar.py and
data.py, run/dump.py, checkpoint.py and minimize.py, fixes/langevin.py
and core/threefry.py, parallel/sharded_engine.py and entry.py among them)
and chip_smoke.py's imports are loaded, and one Engine.evaluate runs on
the CPU, a step of the charged melt with fix bfield, a deck through the
port's Script (per-atom computes, a dump, a restart file, a data file,
FIRE and fix langevin), entry() and the sharded dryrun on two shards, in
a fresh interpreter that must end with no `jax` and no
`lammps_plugins_tpu` module in sys.modules.  The entry points, Script
among them, default to the card and raise without one."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, os, pkgutil, sys
import lammps_plugins_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.ops_modules()
from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
from lammps_plugins_tpu_torch.core import units
from lammps_plugins_tpu_torch.fixes.nve import FixNVE
from lammps_plugins_tpu_torch.ops import native
from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
from lammps_plugins_tpu_torch.run.simulation import Engine
f64 = dict(dtype=__import__("torch").float64, device="cpu")
eng = Engine(rebomos_bulk(**f64),
             REBOMoS.from_file(sys.argv[1], ["M", "S"], **f64),
             [FixNVE()], units.METAL)
eng.device_rebuild = False           # the host build: the native pair search
pe, _ = eng.evaluate()
assert abs(float(pe) / 288 + 3.5787) < 1e-3, float(pe)
from lammps_plugins_tpu_torch.api.scenes import charged_melt
for m in ("core.region", "potentials.ljcut", "potentials.none",
          "fixes.bfield"):
    assert "lammps_plugins_tpu_torch." + m in names, m
melt = charged_melt(2, **f64).engine()
melt.run(2)
for m in ("api.script", "api.equalvar", "api.data", "run.dump",
          "run.checkpoint", "run.minimize", "fixes.langevin",
          "core.threefry"):
    assert "lammps_plugins_tpu_torch." + m in names, m
import tempfile
from lammps_plugins_tpu_torch import Script
tmp = tempfile.mkdtemp()
s = Script(log=lambda _: None, **f64)
s.run_text(f'''
units lj
lattice fcc 0.8442
region box block 0 2 0 2 0 2
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
neighbor 0.3 bin
compute pe all pe/atom
compute s all stress/atom NULL
dump 1 all custom 2 {tmp}/d.dump id type x c_pe c_s[1]
restart 2 {tmp}/r.*
fix 1 all langevin 1.0 1.0 0.5 48279
fix 2 all nve
minimize 0.0 1e-4 10
run 4
write_data {tmp}/w.data
''')
assert open(f"{tmp}/d.dump").read().count("ITEM: TIMESTEP") == 3
assert os.path.exists(f"{tmp}/r.4") and os.path.exists(f"{tmp}/w.data")
for m in ("parallel", "parallel.sharded_engine", "entry"):
    assert "lammps_plugins_tpu_torch." + m in names, m
from lammps_plugins_tpu_torch.entry import dryrun_multichip, entry
fn, args = entry(**f64)
assert abs(float(fn(*args)[0]) / 288 + 3.5787) < 1e-3
dryrun_multichip(2, **f64)
build = os.path.join(os.path.dirname(os.path.dirname(pkg.__file__)), "build")
assert native.LIB_PATH.startswith(build + os.sep), native.LIB_PATH
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "lammps_plugins_tpu"))
print("MODULES", len(names), "FORBIDDEN", bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_jax_package():
    # two threads: the suite's other workers share the cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT,
         os.path.join(REPO, "tests", "data", "MoS.REBO.synthetic")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FORBIDDEN []" in res.stdout


def _entry_points():
    from lammps_plugins_tpu_torch.api import scenes
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.neighbor.build import build_neighbor_data
    from lammps_plugins_tpu_torch.potentials.aeam import AEAM
    from lammps_plugins_tpu_torch.potentials.ljcut import (PairLJCut,
                                                           PairLJCutCoulCut)
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.potentials.tables import read_rebomos
    from lammps_plugins_tpu_torch.api.data import read_data
    from lammps_plugins_tpu_torch.api.script import Script
    from lammps_plugins_tpu_torch.entry import dryrun_multichip, entry
    from lammps_plugins_tpu_torch.run.checkpoint import load_state
    from torch_parity import SYNTH_AEAM, SYNTH_REBO
    import numpy as np
    x = np.array([[0.0, 0.0, 0.0], [2.4, 0.0, 0.0]])
    box64 = Box.triclinic(10.0, 10.0, 10.0, dtype=torch.float64,
                          device="cpu")
    return {
        "rebomos_bulk": lambda: scenes.rebomos_bulk(),
        "rebomos_bulk_commensurate":
            lambda: scenes.rebomos_bulk_commensurate(2, 2, 1),
        "Box.triclinic": lambda: Box.triclinic(10.0, 10.0, 10.0),
        "Box.from_numpy": lambda: Box.from_numpy(np.eye(3) * 10.0),
        "REBOMoS": lambda: REBOMoS(read_rebomos(SYNTH_REBO), [-1, 0, 1]),
        "REBOMoS.from_file":
            lambda: REBOMoS.from_file(SYNTH_REBO, ["M", "S"]),
        "build_neighbor_data": lambda: build_neighbor_data(
            x, np.array([1, 2]), box64, {"rebo": 3.0}),
        "alsi_sample": lambda: scenes.alsi_sample(nc=2),
        "Box.orthogonal": lambda: Box.orthogonal([10.0, 10.0, 10.0]),
        "AEAM.from_file": lambda: AEAM.from_file(SYNTH_AEAM, ["Al", "Si"]),
        "lj_melt": lambda: scenes.lj_melt(2),
        "charged_melt": lambda: scenes.charged_melt(2),
        "rebomos_monolayer": lambda: scenes.rebomos_monolayer(2, 2),
        "PairLJCut": lambda: PairLJCut(2.5),
        "PairLJCutCoulCut": lambda: PairLJCutCoulCut(6.0, 8.0),
        "Script": lambda: Script(),
        "load_state": lambda: load_state("restart.npz"),
        "read_data": lambda: read_data("system.data"),
        "entry": lambda: entry(),
        "dryrun_multichip": lambda: dryrun_multichip(2),
    }


@pytest.mark.parametrize("name", ["rebomos_bulk", "rebomos_bulk_commensurate",
                                  "Box.triclinic", "Box.from_numpy",
                                  "REBOMoS", "REBOMoS.from_file",
                                  "build_neighbor_data", "alsi_sample",
                                  "Box.orthogonal", "AEAM.from_file",
                                  "lj_melt", "charged_melt",
                                  "rebomos_monolayer", "PairLJCut",
                                  "PairLJCutCoulCut", "Script",
                                  "load_state", "read_data", "entry",
                                  "dryrun_multichip"])
def test_entry_point_without_device_raises_without_cuda(monkeypatch, name):
    """Called without `device`, an entry point asks for the card; with no
    CUDA device it raises a clear error instead of running on the CPU."""
    call = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_entry_point_defaults_are_the_card_in_float32():
    import inspect
    from lammps_plugins_tpu_torch.api import scenes
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.neighbor.build import build_neighbor_data
    from lammps_plugins_tpu_torch.potentials.aeam import AEAM
    from lammps_plugins_tpu_torch.potentials.ljcut import (PairLJCut,
                                                           PairLJCutCoulCut)
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.api.data import read_data
    from lammps_plugins_tpu_torch.api.script import Script
    from lammps_plugins_tpu_torch.entry import dryrun_multichip, entry
    from lammps_plugins_tpu_torch.run.checkpoint import load_state
    for fn in (scenes.rebomos_bulk, scenes.rebomos_bulk_commensurate,
               Box.triclinic, Box.from_numpy, REBOMoS.__init__,
               REBOMoS.from_file, build_neighbor_data, scenes.alsi_sample,
               Box.orthogonal, AEAM.__init__, AEAM.from_file,
               scenes.lj_melt, scenes.charged_melt,
               scenes.rebomos_monolayer, PairLJCut.__init__,
               PairLJCutCoulCut.__init__, Script.__init__, load_state,
               read_data, entry, dryrun_multichip):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda", fn
        assert params["dtype"].default is torch.float32, fn
