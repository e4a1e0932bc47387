"""The port's Script with n_devices > 1 (the sharded engine, `mpirun -np
N`) against the JAX package's Script(n_devices=4), float64 on the CPU.

The deck is in.rebomos-bulk with the synthetic parameters, its prism
widened to 0 16 (1,152 atoms, four x-slabs of 12.8 A beside an 11.0 A
halo margin at `neighbor 0.5`), 600 K velocities, 20 steps, thermo rows
at steps 0 and 20 (a sharded thermo row is an autograd pass per shard,
seconds on the CPU).  Rows are held to 1e-9 relative to each column's
scale.  Then, on a small charged LJ deck (fix bfield + fix nve), the
sharded Script against the port's single-device Script: its f_ columns
through fix_view_state, a restart file of the gathered state, and the
refusals of the single-device commands (minimize, per-atom computes).
Each test runs the port's shards in both placements, stacked and per
device (Script(placement=...)).
"""

import os
import warnings

import numpy as np
import pytest
import torch

from test_torch_script import KEYS, REBO_DECK, _close

DECK = (REBO_DECK.replace("prism 0 4 0 8 0 1", "prism 0 16 0 8 0 1")
        .replace("thermo          10\n", "neighbor        0.5 bin\n"
                 "velocity        all create 600.0 12345\n"
                 "thermo          20\n"))

LJ_DECK = """
units           metal
atom_style      charge
lattice         bcc 4.2
region          box block 0 16 0 4 0 4
create_box      2 box
create_atoms    1 box
set             group all type/fraction 2 0.5 777
set             type 1 charge 1.0
set             type 2 charge -1.0
mass            1 22.99
mass            2 35.45
pair_style      lj/cut/coul/cut 6.0 6.0
pair_coeff      1 1 0.01 2.5
pair_coeff      2 2 0.01 3.4
neighbor        0.5 bin
velocity        all create 600.0 4928459
fix             B all bfield 0.0 0.0 5.0
fix             1 all nve
thermo_style    custom step temp pe press f_B f_B[1] f_B[2]
thermo          10
"""


PLACEMENTS = ("stacked", "per_device")


def _script(pkg, n=1, log=None, placement=None):
    if pkg == "jax":
        from lammps_plugins_tpu.api.script import Script
        return Script(log=log or (lambda _: None), n_devices=n)
    from lammps_plugins_tpu_torch.api.script import Script
    return Script(log=log or (lambda _: None), dtype=torch.float64,
                  device="cpu", n_devices=n,
                  devices=["cpu"] * n if n > 1 else None, placement=placement)


def _run(s, text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.run_text(text)
    return s


@pytest.fixture(scope="module")
def jax_rows():
    return _run(_script("jax", 4), DECK).last_rows


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_sharded_rebomos_deck_matches_jax_script(jax_rows, placement):
    from lammps_plugins_tpu_torch.parallel import (PerDeviceEngine,
                                                   ShardedEngine)
    s = _run(_script("port", 4, placement=placement), DECK)
    assert isinstance(s.engine, ShardedEngine) and s.engine.n_devices == 4
    assert isinstance(s.engine, PerDeviceEngine) == (placement
                                                     == "per_device")
    rows = s.last_rows
    assert [r["step"] for r in rows] == [r["step"] for r in jax_rows] \
        == [0, 20]
    ok, diff = _close([[r[k] for k in KEYS] for r in rows],
                      [[r[k] for k in KEYS] for r in jax_rows], 1e-9,
                      groups=[range(5, 11)])
    assert ok, dict(zip(KEYS, diff))


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_sharded_lj_deck_matches_single_device(tmp_path, placement):
    """f_ columns read through fix_view_state, and write_restart of the
    gathered state, as on one device."""
    from lammps_plugins_tpu_torch.run.checkpoint import load_state
    text = LJ_DECK + f"run 20\nwrite_restart {tmp_path}/r.npz\n"
    printed = {1: [], 4: []}
    for n in (1, 4):
        _run(_script("port", n, printed[n].append,
                     placement if n > 1 else None),
             text.replace("r.npz", f"r{n}.npz"))
    t1, t4 = ([[float(v) for v in ln.split()] for ln in printed[n]
               if ln.startswith("   ") and ln.split()[0].isdigit()]
              for n in (1, 4))
    assert len(t1) == len(t4) == 3
    np.testing.assert_allclose(t4, t1, rtol=1e-7, atol=1e-7)
    a, b = (load_state(f"{tmp_path}/r{n}.npz", dtype=torch.float64,
                       device="cpu") for n in (1, 4))
    np.testing.assert_allclose(b.v.numpy(), a.v.numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_sharded_deck_refuses_single_device_commands(placement):
    from lammps_plugins_tpu_torch.api.script import ScriptError
    s = _run(_script("port", 4, placement=placement), LJ_DECK)
    with pytest.raises(ScriptError, match="minimize is single-device"):
        s.run_text("minimize 0.0 1e-4 10 10\n")
    s = _run(_script("port", 4, placement=placement),
             LJ_DECK + "compute pe all pe/atom\n"
             "dump 1 all custom 5 " + os.devnull + " id c_pe\n")
    with pytest.raises(ScriptError, match="single-device"):
        s.run_text("run 5\n")
