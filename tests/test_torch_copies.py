"""The port's own copies of the JAX package's framework-free modules
against the originals, on the same inputs: the REBOMOS parameter reader,
the unit systems, the timers' report and transfer, and the native pair
search."""

import dataclasses

import numpy as np
import pytest

from lammps_plugins_tpu.core import units as jax_units
from lammps_plugins_tpu.ops import native as jax_native
from lammps_plugins_tpu.potentials import tables as jax_tables
from lammps_plugins_tpu.run.timers import Timers as JTimers
from lammps_plugins_tpu_torch.core import units
from lammps_plugins_tpu_torch.ops import native
from lammps_plugins_tpu_torch.potentials import tables
from lammps_plugins_tpu_torch.run.timers import Timers
from torch_parity import SYNTH_REBO

SYSTEMS = ("metal", "real", "lj", "si", "cgs", "electron", "micro", "nano")


def test_read_rebomos_matches_jax():
    a, b = tables.read_rebomos(SYNTH_REBO), jax_tables.read_rebomos(SYNTH_REBO)
    for f in dataclasses.fields(jax_tables.REBOMoSTables):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    assert a.cut3rebo == b.cut3rebo


def test_read_rebomos_rejects_a_short_file(tmp_path):
    p = tmp_path / "short.rebo"
    p.write_text("1.0\n2.0  # two values\n")
    with pytest.raises(ValueError):
        tables.read_rebomos(str(p))


@pytest.mark.parametrize("name", SYSTEMS)
def test_unit_system_matches_jax(name):
    assert dataclasses.asdict(units.get(name)) == \
        dataclasses.asdict(jax_units.get(name))


def test_unknown_unit_style_raises():
    with pytest.raises(ValueError):
        units.get("furlong")


def test_timers_report_matches_jax():
    reports = []
    for cls in (Timers, JTimers):
        t = cls()
        t.start_run(288)
        t.acc.update(Pair=0.5, Neigh=0.25, Output=0.125)
        t.end_run(100)
        t.wall = 1.0
        reports.append(t.performance_summary(0.001))
    assert reports[0] == reports[1]


@pytest.mark.parametrize("seconds", [0.1, 0.7, -0.2])
def test_timers_transfer_matches_jax(seconds):
    """Re-attribution from Pair to Neigh, clamped to [0, Pair's time]."""
    accs = []
    for cls in (Timers, JTimers):
        t = cls()
        t.acc.update(Pair=0.5, Neigh=0.25)
        t.transfer("Pair", "Neigh", seconds)
        accs.append(dict(t.acc))
    assert accs[0] == accs[1]


@pytest.mark.parametrize("seed,rcut", [(0, 3.0), (1, 5.5)])
def test_native_pair_search_matches_jax(seed, rcut):
    rng = np.random.default_rng(seed)
    x_own = rng.uniform(0.0, 12.0, (300, 3))
    x_all = np.concatenate([x_own, rng.uniform(-3.0, 15.0, (200, 3))])
    got = native.find_pairs(x_own, x_all, rcut, nthreads=2)
    ref = jax_native.find_pairs(x_own, x_all, rcut, nthreads=2)
    assert len(got[0]) > 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
