"""The port's own copies of the JAX package's framework-free modules
against the originals, on the same inputs: the REBOMOS and AEAM parameter
readers, the AEAM spline coefficients and piecewise-Chebyshev refits, the
unit systems, the timers' report and transfer, and the native pair
search."""

import dataclasses

import numpy as np
import pytest

from lammps_plugins_tpu.core import units as jax_units
from lammps_plugins_tpu.ops import native as jax_native
from lammps_plugins_tpu.potentials import polyfit as jax_polyfit
from lammps_plugins_tpu.potentials import spline as jax_spline
from lammps_plugins_tpu.potentials import tables as jax_tables
from lammps_plugins_tpu.run.timers import Timers as JTimers
from lammps_plugins_tpu_torch.core import units
from lammps_plugins_tpu_torch.ops import native
from lammps_plugins_tpu_torch.potentials import polyfit, spline, tables
from lammps_plugins_tpu_torch.run.timers import Timers
from torch_parity import SYNTH_AEAM, SYNTH_AEAM_ASYM, SYNTH_REBO

SYSTEMS = ("metal", "real", "lj", "si", "cgs", "electron", "micro", "nano")


def test_read_rebomos_matches_jax():
    a, b = tables.read_rebomos(SYNTH_REBO), jax_tables.read_rebomos(SYNTH_REBO)
    for f in dataclasses.fields(jax_tables.REBOMoSTables):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    assert a.cut3rebo == b.cut3rebo


@pytest.mark.parametrize("path", [SYNTH_AEAM, SYNTH_AEAM_ASYM])
def test_read_aeam_matches_jax(path):
    a, b = tables.read_aeam(path), jax_tables.read_aeam(path)
    assert (a.nelements, a.nnonangular, a.nangular, a.elements) == \
        (b.nelements, b.nnonangular, b.nangular, b.elements) == \
        (2, 1, 1, ["Al", "Si"])
    for f in ("mass", "nrho", "drho", "nr", "dr", "cut"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.cut, [[6.5, 4.18], [4.18, 5.28]])
    for i in range(2):
        np.testing.assert_array_equal(a.frho[i], b.frho[i])
        for j in range(2):
            np.testing.assert_array_equal(a.rhor[i][j], b.rhor[i][j])
    assert a.z2r.keys() == b.z2r.keys()
    for k in a.z2r:
        np.testing.assert_array_equal(a.z2r[k], b.z2r[k])


def test_read_aeam_rejects_a_truncated_file(tmp_path):
    p = tmp_path / "short.aeam"
    with open(SYNTH_AEAM) as fh:
        p.write_text("".join(fh.readlines()[:40]))
    with pytest.raises(ValueError):
        tables.read_aeam(str(p))


def test_synthetic_sisi_density_ends_at_cut_minus_cutdec():
    t = tables.read_aeam(SYNTH_AEAM)
    r = (np.arange(int(t.nr[1, 1]) + 1) - 1) * t.dr[1, 1]
    shell = r >= t.cut[1, 1] - 1.5
    assert (t.rhor[1][1][shell] == 0.0).all()
    assert (t.rhor[1][1][1:][~shell[1:]] != 0.0).any()


@pytest.mark.parametrize("table", ["frho0", "rhor01", "z2r11"])
def test_make_spline_matches_jax(table):
    t = tables.read_aeam(SYNTH_AEAM)
    f, n, d = {"frho0": (t.frho[0], t.nrho[0], t.drho[0]),
               "rhor01": (t.rhor[0][1], t.nr[0, 1], t.dr[0, 1]),
               "z2r11": (t.z2r[(1, 1)], t.nr[1, 1], t.dr[1, 1])}[table]
    np.testing.assert_array_equal(spline.make_spline(f, int(n), float(d)),
                                  jax_spline.make_spline(f, int(n),
                                                         float(d)))


def test_fit_aeam_polys_matches_jax():
    from lammps_plugins_tpu_torch.potentials.aeam import _pair_tables
    t = tables.read_aeam(SYNTH_AEAM)
    rhor, _, _, z2r, z2r_map = _pair_tables(2, t)[:5]
    a = polyfit.fit_aeam_polys(t, rhor, z2r, z2r_map)
    b = jax_polyfit.fit_aeam_polys(t, rhor, z2r, z2r_map)
    np.testing.assert_array_equal(a.f_coef, b.f_coef)
    np.testing.assert_array_equal(a.phi_coef, b.phi_coef)
    assert a.err == b.err
    assert (polyfit.U0, polyfit.NSEG, polyfit.DEG) == \
        (jax_polyfit.U0, jax_polyfit.NSEG, jax_polyfit.DEG)


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
