"""The MoS2 monolayer slab of the port (api/scenes.py::rebomos_monolayer)
against the JAX package's, float64 on the CPU, with the synthetic REBOMOS
parameters (tests/data/MoS.REBO.synthetic).

  * the scene at nx, ny of 4-6: positions, types, masses and box exactly
    equal to the JAX scene's, with and without the spatial sort (JAX's
    LPT_SORT_SCENE=1 is the port's sort=True);
  * energy, forces and the strain virial at nx = 5, ny = 6 (jiggled)
    against JAX on the JAX rebuild's lists (1e-9 relative), and the
    port's own rebuild and forces against JAX's forces (1e-9);
  * tests/test_monolayer.py's three oracles through the port: doubling the
    vacuum leaves the energy unchanged (the layer never sees its z-images);
    the per-atom energy sits just above the bulk's (the layers of the bulk
    are bound by the LJ term only: with the synthetic parameters the
    monolayer is 0.016 eV/atom above the 2H bulk, a bound of 0.05); NVE
    on the thermalised slab conserves energy through rebuilds (skin 0.3
    here, so that 60 steps at 300 K rebuild; the JAX test's 1.0 rebuilds
    once, at the start).
"""

import numpy as np
import pytest
import torch

from lammps_plugins_tpu_torch import convert
from torch_parity import SYNTH_REBO, rel_err

CPU = dict(dtype=torch.float64, device="cpu")
TOL = 1e-9


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("nx,ny", [(4, 4), (5, 6), (6, 6)])
def test_scene_matches_jax_exactly(monkeypatch, nx, ny, sort):
    import jax.numpy as jnp
    from lammps_plugins_tpu.api.scenes import rebomos_monolayer as jscene
    from lammps_plugins_tpu_torch.api.scenes import rebomos_monolayer
    if sort:
        monkeypatch.setenv("LPT_SORT_SCENE", "1")
    else:
        monkeypatch.delenv("LPT_SORT_SCENE", raising=False)
    js = jscene(nx=nx, ny=ny, dtype=jnp.float64)
    ps = rebomos_monolayer(nx, ny, sort=sort, **CPU)
    assert ps.natoms == 3 * nx * ny
    for f in ("x", "type", "mass"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    np.testing.assert_array_equal(ps.box.h_np(), js.box.h_np())


def test_odd_ny_raises():
    from lammps_plugins_tpu_torch.api.scenes import rebomos_monolayer
    with pytest.raises(ValueError, match="even"):
        rebomos_monolayer(4, 5, **CPU)


@pytest.fixture(scope="module")
def both():
    """JAX and port Engines (NVT 300 K, skin 0.8) on the jiggled nx=5,
    ny=6 slab, each after its own device rebuild."""
    import jax.numpy as jnp
    from lammps_plugins_tpu.api.scenes import rebomos_monolayer as jscene
    from lammps_plugins_tpu.core import units as jun
    from lammps_plugins_tpu.fixes.nvt import FixNVT as JNVT
    from lammps_plugins_tpu.potentials.rebomos import REBOMoS as JREBO
    from lammps_plugins_tpu.run.simulation import Engine as JEngine
    from lammps_plugins_tpu_torch.api.scenes import rebomos_monolayer
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    js = jscene(nx=5, ny=6, dtype=jnp.float64)
    x = np.asarray(js.x) + np.random.default_rng(7).uniform(
        -0.1, 0.1, js.x.shape)
    je = JEngine(js.replace(x=jnp.asarray(x)),
                 JREBO.from_file(SYNTH_REBO, ["M", "S"]),
                 [JNVT(300.0, 300.0, 0.1)], jun.METAL, skin=0.8,
                 device_rebuild=True)
    je.rebuild_neighbors()
    ps = rebomos_monolayer(5, 6, **CPU)
    pe = Engine(ps.replace(x=torch.as_tensor(x)),
                REBOMoS.from_file(SYNTH_REBO, ["M", "S"], **CPU),
                [FixNVT(300.0, 300.0, 0.1)], units.METAL, skin=0.8)
    pe.rebuild_neighbors()
    return je, pe


def test_energy_forces_virial_match_jax_on_the_same_lists(both):
    je, pe = both
    js = je.state
    jE, jF, jW = je.pair.energy_force_virial(js.x, js.type, je.nbr, js.box.h)
    pair = convert.rebomos_from_tables(je.pair.tables, je.pair.typemap_np)
    st = convert.state_from_numpy(js)
    nbr = convert.neighbor_data_from_numpy(je.nbr)
    E, F, W = pair.energy_force_virial(st.x, st.type, nbr, st.box.h)
    assert abs(float(E) - float(jE)) <= TOL * abs(float(jE))
    assert rel_err(F.numpy(), jF) <= TOL
    assert rel_err(W.numpy(), jW) <= TOL
    f = pair.forces(st.x, st.type, nbr, st.box.h)
    assert rel_err(f.numpy(), jF) <= TOL


def test_port_rebuild_and_forces_match_jax(both):
    je, pe = both
    js = je.state
    _, jF, _ = je.pair.energy_force_virial(js.x, js.type, je.nbr, js.box.h)
    st = pe.state
    F = pe.pair.forces(st.x, st.type, pe.nbr, st.box.h)
    assert rel_err(F.numpy(), jF) <= TOL
    assert float(np.abs(np.asarray(jF)).max()) > 1e-2


def _evaluate(st):
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], **CPU)
    pe, _ = Engine(st, pair, [FixNVE()], units.METAL).evaluate()
    return float(pe)


def test_monolayer_isolated_from_z_images():
    from lammps_plugins_tpu_torch.api.scenes import rebomos_monolayer
    es = [_evaluate(rebomos_monolayer(4, 4, vacuum=v, **CPU))
          for v in (16.0, 40.0)]
    assert es[0] != 0.0
    assert abs(es[0] - es[1]) <= 1e-12 * abs(es[1])


def test_monolayer_energy_scale():
    from lammps_plugins_tpu_torch.api.scenes import (
        rebomos_bulk_commensurate, rebomos_monolayer)
    mono = rebomos_monolayer(6, 6, **CPU)
    assert mono.natoms == 6 * 6 * 3
    bulk = rebomos_bulk_commensurate(3, 4, 1, **CPU)
    pa_mono = _evaluate(mono) / mono.natoms
    pa_bulk = _evaluate(bulk) / bulk.natoms
    assert pa_bulk < pa_mono < pa_bulk + 0.05


def test_monolayer_nve_conservation_through_rebuilds():
    from lammps_plugins_tpu_torch.api.scenes import rebomos_monolayer
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    st = velocity_create(rebomos_monolayer(5, 6, **CPU), units.METAL, 300.0,
                         seed=99)
    eng = Engine(st, REBOMoS.from_file(SYNTH_REBO, ["M", "S"], **CPU),
                 [FixNVE()], units.METAL, skin=0.3, check_every=5)
    rows = eng.run(60, thermo_every=30)
    e = [r["etotal"] for r in rows]
    assert rows[-1]["step"] == 60 and eng.rebuilds > 1
    assert abs(e[-1] - e[0]) / st.natoms < 2e-5      # eV/atom over 60 fs
    assert all(np.isfinite(r["press"]) for r in rows)
