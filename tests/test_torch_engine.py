"""The port's pair style and Engine against the JAX package (float64).

Same lists: energy, forces (autograd and the analytic kernel-path twins)
and virial to 1e-9 relative.  Whole runs: 20-step thermo rows of the
288-atom scene to 1e-9, and an 80-step 300 K run of a 576-atom scene
through neighbor rebuilds to 1e-8.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu.core import units
from torch_parity import SYNTH_REBO, jax_engine, port_of, rel_err

THERMO_KEYS = ("temp", "press", "pe", "ke", "etotal")
PRESS_KEYS = ("pxx", "pyy", "pzz", "pxy", "pxz", "pyz")


@pytest.fixture(scope="module")
def same_lists():
    jeng = jax_engine("bulk", "f64", jiggle=0.05)
    return (jeng,) + port_of(jeng)


def test_energy_forces_virial_same_lists(same_lists):
    jeng, pair, st, nbr = same_lists
    js = jeng.state
    e_j, f_j, w_j = jeng.pair.energy_force_virial(js.x, js.type, jeng.nbr,
                                                  js.box.h)
    e_p, f_p, w_p = pair.energy_force_virial(st.x, st.type, nbr, st.box.h)
    assert abs(float(e_p) - float(e_j)) < 1e-9 * abs(float(e_j))
    assert rel_err(f_p.numpy(), f_j) < 1e-9
    assert rel_err(w_p.numpy(), w_j) < 1e-9


def test_analytic_forces_same_lists(same_lists):
    """The per-step force path (REBO cotangent + mirror twins, LJ cell
    twin) against the JAX force path and the port's own autograd."""
    jeng, pair, st, nbr = same_lists
    js = jeng.state
    f_j = np.asarray(jeng.pair.forces(js.x, js.type, jeng.nbr, js.box.h))
    f_p = pair.forces(st.x, st.type, nbr, st.box.h)
    assert rel_err(f_p.numpy(), f_j) < 1e-9
    from lammps_plugins_tpu_torch.potentials.base import PairStyle
    _, f_ad, _ = PairStyle.energy_force_virial(pair, st.x, st.type, nbr,
                                               st.box.h)
    assert rel_err(f_p.numpy(), f_ad.numpy()) < 1e-11


def _engines(scene, **kw):
    from lammps_plugins_tpu.api import scenes as jscenes
    from lammps_plugins_tpu.fixes.nve import FixNVE as JNVE
    from lammps_plugins_tpu.fixes.velocity import velocity_create as jvc
    from lammps_plugins_tpu.potentials.rebomos import REBOMoS as JREBO
    from lammps_plugins_tpu.run.simulation import Engine as JEngine
    from lammps_plugins_tpu_torch.api import scenes
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    if scene == "bulk":
        js = jscenes.rebomos_bulk()
        ps = scenes.rebomos_bulk(dtype=torch.float64, device="cpu")
    else:
        js = jscenes.rebomos_bulk_commensurate(6, 8, 2, dtype=jnp.float64)
        ps = scenes.rebomos_bulk_commensurate(6, 8, 2, dtype=torch.float64,
                                              device="cpu")
        js = jvc(js, units.METAL, 300.0, seed=12345)
        ps = velocity_create(ps, units.METAL, 300.0, seed=12345)
        np.testing.assert_array_equal(ps.v.numpy(), np.asarray(js.v))
    je = JEngine(js, JREBO.from_file(SYNTH_REBO, ["M", "S"]), [JNVE()],
                 units.METAL, device_rebuild=True, **kw)
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float64,
                             device="cpu")
    pe = Engine(ps, pair, [FixNVE()], units.METAL, **kw)
    return je, pe


def _assert_rows_match(jrows, prows, tol):
    assert len(jrows) == len(prows)
    for a, b in zip(jrows, prows):
        assert a["step"] == b["step"]
        for k in THERMO_KEYS:
            assert abs(a[k] - b[k]) <= tol * max(abs(a[k]), 1e-300), k
        # tensor components against the tensor's scale (some are ~0)
        scale = max(abs(a[k]) for k in PRESS_KEYS)
        for k in PRESS_KEYS:
            assert abs(a[k] - b[k]) <= tol * scale, k


def test_thermo_rows_20_steps():
    je, pe = _engines("bulk", check_every=5)
    _assert_rows_match(je.run(20, thermo_every=10),
                       pe.run(20, thermo_every=10), 1e-9)


def test_300K_run_through_rebuilds():
    # skin 0.4: at 300 K the half-skin rule rebuilds three times in 80 steps
    je, pe = _engines("commensurate", skin=0.4, check_every=10)
    jrows = je.run(80, thermo_every=20)
    prows = pe.run(80, thermo_every=20)
    assert pe.rebuilds >= 2          # the first build and at least one more
    _assert_rows_match(jrows, prows, 1e-8)


def test_host_build_path_matches():
    """Engine with the host (numpy) neighbor build on both sides."""
    je, pe = _engines("bulk")
    je.device_rebuild = pe.device_rebuild = False
    e_j, w_j = je.evaluate()
    e_p, w_p = pe.evaluate()
    assert abs(float(e_p) - float(e_j)) < 1e-9 * abs(float(e_j))
    assert rel_err(pe.state.f.numpy(), je.state.f) < 1e-9
    assert rel_err(w_p.numpy(), w_j) < 1e-9


def test_quantize_k_matches():
    from lammps_plugins_tpu.run.simulation import _quantize_k as jq
    from lammps_plugins_tpu_torch.run.simulation import _quantize_k
    assert [_quantize_k(t) for t in range(1, 200)] == \
        [jq(t) for t in range(1, 200)]
