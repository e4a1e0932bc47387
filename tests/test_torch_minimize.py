"""FIRE minimization of the port (run/minimize.py) against the JAX
package's, float64 on the CPU: the same stop criterion, the same
iteration count (FIRE's chunks of max(4, check_every) iterations) and
e_final within 1e-9 relative, on

  * the LJ deck (fcc 0.8442, 4^3 cells, lj/cut 2.5) with every atom moved
    by 0.05 sigma (normal, numpy seed 7), to the force tolerance and to
    the energy tolerance;
  * the jiggled 288-atom in.rebomos-bulk scene (synthetic parameters),
    capped by maxiter;

plus the post-minimize state (v = 0, the final forces in place, the
Engine ready to run) and MinResult's text.
"""

import numpy as np
import pytest
import torch

from torch_parity import jax_engine

LJ = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 4 0 4 0 4
create_box      1 box
create_atoms    1 box
mass            1 1.0
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
run             0
"""


def _perturbed(x, scale=0.05, seed=7):
    return x + scale * np.random.default_rng(seed).standard_normal(x.shape)


def _jax_lj():
    import jax.numpy as jnp
    from lammps_plugins_tpu.api.script import Script
    s = Script(log=lambda _: None)
    s.run_text(LJ)
    eng = s.engine
    eng.state = eng.state.replace(
        x=jnp.asarray(_perturbed(np.asarray(eng.state.x))))
    eng._x_build_np = None
    eng._f_valid = False
    return eng


def _port_lj():
    from lammps_plugins_tpu_torch.api.script import Script
    s = Script(log=lambda _: None, dtype=torch.float64, device="cpu")
    s.run_text(LJ)
    eng = s.engine
    eng.state = eng.state.replace(
        x=torch.as_tensor(_perturbed(eng.state.x.numpy())))
    eng.nbr = None
    eng._f_valid = False
    return eng


def _results(jeng, peng, **kw):
    from lammps_plugins_tpu.run.minimize import minimize as jmin
    from lammps_plugins_tpu_torch.run.minimize import minimize as pmin
    return jmin(jeng, **kw), pmin(peng, **kw)


def _same(jr, pr):
    assert pr.stop_criterion == jr.stop_criterion
    assert pr.iterations == jr.iterations
    assert abs(pr.e_final - jr.e_final) <= 1e-9 * abs(jr.e_final)
    assert abs(pr.e_initial - jr.e_initial) <= 1e-12 * abs(jr.e_initial)
    assert pr.e_final < pr.e_initial


@pytest.mark.parametrize("stop", ["force", "energy"])
def test_lj_fire_matches_jax(stop):
    kw = (dict(etol=0.0, ftol=1e-6, maxiter=2000) if stop == "force"
          else dict(etol=1e-10, ftol=0.0, maxiter=2000))
    jeng, peng = _jax_lj(), _port_lj()
    jr, pr = _results(jeng, peng, **kw)
    _same(jr, pr)
    assert pr.stop_criterion == f"{stop} tolerance"
    assert pr.iterations > 20
    if stop == "force":
        assert pr.fnorm2_final < 1e-6
        assert abs(pr.fnorm2_final - jr.fnorm2_final) <= 1e-9
    # the Engine is left at the minimum, at rest, its forces current
    st = peng.state
    assert float(st.v.abs().max()) == 0.0 and peng._f_valid
    f = peng.pair.forces(st.x, st.type, peng.nbr, st.box.h)
    assert torch.equal(f, st.f)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jeng.state.x),
                               rtol=0, atol=1e-8)


def test_rebomos_fire_matches_jax():
    from lammps_plugins_tpu_torch import convert
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.run.simulation import Engine
    jeng = jax_engine("bulk", jiggle=0.15, seed=11)
    pair = convert.rebomos_from_tables(jeng.pair.tables,
                                       jeng.pair.typemap_np)
    peng = Engine(convert.state_from_numpy(jeng.state), pair, [FixNVE()],
                  units.METAL)
    jr, pr = _results(jeng, peng, etol=0.0, ftol=1e-3, maxiter=40)
    _same(jr, pr)
    assert pr.stop_criterion == "max iterations" and pr.iterations == 40
    assert abs(pr.fnorm2_final - jr.fnorm2_final) \
        <= 1e-9 * jr.fnorm2_final


def test_min_result_text():
    from lammps_plugins_tpu.run.minimize import MinResult as J
    from lammps_plugins_tpu_torch.run.minimize import MinResult as P
    args = ("force tolerance", 40, -1733.98, -1734.5, 3.2e-7, 1.1e-8)
    assert repr(P(*args)) == repr(J(*args))
