"""Newton-half LJ cell sweep of the port (ops/lj_half.py) against JAX.

f32: the twin against the JAX Pallas kernel lj_cell_forces_half
(interpret mode) on the same packed planes, 2e-4 x scale, and against the
full 27-offset twin (ops/lj_cells.py), 3e-4 x scale.  f64: against the full
twin to 1e-10 relative.  REBOMoS.forces with lj="half" against the default
configuration (float64, 1e-10), and 20 NVE steps against the default
trajectory (1e-9).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu_torch.ops import lj_cells, lj_half
from torch_parity import (assert_same_trajectory, config_forces_rel_err,
                          jax_engine, permute_cell_slots, port_of, rel_err,
                          run_20_steps)


def _full_slots(P, pair, a_range):
    """The full twin's forces in the half kernel's [Ax, Ay, Az, C, 3]."""
    out = lj_cells.lj_cell_forces_ref(P, pair._lj_consts, a_range)
    return out[..., 0:3, :].permute(0, 1, 2, 4, 3)


@pytest.fixture(scope="module")
def f32_setup():
    # the 288-atom scene: interpret mode of the 72-atom one is slower
    jeng = jax_engine("bulk", "f32", jiggle=0.12)
    pair, st, nbr = port_of(jeng, torch.float32)
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    return jeng, pair, nbr.cells.a_range, P


def test_twin_matches_pallas_half_kernel_f32(f32_setup):
    from lammps_plugins_tpu.ops.lj_cells_pallas import lj_cell_forces_half
    jeng, pair, a_range, P = f32_setup
    out_j = np.asarray(lj_cell_forces_half(
        jnp.asarray(P.numpy()), jeng.pair._lj_consts, a_range,
        interpret=True))
    out_p = lj_half.lj_cell_forces_half(P, pair._lj_consts, a_range).numpy()
    scale = np.abs(out_j).max()
    assert scale > 1e-4
    assert out_p.shape == out_j.shape
    np.testing.assert_allclose(out_p, out_j, atol=2e-4 * scale, rtol=0)


def test_twin_matches_full_twin_f32(f32_setup):
    _, pair, a_range, P = f32_setup
    full = _full_slots(P, pair, a_range).numpy()
    half = lj_half.lj_cell_forces_half(P, pair._lj_consts, a_range).numpy()
    np.testing.assert_allclose(half, full, atol=3e-4 * np.abs(full).max(),
                               rtol=0)


@pytest.mark.parametrize("scene", ["small", "bulk"])
def test_twin_matches_full_twin_f64(scene):
    jeng = jax_engine(scene, "f64", jiggle=0.05)
    pair, st, nbr = port_of(jeng)
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    a_range = nbr.cells.a_range
    full = _full_slots(P, pair, a_range).numpy()
    assert np.abs(full).max() > 1e-4
    half = lj_half.lj_cell_forces_half(P, pair._lj_consts, a_range).numpy()
    assert rel_err(half, full) <= 1e-10


def test_twin_forces_do_not_depend_on_slot_order_f64():
    jeng = jax_engine("bulk", "f64", jiggle=0.05)
    pair, st, nbr = port_of(jeng)
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    ar = nbr.cells.a_range
    Pp, perm = permute_cell_slots(P, seed=4)
    out = lj_half.lj_cell_forces_half(P, pair._lj_consts, ar)
    outp = lj_half.lj_cell_forces_half(Pp, pair._lj_consts, ar)
    (x0, x1), (y0, y1), (z0, z1) = ar
    pa = perm[x0:x1, y0:y1, z0:z1]
    back = torch.gather(out, -2, pa[..., None].expand(out.shape))
    assert float(out.abs().max()) > 1e-4
    assert rel_err(outp.numpy(), back.numpy()) <= 1e-12


def test_half_offsets_cover_the_neighbourhood_once():
    offs = lj_half.HALF_OFFSETS
    assert len(offs) == 14 and offs[0] == (0, 0, 0)
    both = set(offs) | {tuple(-c for c in o) for o in offs}
    assert len(both) == 27


@pytest.mark.parametrize("scene", ["small", "bulk"])
def test_forces_match_default_configuration(scene):
    assert config_forces_rel_err(dict(lj="half"), scene) <= 1e-10


def test_20_steps_match_default_trajectory():
    assert_same_trajectory(run_20_steps(lj="half"), run_20_steps())
