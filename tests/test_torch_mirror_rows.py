"""Mirror combine from gathered rows (ops/mirror_rows.py) and the REBO
kernel's emit_rows output of the port, against the JAX package.

The JAX REBO kernel (interpret mode) emits its interleaved [K, Np, 4]
table; gathered at mirT, the same rows go through the JAX
mirror_combine_rows (interpret) and the port's twin: 1e-5 x scale (f32
sums in another order).  This test forces its own path: the JAX
dispatch's LPT_MIR_ROWS test compares the row-fetch path with itself.
The port's emit_rows twin against the JAX rows at the REBO bar
(5e-4 x scale), component 3 zero.  REBOMoS.forces with combine="rows"
against the default configuration (float64, 1e-10; float32, 1e-5), and
20 NVE steps against the default trajectory (1e-9).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu_torch.ops import mirror_rows, rebo
from torch_parity import (assert_same_trajectory, config_forces_rel_err,
                          jax_engine, port_of, run_20_steps)


@pytest.fixture(scope="module")
def setup():
    from lammps_plugins_tpu.ops.rebo_pallas import _rebo_call
    jeng = jax_engine("small", "f32", jiggle=0.12)
    pair, st, nbr = port_of(jeng, torch.float32)
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                               nbr.lists["rebo"], st.box.h)
    eiT = np.zeros((8, planes[5].shape[0]), np.float32)
    eiT[0] = planes[5].numpy()
    consts_key = tuple(sorted(jeng.pair._rebo_consts.items()))
    g = _rebo_call(*(jnp.asarray(p.numpy()) for p in planes[:5]),
                   jnp.asarray(eiT), consts_key=consts_key, interpret=True,
                   emit_rows=True)
    return pair, nbr.lists["rebo"], planes, [np.array(a) for a in g]


def test_twin_matches_pallas_rows_combine(setup):
    from lammps_plugins_tpu.ops.mirror_pallas import mirror_combine_rows
    _, rl, _, (gx, gy, gz, g4) = setup
    K, Np = gx.shape
    mirT = rl.mirT.numpy().reshape(-1)
    gmir4 = g4.reshape(K * Np, 4)[mirT].reshape(K, Np, 4)
    mirv = rl.mirvT.numpy().astype(np.float32)
    F8 = np.asarray(mirror_combine_rows(
        *(jnp.asarray(a) for a in (gx, gy, gz, gmir4, mirv)),
        interpret=True))
    f_port = mirror_rows.mirror_combine_rows(
        *(torch.from_numpy(a) for a in (gx, gy, gz, gmir4, mirv))).numpy()
    f_jax = F8[0:3].T
    scale = np.abs(f_jax).max()
    assert scale > 1e-3
    assert f_port.shape == (Np, 3)
    np.testing.assert_allclose(f_port, f_jax, atol=1e-5 * scale, rtol=0)


def test_emit_rows_twin_matches_pallas_rows(setup):
    pair, _, planes, (gx, _, _, g4) = setup
    out = rebo.rebo_cotangents(*planes, pair._rebo_consts, emit_rows=True)
    assert len(out) == 4
    rows = out[3].numpy()
    assert rows.shape == g4.shape
    assert not rows[..., 3].any()
    for a in range(3):
        np.testing.assert_array_equal(rows[..., a], out[a].numpy())
    scale = np.abs(g4[..., 0:3]).max()
    np.testing.assert_allclose(rows[..., 0:3], g4[..., 0:3],
                               atol=5e-4 * scale, rtol=0)


@pytest.mark.parametrize("scene", ["small", "bulk"])
def test_forces_match_default_configuration(scene):
    assert config_forces_rel_err(dict(combine="rows"), scene) <= 1e-10


def test_forces_match_default_configuration_f32():
    """float32 gathers the rows as complex128 elements."""
    assert config_forces_rel_err(dict(combine="rows"), "bulk",
                                 torch.float32) <= 1e-5


def test_20_steps_match_default_trajectory():
    assert_same_trajectory(run_20_steps(combine="rows"), run_20_steps())
