"""Switched-LJ cell sweep of the port (ops/lj_cells.py) against JAX.

f32: the twin against the JAX Pallas kernel lj_cell_forces (interpret
mode) on the same packed planes — forces 2e-4 x scale, energy 2e-5
relative.  f64: the twin's atom forces against the autograd of the port's
_lj_energy_cells and against the JAX closed-form sweep, to rounding, and
unchanged (1e-12 relative) when the slots of every cell are permuted.
The kernel's culling rule (near_groups) keeps every pair inside the LJ
window, whatever the slot order, and culls when cells are large.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu_torch.ops import lj_cells as ops_lj
from torch_parity import (jax_engine, permute_cell_slots, port_of, rel_err,
                          synthetic_lj_planes)


@pytest.fixture(scope="module")
def f32_setup():
    jeng = jax_engine("small", "f32", jiggle=0.12)
    pair, st, nbr = port_of(jeng, torch.float32)
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    return jeng, pair, st, nbr, P


def test_twin_matches_pallas_kernel_f32(f32_setup):
    from lammps_plugins_tpu.ops.lj_cells_pallas import lj_cell_forces
    jeng, pair, _, nbr, P = f32_setup
    c = nbr.cells
    out_j = np.asarray(lj_cell_forces(
        jnp.asarray(P.numpy()), jeng.pair._lj_consts, c.a_range, c.cell_mn,
        c.cell_size, with_energy=True, interpret=True))
    out_p = ops_lj.lj_cell_forces(P, pair._lj_consts, c.a_range,
                                  with_energy=True).numpy()
    scale = np.abs(out_j[..., :3, :]).max()
    assert scale > 1e-4
    np.testing.assert_allclose(out_p[..., :3, :], out_j[..., :3, :],
                               atol=2e-4 * scale, rtol=2e-4)
    e_j = out_j[..., 3, :].astype(np.float64).sum()
    e_p = out_p[..., 3, :].astype(np.float64).sum()
    assert abs(e_p - e_j) < 2e-5 * abs(e_j)


def test_energy_row_matches_cell_energy_f32(f32_setup):
    """The with_energy row sums to the autograd path's LJ energy."""
    _, pair, st, nbr, P = f32_setup
    e_row = float(ops_lj.lj_cell_forces(P, pair._lj_consts,
                                        nbr.cells.a_range,
                                        with_energy=True)[..., 3, :].sum())
    e_ref = float(pair._lj_energy_cells(st.x, None, nbr.ghosts, nbr.cells,
                                        st.box.h))
    assert abs(e_row - e_ref) < 2e-5 * abs(e_ref)


@pytest.fixture(scope="module")
def f64_setup():
    jeng = jax_engine("bulk", "f64", jiggle=0.05)
    return (jeng,) + port_of(jeng)


def test_forces_match_autograd_of_cell_energy_f64(f64_setup):
    _, pair, st, nbr = f64_setup
    f_twin = pair._lj_forces_cells(st.x, nbr.ghosts, nbr.cells, st.box.h)
    x = st.x.clone().requires_grad_(True)
    e = pair._lj_energy_cells(x, None, nbr.ghosts, nbr.cells, st.box.h)
    (g,) = torch.autograd.grad(e, (x,))
    assert float(f_twin.abs().max()) > 1e-4
    assert rel_err(f_twin.numpy(), -g.numpy()) < 1e-10


def test_matches_jax_cell_forces_and_energy_f64(f64_setup):
    jeng, pair, st, nbr = f64_setup
    jp, js, jn = jeng.pair, jeng.state, jeng.nbr
    f_jax = np.asarray(jp._lj_forces_cells(js.x, jn.ghosts, jn.cells,
                                           js.box.h))
    f_port = pair._lj_forces_cells(st.x, nbr.ghosts, nbr.cells, st.box.h)
    assert rel_err(f_port.numpy(), f_jax) < 1e-10
    e_jax = float(jp._lj_energy_cells(js.x, None, jn.ghosts, jn.cells,
                                      js.box.h))
    e_port = float(pair._lj_energy_cells(st.x, None, nbr.ghosts, nbr.cells,
                                         st.box.h))
    assert abs(e_port - e_jax) < 1e-11 * abs(e_jax)


def test_aslot_maps_every_owned_atom_once(f64_setup):
    _, _, st, nbr = f64_setup
    c = nbr.cells
    Dx, Dy, Dz = c.dims
    C = c.table.shape[1]
    (x0, x1), (y0, y1), (z0, z1) = c.a_range
    grid = c.table[:Dx * Dy * Dz].reshape(Dx, Dy, Dz, C)[x0:x1, y0:y1,
                                                          z0:z1]
    flat = grid.reshape(-1)
    np.testing.assert_array_equal(flat[c.aslot].numpy(),
                                  np.arange(st.natoms))


def test_twin_forces_do_not_depend_on_slot_order_f64(f64_setup):
    _, pair, st, nbr = f64_setup
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    ar = nbr.cells.a_range
    Pp, perm = permute_cell_slots(P, seed=3)
    out = ops_lj.lj_cell_forces(P, pair._lj_consts, ar, with_energy=True)
    outp = ops_lj.lj_cell_forces(Pp, pair._lj_consts, ar, with_energy=True)
    (x0, x1), (y0, y1), (z0, z1) = ar
    pa = perm[x0:x1, y0:y1, z0:z1]
    back = torch.gather(out, -1, pa[..., None, :].expand(out.shape))
    assert float(out[..., :3, :].abs().max()) > 1e-4
    assert rel_err(outp[..., :4, :].numpy(), back[..., :4, :].numpy()) \
        <= 1e-12


@pytest.mark.parametrize("order,cell", [("sorted", 11.0), ("random", 11.0),
                                        ("sorted", 24.0)])
def test_culling_rule_keeps_every_window_pair(order, cell):
    """Every (A slot, B slot) pair inside its LJ window lies in an (A tile,
    B group) that the rule tests; with cells over twice the cutoff the
    rule culls most of them."""
    P, consts, ar = synthetic_lj_planes(C=104, cell=cell, order=order,
                                        seed=11)
    (x0, x1), (y0, y1), (z0, z1) = ar
    lo, hi = ops_lj.group_boxes(P)
    Q = ops_lj.tile_planes(P)
    QA = Q[x0:x1, y0:y1, z0:z1]
    tile, group = ops_lj.TILE, ops_lj.GROUP
    hits = 0
    for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
        sl = (slice(x0 + ox, x1 + ox), slice(y0 + oy, y1 + oy),
              slice(z0 + oz, z1 + oz))
        _, fp, _ = ops_lj.pair_terms(QA, Q[sl], consts)
        near = ops_lj.near_groups(QA, lo[sl], hi[sl], consts)
        near = near.repeat_interleave(tile, -2).repeat_interleave(group, -1)
        inside = fp != 0
        hits += int(inside.sum())
        assert not (inside & ~near).any()
    assert hits > 1000
    tested, live = ops_lj.candidate_pairs(P, consts, ar)
    assert 0 < tested <= live
    if cell > 20.0:
        assert tested < 0.5 * live
