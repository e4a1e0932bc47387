"""The thermo row's (E, W) of REBOMoS without autograd: the port's
energy_virial on the rebuild's tables against the JAX package's
jax.value_and_grad strain virial, float64 on the CPU.

On the rebuild's lists (cells and the [K, Np] mirror tables) the port
takes E from the REBO edge energy's forward pass plus kernel C's energy
row, and W = -Σ d ⊗ G over the live REBO slots (kernel A's cotangents)
plus C's virial rows; here A and C run as their twins.  Held:

  * E and the nine entries of W on the JAX Engine's device-rebuild lists of
    the jiggled 288-atom in.rebomos-bulk scene against JAX's energy_virial
    (1e-9 relative) and against the port's own base-class autograd on the
    same lists (1e-10), for lj="full" and lj="half"; energy_force_virial's
    forces against the per-step force path;
  * the same under a centre mask (every second atom), against JAX's
    value_and_grad of the masked energy and the port's masked autograd;
  * the sharded engine's per-shard rows (four x-slabs, the centre mask of
    each shard) against the port's masked autograd, and their sum against
    the JAX ShardedEngine's thermo (E and W of its value_and_grad);
  * kernel C's virial rows (twin) at aslot against the 27-offset sweep
    that stress/atom ran before them and JAX's _lj_virial_cells, the
    energy row against JAX's _lj_peratom_cells, and their sum against the
    LJ part of the strain virial (autograd of the cell energy);
  * host-built lists still take autograd on the CPU, and agree.
"""

import itertools

import numpy as np
import pytest
import torch

from lammps_plugins_tpu_torch import convert
from torch_parity import SYNTH_REBO, jax_engine, rel_err

TOL_JAX = 1e-9
TOL_SELF = 1e-10


def _port_of(jeng, lj="full"):
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    pair = REBOMoS(jeng.pair.tables, np.asarray(jeng.pair.typemap_np),
                   dtype=torch.float64, device="cpu", lj=lj)
    return (pair, convert.state_from_numpy(jeng.state),
            convert.neighbor_data_from_numpy(jeng.nbr))


def _autograd(pair, st, nbr, center_mask=None):
    """The base class's strain autograd on the same lists."""
    from lammps_plugins_tpu_torch.potentials.base import PairStyle
    e, w = PairStyle.energy_virial(pair, st.x, st.type, nbr, st.box.h,
                                   center_mask=center_mask)
    return float(e), w.numpy()


def _jax_masked(jeng, mask):
    """JAX's value_and_grad of the masked energy in the strain."""
    import jax
    import jax.numpy as jnp
    js = jeng.state
    cm = jnp.asarray(mask)

    def e_of(s):
        return jeng.pair.energy(js.x, s, js.type, jeng.nbr, js.box.h,
                                center_mask=cm)

    e, g = jax.value_and_grad(e_of)(jnp.zeros((3, 3), js.x.dtype))
    return float(e), -np.asarray(g)


@pytest.fixture(scope="module")
def bulk():
    """The JAX Engine after a device rebuild, its energy_virial, and the
    port's pair, state and lists converted from it."""
    jeng = jax_engine("bulk", jiggle=0.1)
    js = jeng.state
    jE, jW = jeng.pair.energy_virial(js.x, js.type, jeng.nbr, js.box.h)
    return jeng, float(jE), np.asarray(jW)


@pytest.mark.parametrize("lj", ["full", "half"])
def test_energy_virial_matches_jax_and_autograd(bulk, lj):
    jeng, jE, jW = bulk
    pair, st, nbr = _port_of(jeng, lj=lj)
    assert nbr.cells is not None and nbr.lists["rebo"].mirT is not None
    e, w = pair.energy_virial(st.x, st.type, nbr, st.box.h)
    assert w.shape == (3, 3) and not w.requires_grad
    assert abs(float(e) - jE) <= TOL_JAX * abs(jE)
    assert rel_err(w.numpy(), jW) <= TOL_JAX
    aE, aW = _autograd(pair, st, nbr)
    assert abs(float(e) - aE) <= TOL_SELF * abs(aE)
    assert rel_err(w.numpy(), aW) <= TOL_SELF


def test_energy_force_virial_on_the_tables(bulk):
    """energy_force_virial shares energy_virial's launches; its forces are
    the per-step force path's, its (E, W) energy_virial's."""
    jeng, jE, jW = bulk
    pair, st, nbr = _port_of(jeng)
    e, f, w = pair.energy_force_virial(st.x, st.type, nbr, st.box.h)
    e2, w2 = pair.energy_virial(st.x, st.type, nbr, st.box.h)
    assert float(e) == float(e2) and torch.equal(w, w2)
    f_step = pair.forces(st.x, st.type, nbr, st.box.h)
    assert rel_err(f.numpy(), f_step.numpy()) <= 1e-13
    js = jeng.state
    _, jF, _ = jeng.pair.energy_force_virial(js.x, js.type, jeng.nbr,
                                             js.box.h)
    assert rel_err(f.numpy(), np.asarray(jF)) <= TOL_JAX


def test_energy_virial_under_a_center_mask(bulk):
    jeng, _, _ = bulk
    pair, st, nbr = _port_of(jeng)
    mask = np.zeros(st.natoms, bool)
    mask[::2] = True
    cm = torch.as_tensor(mask)
    e, w = pair.energy_virial(st.x, st.type, nbr, st.box.h, center_mask=cm)
    jE, jW = _jax_masked(jeng, mask)
    assert abs(float(e) - jE) <= TOL_JAX * abs(jE)
    assert rel_err(w.numpy(), jW) <= TOL_JAX
    aE, aW = _autograd(pair, st, nbr, center_mask=cm)
    assert abs(float(e) - aE) <= TOL_SELF * abs(aE)
    assert rel_err(w.numpy(), aW) <= TOL_SELF
    full, _ = pair.energy_virial(st.x, st.type, nbr, st.box.h)
    rest, _ = pair.energy_virial(st.x, st.type, nbr, st.box.h,
                                 center_mask=~cm)
    assert abs(float(e + rest) - float(full)) <= TOL_SELF * abs(float(full))


def test_sharded_thermo_matches_jax_shard_energies():
    """Four x-slabs: each shard's (E, W) with its centre mask against the
    port's masked autograd on the same block, and the sum against the JAX
    ShardedEngine's value_and_grad (E and W of its thermo)."""
    import jax
    from lammps_plugins_tpu.api.scenes import rebomos_bulk as jbulk
    from lammps_plugins_tpu.core import units as junits
    from lammps_plugins_tpu.fixes.nve import FixNVE as JNVE
    from lammps_plugins_tpu.fixes.velocity import velocity_create as jvc
    from lammps_plugins_tpu.parallel.sharded_engine import (
        ShardedEngine as JSharded)
    from lammps_plugins_tpu.potentials.rebomos import REBOMoS as JREBO
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.parallel import ShardedEngine
    from lammps_plugins_tpu_torch.potentials.base import PairStyle
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    jst = jvc(jbulk(nx=12, ny=8, nz=1, tilt_xy=0.0), junits.METAL, 600.0,
              seed=3)
    jse = JSharded(jst, JREBO.from_file(SYNTH_REBO, ["M", "S"]), [JNVE()],
                   junits.METAL, n_devices=4, grid=(4, 1), skin=0.5)
    jse.resettle()
    jE, jW, _ = jax.device_get(jse._build_ev()(jse.shards, jse.halo,
                                               jse.nbr))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float64,
                             device="cpu")
    se = ShardedEngine(convert.state_from_numpy(jst), pair, [FixNVE()],
                       units.METAL, devices=["cpu"] * 4, grid=(4, 1),
                       skin=0.5)
    se.resettle()
    parts = se._per_shard("energy_virial")
    blocks = se._halo_blocks(se.shards.x, se.halo)
    for d, (e, w) in enumerate(parts):
        ae, aw = PairStyle.energy_virial(
            pair, blocks[d], se.halo.t_loc[d], se.nbrs[d], se._h_slab,
            center_mask=se._owned(d))
        assert abs(float(e - ae)) <= TOL_SELF * abs(float(ae))
        assert rel_err(w.numpy(), aw.numpy()) <= TOL_SELF
    E = sum(float(e) for e, _ in parts)
    W = sum(w for _, w in parts).numpy()
    assert abs(E - float(jE)) <= TOL_JAX * abs(float(jE))
    assert rel_err(W, np.asarray(jW)) <= TOL_JAX
    assert abs(se.potential_energy() - E) <= TOL_SELF * abs(E)
    row = se.thermo()
    assert abs(row["pe"] - E) <= TOL_SELF * abs(E)


def _old_lj_virial_sweep(pair, P, cells):
    """The torch sweep stress/atom ran before kernel C's virial rows:
    1/2 Σ_b fp d_a d_b over the 27 neighbour cells, read at aslot."""
    from lammps_plugins_tpu_torch.ops.lj_cells import pair_terms
    from lammps_plugins_tpu_torch.potentials.base import VIRIAL_PAIRS
    (x0, x1), (y0, y1), (z0, z1) = cells.a_range
    A = P[x0:x1, y0:y1, z0:z1]
    acc = [torch.zeros_like(A[..., 0, :]) for _ in VIRIAL_PAIRS]
    for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
        B = P[x0 + ox:x1 + ox, y0 + oy:y1 + oy, z0 + oz:z1 + oz]
        d, fp, _ = pair_terms(A, B, pair._lj_consts)
        for c, (a, b) in enumerate(VIRIAL_PAIRS):
            acc[c] = acc[c] + (fp * d[a] * d[b]).sum(dim=-1)
    return (0.5 * torch.stack(acc, dim=-1)).reshape(-1, 6)[cells.aslot]


@pytest.mark.parametrize("lj", ["full", "half"])
def test_lj_virial_rows(bulk, lj):
    """Kernel C's rows (twin) against the sweep they replace, JAX's
    per-atom LJ tallies, and the LJ part of the strain virial."""
    from lammps_plugins_tpu_torch.ops.lj_cells import lj_cell_forces
    jeng, _, _ = bulk
    pair, st, nbr = _port_of(jeng, lj=lj)
    cells = nbr.cells
    P = pair._cell_planes(st.x, nbr.ghosts, cells, st.box.h)
    out, vir = lj_cell_forces(P, pair._lj_consts, cells.a_range,
                              with_energy=True, with_virial=True)
    assert vir.shape == out.shape[:3] + (6, out.shape[-1])
    assert torch.equal(out, lj_cell_forces(P, pair._lj_consts,
                                           cells.a_range, with_energy=True))
    rows = vir.transpose(-1, -2).reshape(-1, 6)[cells.aslot]
    _, e_at, v_at = pair._lj_cells(st.x, nbr.ghosts, cells, st.box.h,
                                   with_energy=True, with_virial=True,
                                   with_forces=False)
    assert torch.equal(rows, v_at)
    assert rel_err(rows.numpy(),
                   _old_lj_virial_sweep(pair, P, cells).numpy()) <= 1e-13
    js, jn = jeng.state, jeng.nbr
    jv = np.asarray(jeng.pair._lj_virial_cells(js.x, jn.ghosts, jn.cells,
                                               js.box.h, js.natoms))
    je = np.asarray(jeng.pair._lj_peratom_cells(js.x, jn.ghosts, jn.cells,
                                                js.box.h, js.natoms))
    assert np.abs(jv).max() > 1e-3
    assert rel_err(rows.numpy(), jv) <= TOL_JAX
    assert rel_err(e_at.numpy(), je) <= TOL_JAX
    with torch.enable_grad():
        s = torch.zeros((3, 3), dtype=st.x.dtype, requires_grad=True)
        e_lj = pair._lj_energy_cells(st.x, s, nbr.ghosts, cells, st.box.h)
        (gs,) = torch.autograd.grad(e_lj, (s,))
    v6 = rows.sum(dim=0)
    w = torch.stack([v6[[0, 3, 4]], v6[[3, 1, 5]], v6[[4, 5, 2]]])
    assert rel_err(w.numpy(), -gs.numpy()) <= TOL_SELF
    e_lj = float(e_lj.detach())
    assert abs(float(e_at.sum()) - e_lj) <= TOL_SELF * abs(e_lj)


def test_host_built_lists_take_autograd(bulk):
    """A master list (no cells, no mirror tables) takes the base class's
    autograd on the CPU, and agrees with the tables path."""
    jeng, jE, jW = bulk
    jeng.device_rebuild = False
    try:
        jeng.rebuild_neighbors()
        pair, st, nbr = _port_of(jeng)
    finally:
        jeng.device_rebuild = True
        jeng.rebuild_neighbors()
    assert nbr.cells is None and "master" in nbr.lists
    e, w = pair.energy_virial(st.x, st.type, nbr, st.box.h)
    assert abs(float(e) - jE) <= TOL_JAX * abs(jE)
    assert rel_err(w.numpy(), jW) <= TOL_JAX
