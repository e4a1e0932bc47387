"""Per-atom tallies of the port (energy_peratom, virial_peratom: compute
pe/atom and stress/atom) against the JAX package's, float64 on the CPU.

  * REBOMoS on the jiggled 288-atom in.rebomos-bulk scene with the
    synthetic parameters, on the JAX Engine's own lists in both forms: the
    host build (REBO plus the LJ master list: the port's [N, K] path and
    scatter twin) and the device rebuild (REBO with its [K, Np] mirror
    tables plus the LJ cell grid: the port's kernel path, here the twins of
    kernels A, B and C and the torch LJ virial sweep);
  * AEAM on the jiggled 108-atom Al-Si cell, symmetric and asymmetric
    grids (tests/test_torch_aeam.py's scenes);
  * lj/cut and lj/cut/coul/cut on the 256-atom LJ melt and the 128-ion
    charged melt (the JAX package has no energy_peratom for these styles:
    the port's is held to its own global energy).

Each per-atom quantity is held to the JAX function at 1e-9 relative (max
|a - b| / max |b|) and its sum to the port's own global energy and
strain virial at 1e-10; the target-table and both mirror-table tallies to
the scatter twin; kernel C's energy row to JAX's _lj_peratom_cells.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_plugins_tpu_torch import convert
from torch_parity import jax_engine, rel_err

W6 = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def _w6(W):
    W = np.asarray(W)
    return np.array([W[a, b] for a, b in W6])


def _jax_peratom(eng):
    st = eng.state
    return (np.asarray(eng.pair.energy_peratom(st.x, st.type, eng.nbr,
                                               st.box.h)),
            np.asarray(eng.pair.virial_peratom(st.x, st.type, eng.nbr,
                                               st.box.h)))


def _port_peratom(pair, st, nbr):
    e = pair.energy_peratom(st.x, st.type, nbr, st.box.h)
    v = pair.virial_peratom(st.x, st.type, nbr, st.box.h)
    pe, W = pair.energy_virial(st.x, st.type, nbr, st.box.h)
    return e.numpy(), v.numpy(), float(pe), _w6(W.numpy())


@pytest.fixture(scope="module")
def rebo():
    """{lists: (JAX eatom, JAX vatom, port eatom, vatom, pe, W6, port
    (pair, state, nbr), JAX engine)} on the JAX Engine's lists."""
    out = {}
    for lists in ("cells", "master"):
        jeng = jax_engine("bulk", jiggle=0.1)
        if lists == "master":
            jeng.device_rebuild = False
            jeng.rebuild_neighbors()
        je, jv = _jax_peratom(jeng)
        pair = convert.rebomos_from_tables(jeng.pair.tables,
                                           jeng.pair.typemap_np)
        st = convert.state_from_numpy(jeng.state)
        nbr = convert.neighbor_data_from_numpy(jeng.nbr)
        out[lists] = (je, jv) + _port_peratom(pair, st, nbr) \
            + ((pair, st, nbr), jeng)
    return out


@pytest.mark.parametrize("lists", ["cells", "master"])
@pytest.mark.parametrize("quantity", ["energy", "virial"])
def test_rebomos_peratom_matches_jax(rebo, lists, quantity):
    je, jv, pe_at, pv_at = rebo[lists][:4]
    if lists == "cells":
        nbr = rebo[lists][6][2]
        assert nbr.cells is not None and nbr.lists["rebo"].mirT is not None
    else:
        assert "master" in rebo[lists][6][2].lists
    a, b = (pe_at, je) if quantity == "energy" else (pv_at, jv)
    assert np.abs(b).max() > 1e-3
    assert rel_err(a, b) <= 1e-9


@pytest.mark.parametrize("lists", ["cells", "master"])
def test_rebomos_peratom_sums_to_global(rebo, lists):
    _, _, e, v, pe, w = rebo[lists][:6]
    assert abs(e.sum() - pe) <= 1e-10 * abs(pe)
    assert np.abs(v.sum(axis=0) - w).max() <= 1e-10 * np.abs(w).max()


def _scatter_tally(vals, nlist, ghosts, n):
    """half_half's CPU twin, the scatter-add, on the list without its
    mirror table."""
    from lammps_plugins_tpu_torch.potentials.base import half_half
    return half_half(vals, dataclasses.replace(nlist, mirror=None), ghosts,
                     n)


def _target_table_tally(vals, nlist, ghosts, n):
    """half_half's route on a CUDA list without a mirror table, taken on
    the CPU: the sort-built target table and the gather."""
    from lammps_plugins_tpu_torch.potentials.base import (edge_targets,
                                                          target_table)
    C = vals.shape[-1]
    table = target_table(edge_targets(nlist, ghosts, n).reshape(-1), n)
    flat = torch.cat([vals.reshape(-1, C), vals.new_zeros((1, C))])
    return 0.5 * vals.sum(dim=1) + 0.5 * flat[table].sum(dim=1)


def test_rebo_mirror_tally_equals_scatter(rebo):
    """The [K, Np] mirror-table tally (kernel B's twin), the [N, K] mirror
    table and the target table give the scatter twin's per-atom sums of
    REBO edge terms."""
    from lammps_plugins_tpu_torch.potentials.base import (half_half,
                                                          half_half_mirror)
    pair, st, nbr = rebo["cells"][6]
    rebo_l = nbr.lists["rebo"]
    assert rebo_l.mirror is not None
    N, K = rebo_l.idx.shape
    rng = np.random.default_rng(5)
    vals = torch.where(rebo_l.mask[..., None],
                       torch.as_tensor(rng.normal(size=(N, K, 4))), 0.0)
    scatter = _scatter_tally(vals, rebo_l, nbr.ghosts, N)
    table = _target_table_tally(vals, rebo_l, nbr.ghosts, N)
    rows = half_half(vals, rebo_l, nbr.ghosts, N)
    Np = rebo_l.idxT.shape[1]
    planes = [torch.nn.functional.pad(vals[..., c].t(), (0, Np - N))
              for c in range(4)]
    mirror = half_half_mirror(planes, rebo_l.mirT, rebo_l.mirvT.double(), N)
    for got in (table, rows, mirror):
        assert rel_err(got.numpy(), scatter.numpy()) <= 1e-13


def test_lj_energy_row_matches_jax_peratom_cells(rebo):
    """Kernel C's energy row (twin), read at aslot, is JAX's
    _lj_peratom_cells: the same half-half split of each LJ pair."""
    from lammps_plugins_tpu_torch.ops.lj_cells import lj_cell_forces
    pair, st, nbr = rebo["cells"][6]
    jeng = rebo["cells"][7]
    js = jeng.state
    ref = np.asarray(jeng.pair._lj_peratom_cells(
        js.x, jeng.nbr.ghosts, jeng.nbr.cells, js.box.h, js.natoms))
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    out = lj_cell_forces(P, pair._lj_consts, nbr.cells.a_range,
                         with_energy=True)
    row = out[..., 3, :].reshape(-1)[nbr.cells.aslot].numpy()
    assert np.abs(ref).max() > 1e-3
    assert rel_err(row, ref) <= 1e-9


def test_rebomos_peratom_on_the_port_rebuild(rebo):
    """The port's own Engine and device rebuild (its lists, not JAX's)
    give JAX's per-atom values on the same positions."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.run.simulation import Engine
    je, jv = rebo["cells"][:2]
    pair, st, _ = rebo["cells"][6]
    eng = Engine(st, pair, [FixNVE()], units.METAL, skin=2.0)
    eng.rebuild_neighbors()
    s = eng.state
    e = pair.energy_peratom(s.x, s.type, eng.nbr, s.box.h).numpy()
    v = pair.virial_peratom(s.x, s.type, eng.nbr, s.box.h).numpy()
    assert rel_err(e, je) <= 1e-9 and rel_err(v, jv) <= 1e-9


# -- AEAM -------------------------------------------------------------------

@pytest.fixture(scope="module")
def aeam():
    from test_torch_aeam import jax_scene, port_of
    out = {}
    for case in ("fast", "asym", "pure_al"):
        jeng = jax_scene(case)
        je, jv = _jax_peratom(jeng)
        pair, st, nbr = port_of(jeng)
        out[case] = (je, jv) + _port_peratom(pair, st, nbr) \
            + ((pair, st, nbr),)
    return out


@pytest.mark.parametrize("case", ["fast", "asym", "pure_al"])
@pytest.mark.parametrize("quantity", ["energy", "virial"])
def test_aeam_peratom_matches_jax(aeam, case, quantity):
    je, jv, e, v = aeam[case][:4]
    a, b = (e, je) if quantity == "energy" else (v, jv)
    assert np.abs(b).max() > 1e-3
    assert rel_err(a, b) <= 1e-9


@pytest.mark.parametrize("case", ["fast", "asym", "pure_al"])
def test_aeam_peratom_sums(aeam, case):
    """The virial always sums to W; the energy sums to the PE only without
    angular atoms (the reference gives an angular atom F/3, a quirk the
    JAX package keeps: pair_aeam.cpp:296-301)."""
    _, _, e, v, pe, w = aeam[case][:6]
    assert np.abs(v.sum(axis=0) - w).max() <= 1e-10 * np.abs(w).max()
    if case == "pure_al":
        assert abs(e.sum() - pe) <= 1e-10 * abs(pe)
    else:
        assert abs(e.sum() - pe) > 1e-6


@pytest.mark.parametrize("case", ["fast", "asym"])
def test_aeam_target_table_equals_scatter(aeam, case):
    """The target-table gather (the card's route on the fast path's lists,
    which carry no mirror table) gives the scatter twin's vatom."""
    from lammps_plugins_tpu_torch.potentials.base import (
        edge_virial_components)
    pair, st, nbr = aeam[case][6]
    main = nbr.lists["main"]
    N, K = main.idx.shape
    rng = np.random.default_rng(8)
    d = [torch.as_tensor(rng.normal(size=(N, K))) for _ in range(3)]
    g = [torch.as_tensor(rng.normal(size=(N, K))) for _ in range(3)]
    vals = edge_virial_components(d, g, main.mask)
    a = _scatter_tally(vals, main, nbr.ghosts, N)
    b = _target_table_tally(vals, main, nbr.ghosts, N)
    assert rel_err(b.numpy(), a.numpy()) <= 1e-13


# -- lj/cut and lj/cut/coul/cut --------------------------------------------

@pytest.fixture(scope="module")
def ljcut():
    """{deck: (JAX vatom, port eatom, vatom, pe, W6, (pair, state, nbr))}
    on the JAX Script deck's lists (host build, main list)."""
    from test_torch_ljcut import jax_deck_engine
    out = {}
    for name in ("lj", "charged"):
        jeng = jax_deck_engine(name)
        jeng.rebuild_neighbors()
        js = jeng.state
        jv = np.asarray(jeng.pair.virial_peratom(js.x, js.type, jeng.nbr,
                                                 js.box.h))
        jp = jeng.pair
        pair = convert.ljcut_from_fields(
            jp._eps, jp._sig, jp._cut, jp._isset, jp.cut_global,
            cut_coul=getattr(jp, "cut_coul", None),
            qqr2e=getattr(jp, "qqr2e", 1.0))
        st = convert.state_from_numpy(js)
        pair.bind_charges(st.q)
        nbr = convert.neighbor_data_from_numpy(jeng.nbr)
        out[name] = (jv,) + _port_peratom(pair, st, nbr) \
            + ((pair, st, nbr),)
    return out


@pytest.mark.parametrize("name", ["lj", "charged"])
def test_ljcut_virial_peratom_matches_jax(ljcut, name):
    jv, _, v = ljcut[name][:3]
    assert np.abs(jv).max() > 1e-3
    assert rel_err(v, jv) <= 1e-9


@pytest.mark.parametrize("name", ["lj", "charged"])
def test_ljcut_peratom_sums_to_global(ljcut, name):
    _, e, v, pe, w = ljcut[name][:5]
    assert abs(e.sum() - pe) <= 1e-10 * abs(pe)
    assert np.abs(v.sum(axis=0) - w).max() <= 1e-10 * np.abs(w).max()


@pytest.mark.parametrize("name", ["lj", "charged"])
def test_ljcut_target_table_equals_scatter(ljcut, name):
    pair, st, nbr = ljcut[name][5]
    main = nbr.lists["main"]
    N, K = main.idx.shape
    vals = torch.where(main.mask[..., None], torch.as_tensor(
        np.random.default_rng(2).normal(size=(N, K, 3))), 0.0)
    a = _scatter_tally(vals, main, nbr.ghosts, N)
    b = _target_table_tally(vals, main, nbr.ghosts, N)
    assert rel_err(b.numpy(), a.numpy()) <= 1e-13


@pytest.mark.parametrize("name", ["lj", "charged"])
def test_ljcut_mirror_tally_matches_jax(ljcut, name):
    """On the port's own rebuild, whose lists carry the mirror table that
    the forces read (the card's route), eatom and vatom go through the
    mirror gather: vatom equals JAX's on the same positions at 1e-9, both
    equal the scatter twin's, and they sum to the global energy and
    virial at 1e-10."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.run.simulation import Engine
    jv = ljcut[name][0]
    pair, st, _ = ljcut[name][5]
    eng = Engine(st, pair, [FixNVE()], units.LJ, skin=0.3)
    eng.rebuild_neighbors()
    s, nbr = eng.state, eng.nbr
    main = nbr.lists["main"]
    assert main.mirror is not None
    e, v, pe, w = _port_peratom(pair, s, nbr)[:4]
    assert rel_err(v, jv) <= 1e-9
    plain = dataclasses.replace(nbr, lists={"main": dataclasses.replace(
        main, mirror=None)})
    e0, v0 = _port_peratom(pair, s, plain)[:2]
    assert rel_err(e, e0) <= 1e-13 and rel_err(v, v0) <= 1e-13
    assert abs(e.sum() - pe) <= 1e-10 * abs(pe)
    assert np.abs(v.sum(axis=0) - w).max() <= 1e-10 * np.abs(w).max()
