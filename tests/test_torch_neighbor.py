"""Neighbor construction of the port against the JAX package.

The device rebuild runs with the same plan on the same positions in both
packages (float64, CPU: the port's select-k twin, JAX's top_k): wrapped
positions agree to rounding, image counters and ghost tables exactly,
every row has the same neighbor set, the mirror tables pair the same
edges (and mirror(mirror(e)) = e), and every coarse cell holds the same
atoms (the port orders each LJ cell's slots by sub-cell, so rows are
compared as sets; _bin_dense's order is checked on its own).  Plans and
the host build agree too.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu_torch import convert
from lammps_plugins_tpu_torch.neighbor import device_build as pdb
from lammps_plugins_tpu_torch.neighbor.build import build_neighbor_data
from torch_parity import jax_engine


@pytest.fixture(scope="module")
def rebuilt():
    from lammps_plugins_tpu.neighbor import device_build as jdb
    jeng = jax_engine("bulk", "f64", jiggle=0.05)
    js = jeng.state
    h, h_inv, lo = jeng._box_dev
    plan = jeng._plan
    jxw, jimg, jnbr, jflags = jdb.device_rebuild(
        plan, js.x, js.image, js.type, h, h_inv, lo, jeng._cut_mats_dev)
    ps = convert.state_from_numpy(js)
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pxw, pimg, pnbr, pflags = pdb.device_rebuild(
        convert.plan_from_fields(plan), ps.x, ps.image, ps.type,
        as_t(h), as_t(h_inv), as_t(lo), jeng.pair.neighbor_requests())
    return (jxw, jimg, jnbr, jflags), (pxw, pimg, pnbr,
                                       pdb.flags_to_host(pflags))


def test_wrap_and_ghosts_agree(rebuilt):
    (jxw, jimg, jnbr, _), (pxw, pimg, pnbr, _) = rebuilt
    # XLA may contract the wrap's multiply-adds into FMAs: ulp level
    np.testing.assert_allclose(pxw.numpy(), np.asarray(jxw), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(pimg.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(pnbr.ghosts.owner.numpy(),
                                  np.asarray(jnbr.ghosts.owner))
    np.testing.assert_array_equal(pnbr.ghosts.shift.numpy(),
                                  np.asarray(jnbr.ghosts.shift))


def test_flags_and_counts_identical(rebuilt):
    (_, _, _, jflags), (_, _, _, pflags) = rebuilt
    jf = {k: int(v) for k, v in jflags.items()
          if not k.startswith("count:mirwin")}
    assert pflags == jf


def test_same_neighbor_sets_per_row(rebuilt):
    (_, _, jnbr, _), (_, _, pnbr, _) = rebuilt
    jl, pl = jnbr.lists["rebo"], pnbr.lists["rebo"]
    jidx, jm = np.asarray(jl.idx), np.asarray(jl.mask)
    pidx, pm = pl.idx.numpy(), pl.mask.numpy()
    assert pidx.shape == jidx.shape
    for i in range(jidx.shape[0]):
        assert sorted(pidx[i][pm[i]]) == sorted(jidx[i][jm[i]])
    np.testing.assert_array_equal(pl.jtype.numpy()[pm],
                                  np.asarray(jl.jtype)[jm])


def test_mirror_tables_pair_the_same_edges(rebuilt):
    """Slot orders may differ on exact rsq ties, so compare each edge's
    mirror as (row, neighbor id) rather than as a flat slot."""
    (_, _, jnbr, _), (_, _, pnbr, _) = rebuilt

    def mirror_edges(idx, mask, mirror):
        K = idx.shape[1]
        rows, cols = np.nonzero(mask)
        m = mirror[rows, cols]
        assert (m >= 0).all()
        return {(r, idx[r, c]): (mm // K, idx[mm // K, mm % K])
                for r, c, mm in zip(rows, cols, m)}

    jl, pl = jnbr.lists["rebo"], pnbr.lists["rebo"]
    assert mirror_edges(pl.idx.numpy(), pl.mask.numpy(),
                        pl.mirror.numpy()) == mirror_edges(
        np.asarray(jl.idx), np.asarray(jl.mask), np.asarray(jl.mirror))
    flat = pl.mirror.reshape(-1)
    ok = pl.mask.reshape(-1)
    np.testing.assert_array_equal(flat[flat[ok]].numpy(),
                                  np.nonzero(ok.numpy())[0])


def test_same_cell_occupancy(rebuilt):
    (_, _, jnbr, _), (_, _, pnbr, _) = rebuilt
    jt, pt = np.asarray(jnbr.cells.table), pnbr.cells.table.numpy()
    ncells = pnbr.cells.nbr_map.shape[0]
    assert pt.shape == jt.shape
    for c in range(ncells):
        assert sorted(pt[c]) == sorted(jt[c])
    np.testing.assert_array_equal(pnbr.cells.nbr_map.numpy(),
                                  np.asarray(jnbr.cells.nbr_map))
    m_all = pt.max()
    # each owned atom's aslot points at its own cell slot in both tables
    Dx, Dy, Dz = pnbr.cells.dims
    (x0, x1), (y0, y1), (z0, z1) = pnbr.cells.a_range
    grid = pt[:Dx * Dy * Dz].reshape(Dx, Dy, Dz, -1)[x0:x1, y0:y1, z0:z1]
    n = pnbr.cells.n_owned
    np.testing.assert_array_equal(grid.reshape(-1)[
        pnbr.cells.aslot.numpy()], np.arange(n))
    assert m_all == n + pnbr.ghosts.count


def test_plans_match_jax():
    from lammps_plugins_tpu.api.scenes import rebomos_bulk as jbulk
    from lammps_plugins_tpu.neighbor import device_build as jdb
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from torch_parity import SYNTH_REBO
    req = REBOMoS.from_file(SYNTH_REBO, ["M", "S"],
                            device="cpu").neighbor_requests()
    jb = jbulk().box
    pb = rebomos_bulk(dtype=torch.float64, device="cpu").box
    kw = dict(cell_tiers=("master",), mirror_tiers=("rebo",))
    jp = jdb.make_plan_from_density(jb, req, 0.8, 288, **kw)
    pp = pdb.make_plan_from_density(pb, req, 0.8, 288, **kw)
    assert pp == convert.plan_from_fields(jp)
    jp = jdb.make_plan(jb, req, 1.0, 4000, 70, {"rebo": 22}, k_final=True,
                       bnd_count=300, **kw)
    pp = pdb.make_plan(pb, req, 1.0, 4000, 70, {"rebo": 22}, k_final=True,
                       bnd_count=300, **kw)
    assert pp == convert.plan_from_fields(jp)


def test_host_build_matches_jax():
    from lammps_plugins_tpu.api.scenes import rebomos_bulk as jbulk
    from lammps_plugins_tpu.neighbor.build import build_neighbor_data as jb
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from torch_parity import SYNTH_REBO
    req = REBOMoS.from_file(SYNTH_REBO, ["M", "S"],
                            device="cpu").neighbor_requests()
    js, ps = jbulk(), rebomos_bulk(dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(ps.x.numpy(), np.asarray(js.x))
    jn = jb(np.asarray(js.x), np.asarray(js.type), js.box, req, skin=1.0,
            dtype=jnp.float64)
    pn = build_neighbor_data(ps.x.numpy(), ps.type.numpy(), ps.box, req,
                             skin=1.0, dtype=torch.float64, device="cpu")
    for name in ("rebo", "master"):
        np.testing.assert_array_equal(pn.lists[name].idx.numpy(),
                                      np.asarray(jn.lists[name].idx))
        np.testing.assert_array_equal(pn.lists[name].mask.numpy(),
                                      np.asarray(jn.lists[name].mask))
    np.testing.assert_array_equal(pn.ghosts.owner.numpy(),
                                  np.asarray(jn.ghosts.owner))


def test_box_geometry_matches_jax():
    """Triclinic h_inv, volume, wrap/unmap (torch and numpy forms) and the
    cell angles of the port's Box against the JAX Box, float64."""
    from lammps_plugins_tpu.core.box import Box as JBox
    from lammps_plugins_tpu_torch.core.box import Box
    geo = dict(lx=12.8, ly=22.1, lz=14.0, xy=-6.4, xz=1.1, yz=-0.7,
               lo=(0.3, -1.2, 0.5))
    jb = JBox.triclinic(**geo, dtype=jnp.float64)
    pb = Box.triclinic(**geo, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(7)
    x = rng.uniform(-30.0, 40.0, (64, 3))
    img = rng.integers(-2, 3, (64, 3)).astype(np.int32)
    np.testing.assert_allclose(pb.h_inv.numpy(), np.asarray(jb.h_inv),
                               rtol=1e-15, atol=1e-17)
    assert abs(float(pb.volume) - float(jb.volume)) < 1e-12 * float(
        jb.volume)
    jxw, jimg = jb.wrap(jnp.asarray(x), jnp.asarray(img))
    pxw, pimg = pb.wrap(torch.from_numpy(x), torch.from_numpy(img))
    np.testing.assert_allclose(pxw.numpy(), np.asarray(jxw), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(pimg.numpy(), np.asarray(jimg))
    # unmap restores x shifted by the image counters it started with
    np.testing.assert_allclose(pb.unmap(pxw, pimg).numpy(),
                               x + img @ pb.h_np(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pb.unmap(pxw, pimg).numpy(),
                               np.asarray(jb.unmap(jxw, jimg)), rtol=0,
                               atol=1e-12)
    for a, b in zip(pb.wrap_np(x, img), jb.wrap_np(x, img)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(pb.cell_angles_deg_np(),
                               jb.cell_angles_deg_np(), rtol=1e-15)


def test_spatial_sort_matches_jax():
    from lammps_plugins_tpu.api.scenes import spatial_sort as jsort
    from lammps_plugins_tpu_torch.api.scenes import (
        rebomos_bulk_commensurate, spatial_sort)
    st = rebomos_bulk_commensurate(3, 4, 2, dtype=torch.float64,
                                   device="cpu")
    pos, types = st.x.numpy(), st.type.numpy()
    for a, b in zip(spatial_sort(pos, types), jsort(pos, types)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_compact_is_a_fixed_shape_nonzero():
    mask = torch.tensor([0, 1, 1, 0, 1, 0, 1], dtype=torch.bool)
    np.testing.assert_array_equal(pdb._compact(mask, 6).numpy(),
                                  [1, 2, 4, 6, -1, -1])
    np.testing.assert_array_equal(pdb._compact(mask, 2).numpy(), [1, 2])


def test_overflow_recovery_resizes():
    """Sabotaged capacities: the Engine re-sizes from the flags and the
    energy is unchanged."""
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine, _quantize_k
    from torch_parity import SYNTH_REBO
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float64,
                             device="cpu")
    scene = dict(dtype=torch.float64, device="cpu")
    ref = Engine(rebomos_bulk(**scene), pair, [FixNVE()], units.METAL)
    pe_ref, _ = ref.evaluate()
    eng = Engine(rebomos_bulk(**scene), pair, [FixNVE()], units.METAL)
    eng._make_plan_fast()
    eng._plan = dataclasses.replace(
        eng._plan, ghost_capacity=8, cell_capacity=8, cand_capacity=2,
        bnd_capacity=16, k_caps=tuple((k, 8) for k, _ in eng._plan.k_caps))
    pe, _ = eng.evaluate()
    assert abs(float(pe) - float(pe_ref)) < 1e-9 * abs(float(pe_ref))
    # K comes back to the measured high-water mark + 2, not inflated
    for name, k in eng._plan.k_caps:
        assert k == _quantize_k(eng._k_hwm[name] + 2) == \
            dict(ref._plan.k_caps)[name]


@pytest.mark.parametrize("sub,interior", [(2, 0), (4, 0), (4, 40)])
def test_bin_dense_orders_slots_by_subcell(sub, interior):
    """Each cell's slots in Morton order of the sub x sub x sub sub-cell
    (stable within one), the same atoms per cell as the plain order."""
    rng = np.random.default_rng(sub + interior)
    dims, size, m = (4, 3, 5), 2.0, 300
    x = torch.as_tensor(rng.uniform(-0.5, 10.5, (m, 3)))
    valid = torch.as_tensor(rng.uniform(size=m) < 0.9)
    mn = torch.zeros(3, dtype=torch.float64)
    args = (x, valid, mn, size, dims, 64, m)
    plain, c3, occ, ovf, _, _ = pdb._bin_dense(*args,
                                               interior_first=interior)
    table, c3s, occs, ovfs, _, _ = pdb._bin_dense(
        *args, interior_first=interior, sub=sub)
    assert not bool(ovf) and int(occ) == int(occs) and not bool(ovfs)
    assert torch.equal(c3, c3s)
    u = x.numpy() / size - c3.numpy()
    s3 = np.clip(np.floor(u * sub).astype(np.int64), 0, sub - 1)
    key = np.zeros(m, np.int64)
    for k in range(sub.bit_length() - 1):
        for d in range(3):
            key |= ((s3[:, d] >> k) & 1) << (3 * k + 2 - d)
    for row_p, row_s in zip(plain.numpy(), table.numpy()):
        assert sorted(row_p) == sorted(row_s)
        ids = row_s[row_s < m]
        assert (np.diff(key[ids]) >= 0).all()
        # stable: input order within one sub-cell
        for kk in np.unique(key[ids]):
            run = ids[key[ids] == kk]
            assert (np.diff(run) > 0).all()


def test_rebuild_orders_lj_cells_by_subcell(monkeypatch):
    """The device rebuild bins the LJ cells with sub = LJ_CELL_SUB: every
    cell of the table it returns lists its atoms in sub-cell Morton order
    of the coordinates it binned, and aslot still inverts the table (the
    rows stay set-equal to the JAX rebuild's: test_same_cell_occupancy)."""
    from torch_parity import port_engine
    calls = []
    real = pdb._bin_dense

    def spy(*args, **kw):
        out = real(*args, **kw)
        if kw.get("sub", 1) > 1:
            calls.append((args, kw, out))
        return out

    monkeypatch.setattr(pdb, "_bin_dense", spy)
    eng = port_engine("bulk", jiggle=0.05)
    eng.rebuild_neighbors()
    assert calls                      # the last one made eng.nbr
    (x_all, valid, mn, size, dims, cap, m_all), kw, (table, c3, *_) = \
        calls[-1]
    sub = kw["sub"]
    assert sub == pdb.LJ_CELL_SUB > 1
    cells = eng.nbr.cells
    assert torch.equal(cells.table, table)
    u = ((x_all - mn) / size).numpy() - c3.numpy()
    s3 = np.clip(np.floor(u * sub).astype(np.int64), 0, sub - 1)
    key = pdb._morton(torch.as_tensor(s3), sub).numpy()
    for row in table.numpy():
        ids = row[row < m_all]
        assert (np.diff(key[ids]) >= 0).all()
    Dx, Dy, Dz = cells.dims
    (x0, x1), (y0, y1), (z0, z1) = cells.a_range
    grid = table[:Dx * Dy * Dz].reshape(Dx, Dy, Dz, -1)[x0:x1, y0:y1, z0:z1]
    np.testing.assert_array_equal(grid.reshape(-1)[cells.aslot].numpy(),
                                  np.arange(cells.n_owned))


def _mirror_table_by_slots(idx, mask, owner, ghost_valid, sidx_ghost, inv_t,
                           n, K):
    """The mirror table by a compare against the mirror row's index list,
    one neighbor slot at a time (the lowest matching slot wins): the
    reference for device_build's sort-and-search form."""
    Mg = owner.shape[0]
    ar_n = torch.arange(n)
    o_all = torch.cat([ar_n, owner])
    inv_all = torch.cat([torch.zeros_like(ar_n), inv_t[sidx_ghost]])
    safe = torch.where(mask, idx, torch.zeros_like(idx))
    o, inv_sj = o_all[safe], inv_all[safe]
    ginv = torch.full((n + 1, inv_t.shape[0]), -1, dtype=torch.int64)
    ginv[ar_n, 0] = ar_n
    gown = torch.where(ghost_valid, owner, torch.full_like(owner, n))
    ginv[gown, sidx_ghost] = n + torch.arange(Mg)
    tgt = torch.gather(ginv[:n], 1, inv_sj)
    colp = torch.full_like(idx, K)
    for kk in range(K - 1, -1, -1):
        hit = (idx[:, kk][o] == tgt) & (tgt >= 0)
        colp = torch.where(hit, torch.full_like(colp, kk), colp)
    return torch.where(mask & (colp < K), o * K + colp,
                       torch.full_like(idx, -1))


@pytest.mark.parametrize("deck", ["charged_melt", "lj_melt", "rebomos"])
def test_mirror_table_equals_the_slot_by_slot_search(monkeypatch, deck):
    """Every rebuild of a 40-step run (K 28 for REBOMOS, 96 for the LJ
    decks; f32) makes the same mirror table as the slot-by-slot search."""
    from lammps_plugins_tpu_torch.api import scenes
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    from torch_parity import SYNTH_REBO
    f32 = dict(dtype=torch.float32, device="cpu")
    same = []
    real = pdb._mirror_table

    def spy(*args):
        out = real(*args)
        same.append(torch.equal(out, _mirror_table_by_slots(*args)))
        return out

    monkeypatch.setattr(pdb, "_mirror_table", spy)
    if deck == "rebomos":
        eng = Engine(scenes.rebomos_bulk_commensurate(4, 4, 2, **f32),
                     REBOMoS.from_file(SYNTH_REBO, ["M", "S"], **f32),
                     [FixNVE()], units.METAL)
    else:
        eng = getattr(scenes, deck)(5, **f32).engine()
    eng.run(40)
    assert len(same) >= 2 and all(same)


# -- edge vectors ----------------------------------------------------------

def _edge_inputs(rebuilt, strained):
    """(JAX args, port args) of edge_vectors on the JAX rebuild's REBO
    list, wrapped positions and box, with a seeded strain or none."""
    from lammps_plugins_tpu.api.scenes import rebomos_bulk
    (jxw, _, jnbr, _), _ = rebuilt
    h = np.array(rebomos_bulk(dtype=jnp.float64).box.h)
    strain = (np.random.default_rng(3).uniform(-0.01, 0.01, (3, 3))
              if strained else None)
    pnbr = convert.neighbor_data_from_numpy(jnbr)
    jargs = (jxw, jnbr.ghosts, jnbr.lists["rebo"], jnp.asarray(h),
             None if strain is None else jnp.asarray(strain))
    pargs = (torch.from_numpy(np.array(jxw)), pnbr.ghosts,
             pnbr.lists["rebo"], torch.from_numpy(h),
             None if strain is None else torch.from_numpy(strain))
    return jargs, pargs


@pytest.mark.parametrize("strained", [False, True], ids=["plain", "strain"])
def test_edge_vectors_match_jax(rebuilt, strained):
    """d, rsq_safe (1 on masked slots) and the mask of the port's
    edge_vectors against JAX's, with and without a strain."""
    from lammps_plugins_tpu.neighbor.neighbor import edge_vectors as jev
    from lammps_plugins_tpu_torch.neighbor.neighbor import edge_vectors
    from torch_parity import rel_err
    jargs, pargs = _edge_inputs(rebuilt, strained)
    jd, jr, jm = jev(*jargs)
    pd, pr, pm = edge_vectors(*pargs)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert pd.shape == (pm.shape[0], pm.shape[1], 3)
    assert rel_err(pd.numpy(), jd) <= 1e-12
    assert rel_err(pr.numpy(), jr) <= 1e-12
    assert bool((pr[~pm] == 1.0).all()) and bool(pm.any())


def test_edge_vectors_strain_virial_matches_jax(rebuilt):
    """W = -dE/dstrain at zero strain through torch.autograd equals JAX's
    gradient, for a pair energy of the masked edges' rsq."""
    import jax
    from lammps_plugins_tpu.neighbor.neighbor import edge_vectors as jev
    from lammps_plugins_tpu_torch.neighbor.neighbor import edge_vectors
    from torch_parity import rel_err
    jargs, pargs = _edge_inputs(rebuilt, False)

    def jenergy(strain):
        _, rsq, mask = jev(*jargs[:4], strain)
        return jnp.sum(jnp.where(mask, jnp.exp(-rsq / 4.0), 0.0))

    jW = -jax.grad(jenergy)(jnp.zeros((3, 3), jnp.float64))
    strain = torch.zeros((3, 3), dtype=torch.float64, requires_grad=True)
    _, rsq, mask = edge_vectors(*pargs[:4], strain)
    e = torch.sum(torch.where(mask, torch.exp(-rsq / 4.0),
                              torch.zeros_like(rsq)))
    W = -torch.autograd.grad(e, strain)[0]
    assert float(np.abs(np.asarray(jW)).max()) > 1e-3
    assert rel_err(W.numpy(), jW) <= 1e-10
