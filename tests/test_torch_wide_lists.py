"""Neighbour lists past the sizes the card refused before (float64, CPU):
the port's twins against the JAX package where the kernels' old limits
were K <= 256 (the selection D' and D), K <= 64 (the REBO kernel A) and
at most 15 atom types (D''s cut table).

  * the wide-cut charged melt: tests/test_ljcut.py's deck at block
    0 8 0 8 0 8 (1,024 ions) with lj/cut/coul/cut 6 12 and LAMMPS's
    default metal skin of 2 A, through both packages' Scripts: K past
    256 and the same in both, every row the same neighbours on the same
    plan, energy, forces and the strain virial on the same lists (1e-9),
    and the 20-step thermo rows (1e-9);
  * REBOMOS at skin 4.0 on rebomos_bulk_commensurate(6, 8, 3) (864
    atoms), jiggled: the REBO list's K past 64 in both packages, forces
    and the REBO energy against JAX's on its own lists (1e-9), and the
    twin against the JAX Pallas kernel in interpret mode at that K (f32,
    5e-4 x scale);
  * a 21-type lj/cut mixture with a cutoff for every type pair: the
    port's device rebuild on JAX's plan gives JAX's device_rebuild lists
    (idx, jtype, mask) row by row, and its kmax.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu_torch import convert
from torch_parity import SYNTH_REBO, mixture_arrays, rel_err

CPU = dict(dtype=torch.float64, device="cpu")
TOL = 1e-9

WIDE_SETUP = """
units           metal
atom_style      charge
lattice         bcc 4.2
region          box block 0 8 0 8 0 8
create_box      2 box
create_atoms    1 box
set             group all type/fraction 2 0.5 777
set             type 1 charge 1.0
set             type 2 charge -1.0
mass            1 22.99
mass            2 35.45
velocity        all create 300.0 4928459
pair_style      lj/cut/coul/cut 6.0 12.0
pair_coeff      1 1 0.01 2.5
pair_coeff      2 2 0.01 3.4
neighbor        2.0 bin
fix             B all bfield 0.0 0.0 200.0
fix             1 all nve
"""
WIDE_RUN = """
thermo          10
run             20
"""


def _scripts(text):
    """(JAX Script, port Script) after running `text`."""
    from lammps_plugins_tpu.api.script import Script as JScript
    from lammps_plugins_tpu_torch.api.script import Script as PScript
    js, ps = JScript(log=lambda *a: None), PScript(log=lambda *a: None,
                                                   **CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the deck's 200 T field
        js.run_text(text)
        ps.run_text(text)
    return js, ps


@pytest.fixture(scope="module")
def wide():
    """(JAX Engine, port Engine) of the wide-cut deck before its run, each
    after its own device rebuild."""
    js, ps = _scripts(WIDE_SETUP)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        je, pe = js._make_engine(), ps._make_engine()
    je.device_rebuild = True
    je.rebuild_neighbors()
    pe.rebuild_neighbors()
    return je, pe


def _k_and_kmax(nbr, name):
    lst = nbr.lists[name]
    return lst.idx.shape[1], int(np.asarray(lst.mask).sum(axis=1).max())


def test_wide_deck_k_past_256_in_both(wide):
    je, pe = wide
    (kj, mj), (kp, mp) = _k_and_kmax(je.nbr, "main"), \
        _k_and_kmax(pe.nbr, "main")
    assert kj > 256 and kp > 256
    assert kj == kp and mj == mp
    assert dict(pe._plan.k_caps) == dict(je._plan.k_caps)


def test_wide_deck_rows_hold_the_same_neighbours(wide):
    """Every row of the port's list holds JAX's neighbours (K exceeds
    kmax, so ties cannot push one out; slot order may differ on the
    lattice's exact ties)."""
    je, pe = wide
    jl, pl = je.nbr.lists["main"], pe.nbr.lists["main"]
    big = np.iinfo(np.int64).max
    jrows = np.sort(np.where(np.asarray(jl.mask),
                             np.asarray(jl.idx).astype(np.int64), big))
    prows = np.sort(np.where(pl.mask.numpy(), pl.idx.numpy(), big))
    np.testing.assert_array_equal(prows, jrows)
    # the ghost tables are equal, so the same ids are the same images
    np.testing.assert_array_equal(pe.nbr.ghosts.owner.numpy(),
                                  np.asarray(je.nbr.ghosts.owner))


def test_wide_deck_energy_forces_virial_on_the_same_lists(wide):
    je, _ = wide
    js, jp = je.state, je.pair
    jE, jF, jW = jp.energy_force_virial(js.x, js.type, je.nbr, js.box.h)
    pair = convert.ljcut_from_fields(
        jp._eps, jp._sig, jp._cut, jp._isset, jp.cut_global,
        cut_coul=jp.cut_coul, qqr2e=jp.qqr2e, **CPU)
    ps = convert.state_from_numpy(js)
    pair.bind_charges(ps.q)
    pair.prepare(np.asarray(js.type))
    nbr = convert.neighbor_data_from_numpy(je.nbr)
    assert nbr.lists["main"].capacity > 256
    E, F, W = pair.energy_force_virial(ps.x, ps.type, nbr, ps.box.h)
    assert abs(float(E) - float(jE)) <= TOL * abs(float(jE))
    assert rel_err(F.numpy(), jF) <= TOL
    assert rel_err(W.numpy(), jW) <= TOL
    assert float(np.abs(np.asarray(jF)).max()) > 1e-3


def test_wide_deck_mirror_forces_match_jax(wide):
    """The port's forces on its own K > 256 lists (the mirror combine the
    card runs) against JAX's on its lists."""
    je, pe = wide
    js, st = je.state, pe.state
    _, jF, _ = je.pair.energy_force_virial(js.x, js.type, je.nbr, js.box.h)
    assert pe.nbr.lists["main"].mirror is not None
    F = pe.pair.forces(st.x, st.type, pe.nbr, st.box.h)
    assert rel_err(F.numpy(), jF) <= TOL


def test_wide_deck_thermo_rows_match_jax():
    js, ps = _scripts(WIDE_SETUP + WIDE_RUN)
    assert ps.engine.nbr.lists["main"].capacity > 256
    assert len(ps.last_rows) == len(js.last_rows) == 3
    for jr, pr in zip(js.last_rows, ps.last_rows):
        assert pr["step"] == jr["step"]
        for c in ("temp", "pe", "ke", "etotal", "press"):
            j = float(jr[c])
            assert abs(pr[c] - j) <= TOL * abs(j), (c, pr["step"])


# -- REBOMOS at skin 4.0 ---------------------------------------------------

REBO_SKIN = 4.0


def _rebo_scene(pkg, dtype):
    """rebomos_bulk_commensurate(6, 8, 3) jiggled by 0.05 A (numpy seed)."""
    if pkg == "jax":
        from lammps_plugins_tpu.api.scenes import rebomos_bulk_commensurate
        st = rebomos_bulk_commensurate(nx=6, ny=8, nz=3, dtype=dtype)
        x = np.asarray(st.x)
    else:
        from lammps_plugins_tpu_torch.api.scenes import (
            rebomos_bulk_commensurate)
        st = rebomos_bulk_commensurate(6, 8, 3, dtype=dtype, device="cpu")
        x = st.x.numpy()
    x = x + np.random.default_rng(11).uniform(-0.05, 0.05, x.shape)
    return st.replace(x=jnp.asarray(x, dtype) if pkg == "jax"
                      else torch.as_tensor(x, dtype=dtype))


@pytest.fixture(scope="module")
def rebo_skin4():
    """(JAX Engine, port Engine) of the jiggled 864-atom scene at skin 4.0,
    each after its own device rebuild."""
    from lammps_plugins_tpu.core import units as jun
    from lammps_plugins_tpu.fixes.nve import FixNVE as JNVE
    from lammps_plugins_tpu.potentials.rebomos import REBOMoS as JREBO
    from lammps_plugins_tpu.run.simulation import Engine as JEngine
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    je = JEngine(_rebo_scene("jax", jnp.float64),
                 JREBO.from_file(SYNTH_REBO, ["M", "S"], dtype=jnp.float64),
                 [JNVE()], jun.METAL, skin=REBO_SKIN, device_rebuild=True)
    je.rebuild_neighbors()
    pe = Engine(_rebo_scene("port", torch.float64),
                REBOMoS.from_file(SYNTH_REBO, ["M", "S"], **CPU), [FixNVE()],
                units.METAL, skin=REBO_SKIN)
    pe.rebuild_neighbors()
    return je, pe


def test_rebomos_skin4_k_past_64_in_both(rebo_skin4):
    je, pe = rebo_skin4
    (kj, mj), (kp, mp) = _k_and_kmax(je.nbr, "rebo"), \
        _k_and_kmax(pe.nbr, "rebo")
    assert kj > 64 and kp > 64
    assert mj == mp > 64


def test_rebomos_skin4_forces_and_energy_match_jax(rebo_skin4):
    """Forces (the REBO tier at K > 64 and the LJ cell tier) against JAX's
    on its own lists, and the REBO tier's energy.  The LJ tier's energy
    is left out: its 27-offset twin sweep over the skin's 544-slot cells
    takes ~35 s on the CPU, and this tier's lists do not change with K."""
    je, pe = rebo_skin4
    js, st = je.state, pe.state
    jF = je.pair.forces(js.x, js.type, je.nbr, js.box.h)
    F = pe.pair.forces(st.x, st.type, pe.nbr, st.box.h)
    assert float(np.abs(np.asarray(jF)).max()) > 1e-3
    assert rel_err(F.numpy(), jF) <= TOL
    jp, pp = je.pair, pe.pair
    jE = jp._rebo_energy(js.x, None, jp.typemap[js.type],
                         jp.typemap[je.nbr.ghosts.all_types(js.type)],
                         je.nbr.ghosts, je.nbr.lists["rebo"], js.box.h)
    E = pp._rebo_energy(st.x, None, pp.el_of_type[st.type], pe.nbr.ghosts,
                        pe.nbr.lists["rebo"], st.box.h)
    assert abs(float(E) - float(jE)) <= TOL * abs(float(jE))


def test_rebomos_skin4_twin_matches_pallas_kernel(rebo_skin4):
    """The REBO twin (the card kernel's oracle) against the JAX Pallas
    kernel in interpret mode on the K > 64 planes, f32, 5e-4 x scale."""
    from lammps_plugins_tpu.ops.rebo_pallas import _rebo_call
    from lammps_plugins_tpu_torch.ops import rebo
    _, pe = rebo_skin4
    st, nbr, pair = pe.state, pe.nbr, pe.pair
    planes = [p.float() for p in pair._rebo_planes(
        st.x, pair.el_of_type[st.type], nbr.ghosts, nbr.lists["rebo"],
        st.box.h)]
    assert planes[0].shape[0] > 64
    dxT, dyT, dzT, jelT, mskT, ei = (p.numpy() for p in planes)
    eiT = np.zeros((8, ei.shape[0]), np.float32)
    eiT[0] = ei
    from lammps_plugins_tpu.ops.rebo_pallas import derive_rebo_constants
    g_jax = _rebo_call(*(jnp.asarray(a) for a in
                         (dxT, dyT, dzT, jelT, mskT, eiT)),
                       consts_key=tuple(sorted(derive_rebo_constants(
                           pair.tables).items())), interpret=True)
    g_port = rebo.rebo_cotangents(*planes, pair._rebo_consts)
    scale = max(np.abs(np.asarray(g)).max() for g in g_jax)
    assert scale > 1e-3
    for gp, gj in zip(g_port, g_jax):
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj),
                                   atol=5e-4 * scale, rtol=5e-4)


# -- many atom types -------------------------------------------------------

NTYPES = 21


def _mixture(pkg):
    """(state, pair) of torch_parity.mixture_arrays(NTYPES): 500 atoms,
    every type pair with its own eps, sigma and cut."""
    x, types, length, coeffs = mixture_arrays(NTYPES)
    mass = np.ones(NTYPES + 1)
    if pkg == "jax":
        from lammps_plugins_tpu.core.box import Box
        from lammps_plugins_tpu.core.state import State
        from lammps_plugins_tpu.potentials.ljcut import PairLJCut
        box = Box.orthogonal([length] * 3, dtype=jnp.float64)
        pair = PairLJCut(3.0, ntypes=NTYPES, dtype=jnp.float64)
    else:
        from lammps_plugins_tpu_torch.core.box import Box
        from lammps_plugins_tpu_torch.core.state import State
        from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCut
        box = Box.orthogonal([length] * 3, **CPU)
        pair = PairLJCut(3.0, ntypes=NTYPES, **CPU)
    for c in coeffs:
        pair.set_coeff(*c)
    pair.prepare(types)
    return State.create(x=x, type=types, box=box, mass=mass), pair


def test_many_types_rebuild_lists_equal_jax():
    """The port's device rebuild on JAX's plan: idx, jtype and mask equal
    to JAX's device_rebuild lists row by row, and the same kmax."""
    from lammps_plugins_tpu.core import units as jun
    from lammps_plugins_tpu.fixes.nve import FixNVE as JNVE
    from lammps_plugins_tpu.neighbor import device_build as jdb
    from lammps_plugins_tpu.run.simulation import Engine as JEngine
    from lammps_plugins_tpu_torch.neighbor import device_build as pdb
    jst, jpair = _mixture("jax")
    je = JEngine(jst, jpair, [JNVE()], jun.LJ, skin=0.3, device_rebuild=True)
    je.rebuild_neighbors()
    js = je.state
    h, h_inv, lo = je._box_dev
    _, _, jnbr, jflags = jdb.device_rebuild(
        je._plan, js.x, js.image, js.type, h, h_inv, lo, je._cut_mats_dev)
    _, ppair = _mixture("port")
    cut = ppair.neighbor_requests()["main"]
    assert cut.shape == (NTYPES + 1, NTYPES + 1)
    assert len(np.unique(cut[1:, 1:])) > 100      # a cut per type pair
    ps = convert.state_from_numpy(js)
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    _, _, pnbr, pflags = pdb.device_rebuild(
        convert.plan_from_fields(je._plan), ps.x, ps.image, ps.type,
        as_t(h), as_t(h_inv), as_t(lo), ppair.neighbor_requests())
    jl, pl = jnbr.lists["main"], pnbr.lists["main"]
    for f in ("idx", "jtype", "mask"):
        np.testing.assert_array_equal(getattr(pl, f).numpy(),
                                      np.asarray(getattr(jl, f)), f)
    assert int(pflags["count:k:main"]) == int(jflags["count:k:main"]) > 0
    assert len(np.unique(np.asarray(jl.jtype)[np.asarray(jl.mask)])) \
        == NTYPES


# -- the kernels' shared-memory plans --------------------------------------

def test_select_plans_size_buffers_and_slices_from_shared_memory():
    """D and D' size each warp's hit buffer from K (the next power of two
    >= max(K, 64)); D' stages bricks of cells with their neighbours, or
    reads cells too large to stage in place; past the H100's shared memory
    each raises a ValueError that names the limit.  No fixed K, W or type
    limit is left."""
    from lammps_plugins_tpu_torch.ops import select_candidates as sc
    from lammps_plugins_tpu_torch.ops import select_k as sk
    assert [sk.hit_capacity(k) for k in (1, 16, 64, 65, 336, 1424, 2048)] \
        == [64, 64, 64, 128, 512, 2048, 2048]
    assert sk.select_k_plan(2048) == (4, 2048, 4 * (8 * 2048 + 1024))
    assert sk.select_k_plan(16384)[:2] == (1, 16384)
    with pytest.raises(ValueError, match=str(sk.SMEM_LIMIT)):
        sk.select_k_plan(16385)
    # the bench rebuild: staged bricks of cells along x, 4 warps a block
    p = sc.candidates_plan(16, 24, 3)
    assert (p.warps, p.cap, p.bucket, p.staged) == (4, 64, True, True)
    # lj_melt(12) with lj/cut 7.0: ~1,424 neighbours, 528-slot cells read
    # in place
    p = sc.candidates_plan(1424, 528, 2)
    assert (p.cap, p.staged, p.bx) == (2048, False, 1)
    assert p.nbytes <= sk.SMEM_LIMIT
    assert sc.candidates_plan(64, 24, 65).staged             # 64 types
    assert not sc.candidates_plan(2048, 2000, 2).staged
    assert not sc.candidates_plan(16, 10000, 2).staged
    with pytest.raises(ValueError, match=str(sk.SMEM_LIMIT)):
        sc.candidates_plan(16385, 24, 3)
    with pytest.raises(ValueError, match=str(sk.SMEM_LIMIT)):
        sc.candidates_plan(16, 24, 241)
    for name in ("MAX_K", "MAX_W", "MAX_TYPES"):
        assert not hasattr(sk, name) and not hasattr(sc, name)


def test_rebo_plan_fits_any_k_to_the_shared_memory_limit():
    """A: all K slots staged with the atoms a block that keep the most
    warps on an SM (eight on the main path), then the planes staged in
    groups of 32-slot multiples; past that a ValueError naming the
    limit."""
    from lammps_plugins_tpu_torch.ops import rebo
    from lammps_plugins_tpu_torch.ops.select_k import SMEM_LIMIT
    assert rebo.rebo_plan(16)[:2] == (8, 16)
    assert rebo.rebo_plan(20)[:2] == (8, 20)
    for k in (33, 64, 96, 128, 256, 512, 1024, 2048):
        atoms, group, nbytes = rebo.rebo_plan(k)
        assert group == k and nbytes <= SMEM_LIMIT
        assert rebo.resident_warps(atoms, nbytes) == max(
            rebo.resident_warps(a, rebo.rebo_bytes(a, k, k))
            for a in rebo.ATOMS if rebo.rebo_bytes(a, k, k) <= SMEM_LIMIT)
    atoms, group, nbytes = rebo.rebo_plan(2688)
    assert atoms == 1 and group < 2688 and group % 32 == 0
    assert nbytes == rebo.rebo_bytes(1, 2688, group) <= SMEM_LIMIT
    with pytest.raises(ValueError, match=str(SMEM_LIMIT)):
        rebo.rebo_plan(4096)
    assert not hasattr(rebo, "MAX_K")
