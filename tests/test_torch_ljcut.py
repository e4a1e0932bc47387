"""pair_style lj/cut and lj/cut/coul/cut, pair_style none, fix nve with
a group, and the LJ decks' scenes of the port against the JAX package
(float64, CPU).

  * coefficients: geometric mixing of unset pairs, the missing-coefficient
    and unbound-charge errors, closed-form dimers;
  * energy, forces and the strain virial against JAX on the same lists
    (the JAX device rebuild's, through convert.py), 1e-9 relative, for the
    jiggled 256-atom LJ melt and the 128-ion charged melt;
  * the port's mirror-combine forces on its own rebuild's lists: against
    its plain autograd on the same lists (1e-12) and against JAX's forces
    on JAX's lists (1e-9);
  * lj_melt(4) and charged_melt(4) against the JAX Script's state of the
    tests/test_ljcut.py decks before their run: x, type, q, mass and v
    exact;
  * a 20-step NVE run of the LJ melt with FixNVE(group_mask=) against JAX
    (x, v and thermo rows, 1e-9), and pair_style none's shapes.
"""

import warnings

import numpy as np
import pytest
import torch

from lammps_plugins_tpu_torch import convert
from lammps_plugins_tpu_torch.potentials.base import PairStyle
from torch_parity import rel_err

CPU = dict(dtype=torch.float64, device="cpu")
TOL = 1e-9

LJ_MELT = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 4 0 4 0 4
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
fix             1 all nve
"""

CHARGED_MELT = """
units           metal
atom_style      charge
lattice         bcc 4.2
region          box block 0 4 0 4 0 4
create_box      2 box
create_atoms    1 box
set             group all type/fraction 2 0.5 777
set             type 1 charge 1.0
set             type 2 charge -1.0
mass            1 22.99
mass            2 35.45
velocity        all create 300.0 4928459
pair_style      lj/cut/coul/cut 6.0 8.0
pair_coeff      1 1 0.01 2.5
pair_coeff      2 2 0.01 3.4
neighbor        1.0 bin
fix             B all bfield 0.0 0.0 200.0
fix             1 all nve
"""

DECKS = {"lj": LJ_MELT, "charged": CHARGED_MELT}


def jax_deck_engine(name):
    """The JAX Script's Engine of the deck, made before any run (the
    velocities applied, the fixes set up; no lists yet)."""
    from lammps_plugins_tpu.api.script import Script
    s = Script()
    s.run_text(DECKS[name])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the deck's 200 T field
        return s._make_engine()


def port_deck(name, n=4, **kw):
    from lammps_plugins_tpu_torch.api.scenes import charged_melt, lj_melt
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (lj_melt(n, **CPU) if name == "lj"
                else charged_melt(n, **CPU, **kw))


@pytest.mark.parametrize("name", ["lj", "charged"])
def test_scene_matches_the_jax_script_deck(name):
    js = jax_deck_engine(name).state
    ps = port_deck(name).state
    assert ps.natoms == (256 if name == "lj" else 128)
    for field in ("x", "type", "q", "mass", "v"):
        np.testing.assert_array_equal(getattr(ps, field).numpy(),
                                      np.asarray(getattr(js, field)), field)
    np.testing.assert_array_equal(ps.box.h_np(), js.box.h_np())
    if name == "charged":
        q, t = ps.q.numpy(), ps.type.numpy()
        assert set(np.unique(q)) == {1.0, -1.0}
        assert np.all(q[t == 1] == 1.0) and np.all(q[t == 2] == -1.0)


# -- coefficients ---------------------------------------------------------

def _pair(pkg, charged=False, ntypes=3):
    if pkg == "jax":
        from lammps_plugins_tpu.potentials.ljcut import (PairLJCut,
                                                         PairLJCutCoulCut)
        kw = {}
    else:
        from lammps_plugins_tpu_torch.potentials.ljcut import (
            PairLJCut, PairLJCutCoulCut)
        kw = CPU
    if charged:
        return PairLJCutCoulCut(5.0, 7.5, ntypes=ntypes, qqr2e=14.399645,
                                **kw)
    return PairLJCut(5.0, ntypes=ntypes, **kw)


def test_geometric_mixing_matches_jax():
    pairs = {}
    for pkg in ("jax", "port"):
        p = _pair(pkg)
        p.set_coeff(1, 1, 0.5, 1.0)
        p.set_coeff(2, 2, 2.0, 4.0, 6.5)
        p.set_coeff(3, 3, 0.3, 2.2)
        p.set_coeff(1, 3, 0.9, 1.7, 4.0)        # set: not mixed
        pairs[pkg] = p
    jreq = pairs["jax"].neighbor_requests()["main"]
    preq = pairs["port"].neighbor_requests()["main"]
    np.testing.assert_array_equal(preq, jreq)
    for f in ("_eps", "_sig", "_cut", "_isset"):
        np.testing.assert_array_equal(getattr(pairs["port"], f),
                                      getattr(pairs["jax"], f), f)
    assert pairs["port"]._eps[1, 2] == np.sqrt(0.5 * 2.0)
    assert pairs["port"]._cut[1, 2] == 6.5
    for a, b in zip(pairs["port"]._tables(), pairs["jax"]._tables()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_missing_coefficient_raises():
    p = _pair("port", ntypes=2)
    p.set_coeff(1, 1, 0.5, 1.0)             # no 2-2 and no 1-2
    with pytest.raises(ValueError, match="pair_coeff missing"):
        p.neighbor_requests()


def _dimer(pair, r, types=(1, 1), q=None):
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.neighbor.build import build_neighbor_data
    box = Box.triclinic(30.0, 31.0, 32.0, **CPU)
    x = torch.tensor([[5.0, 5.0, 5.0], [5.0 + r, 5.0, 5.0]],
                     dtype=torch.float64)
    t = torch.tensor(types)
    if q is not None:
        pair.bind_charges(torch.tensor(q, dtype=torch.float64))
    pair.prepare(t.numpy())
    nbr = build_neighbor_data(x.numpy(), t.numpy(), box,
                              pair.neighbor_requests(), skin=1.0, **CPU)
    return pair.energy_force_virial(x, t, nbr, box.h)


def test_unbound_charges_raise():
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCutCoulCut
    p = PairLJCutCoulCut(3.0, ntypes=1, qqr2e=1.0, **CPU)
    p.set_coeff(1, 1, 0.1, 1.0)
    with pytest.raises(ValueError, match="charge"):
        _dimer(p, 2.0)


@pytest.mark.parametrize("case", ["lj", "truncated", "mixed", "coul"])
def test_dimer_closed_forms(case):
    from lammps_plugins_tpu_torch.potentials.ljcut import (PairLJCut,
                                                           PairLJCutCoulCut)
    qq = 14.399645
    if case == "coul":
        p = PairLJCutCoulCut(3.0, 8.0, ntypes=1, qqr2e=qq, **CPU)
        p.set_coeff(1, 1, 0.0, 1.0)
        r = 4.0
        E, F, _ = _dimer(p, r, q=[1.0, -2.0])
        e_ref, dedr = qq * -2.0 / r, -qq * -2.0 / r ** 2
    elif case == "mixed":
        p = PairLJCut(5.0, ntypes=2, **CPU)
        p.set_coeff(1, 1, 0.5, 1.0)
        p.set_coeff(2, 2, 2.0, 4.0)
        r, eps, sig = 2.0, np.sqrt(1.0), np.sqrt(4.0)
        E, F, _ = _dimer(p, r, types=(1, 2))
        e_ref = 4 * eps * ((sig / r) ** 12 - (sig / r) ** 6)
        dedr = 4 * eps * (-12 * sig ** 12 / r ** 13 + 6 * sig ** 6 / r ** 7)
    else:
        p = PairLJCut(3.0, ntypes=1, **CPU)
        p.set_coeff(1, 1, 0.7, 1.1)
        r = 1.3 if case == "lj" else 3.4     # 3.4: past the cut, in the skin
        E, F, W = _dimer(p, r)
        live = case == "lj"
        e_ref = live * 4 * 0.7 * ((1.1 / r) ** 12 - (1.1 / r) ** 6)
        dedr = live * 4 * 0.7 * (-12 * 1.1 ** 12 / r ** 13
                                 + 6 * 1.1 ** 6 / r ** 7)
        assert abs(float(torch.trace(W)) + r * dedr) <= 1e-10 * max(
            abs(r * dedr), 1e-300)
    assert abs(float(E) - e_ref) <= 1e-12 * max(abs(e_ref), 1e-300)
    np.testing.assert_allclose(F.numpy()[1], [-dedr, 0.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(F.numpy()[0], [dedr, 0.0, 0.0], atol=1e-12)


# -- energy, forces, virial against JAX ------------------------------------

def _jiggled(name, jiggle=0.05, seed=5):
    """(JAX Engine after a device rebuild, port Engine after its own device
    rebuild) of the deck's scene, every atom displaced uniformly in
    [-jiggle, jiggle] (numpy seed)."""
    import jax.numpy as jnp
    je = jax_deck_engine(name)
    x = np.asarray(je.state.x) + np.random.default_rng(seed).uniform(
        -jiggle, jiggle, je.state.x.shape)
    je.state = je.state.replace(x=jnp.asarray(x))
    je.device_rebuild = True
    je.rebuild_neighbors()
    deck = port_deck(name)
    pe = deck.engine()
    pe.state = pe.state.replace(x=torch.as_tensor(x))
    pe.rebuild_neighbors()
    return je, pe


@pytest.fixture(scope="module", params=["lj", "charged"])
def both(request):
    je, pe = _jiggled(request.param)
    jp = je.pair
    pair = convert.ljcut_from_fields(
        jp._eps, jp._sig, jp._cut, jp._isset, jp.cut_global,
        cut_coul=getattr(jp, "cut_coul", None),
        qqr2e=getattr(jp, "qqr2e", 1.0), **CPU)
    pair.bind_charges(convert.state_from_numpy(je.state).q)
    pair.prepare(np.asarray(je.state.type))
    return request.param, je, pe, pair


def test_energy_forces_virial_match_jax_on_the_same_lists(both):
    _, je, _, pair = both
    js = je.state
    jE, jF, jW = je.pair.energy_force_virial(js.x, js.type, je.nbr, js.box.h)
    ps = convert.state_from_numpy(js)
    nbr = convert.neighbor_data_from_numpy(je.nbr)
    assert nbr.lists["main"].mirror is None      # plain autograd on the CPU
    E, F, W = pair.energy_force_virial(ps.x, ps.type, nbr, ps.box.h)
    assert abs(float(E) - float(jE)) <= TOL * abs(float(jE))
    assert rel_err(F.numpy(), jF) <= TOL
    assert rel_err(W.numpy(), jW) <= TOL
    assert float(np.abs(np.asarray(jF)).max()) > 1e-3


def test_mirror_combine_forces_equal_plain_autograd(both):
    _, _, pe, _ = both
    st, nbr = pe.state, pe.nbr
    assert nbr.lists["main"].mirror is not None
    f_mirror = pe.pair.forces(st.x, st.type, nbr, st.box.h)
    f_auto = PairStyle.forces(pe.pair, st.x, st.type, nbr, st.box.h)
    assert rel_err(f_mirror.numpy(), f_auto.numpy()) <= 1e-12


def test_mirror_combine_forces_match_jax(both):
    _, je, pe, _ = both
    js = je.state
    _, jF, _ = je.pair.energy_force_virial(js.x, js.type, je.nbr, js.box.h)
    st = pe.state
    F = pe.pair.forces(st.x, st.type, pe.nbr, st.box.h)
    assert rel_err(F.numpy(), jF) <= TOL
    E, W = pe.pair.energy_virial(st.x, st.type, pe.nbr, st.box.h)
    jE, jW = je.pair.energy_virial(js.x, js.type, je.nbr, js.box.h)
    assert abs(float(E) - float(jE)) <= TOL * abs(float(jE))
    assert rel_err(W.numpy(), jW) <= TOL


def test_charges_bound_by_the_engine(both):
    name, _, pe, _ = both
    if name == "lj":
        assert not pe.pair.needs_charges
        return
    assert pe.pair.needs_charges
    assert torch.equal(pe.pair._q, pe.state.q)
    view = pe.pair.with_charges(torch.zeros_like(pe.state.q))
    st = pe.state
    e0 = view.energy(st.x, None, st.type, pe.nbr, st.box.h)
    e1 = pe.pair.energy(st.x, None, st.type, pe.nbr, st.box.h)
    assert abs(float(e1) - float(e0)) > 1.0       # the Coulomb term counts


# -- NVE with a group; pair_style none -----------------------------------

def _half(n):
    return np.arange(n) % 3 != 0


@pytest.mark.parametrize("group", [False, True])
def test_nve_group_run_matches_jax(group):
    """20 steps of the jiggled LJ melt (thermo every 10); with a group,
    only two atoms in three move."""
    import jax.numpy as jnp
    from lammps_plugins_tpu.fixes.nve import FixNVE as JNVE
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    je, pe = _jiggled("lj", seed=9)
    n = pe.state.natoms
    gm = _half(n) if group else None
    je.fixes = [JNVE(group_mask=None if gm is None else jnp.asarray(gm))]
    pe.fixes = [FixNVE(group_mask=gm)]
    jrows = je.run(20, thermo_every=10)
    prows = pe.run(20, thermo_every=10)
    for jr, pr in zip(jrows, prows):
        for c in ("temp", "pe", "ke", "etotal", "press"):
            j = float(jr[c])
            assert abs(pr[c] - j) <= TOL * abs(j), (c, pr["step"])
    js, ps = je.state, pe.state
    jx = np.asarray(js.x) + np.asarray(js.image) @ js.box.h_np()
    assert rel_err(ps.box.unmap(ps.x, ps.image).numpy(), jx) <= TOL
    assert rel_err(ps.v.numpy(), js.v) <= TOL
    if group:
        v0 = port_deck("lj").state.v.numpy()
        assert np.array_equal(ps.v.numpy()[~gm], v0[~gm])


def test_pair_none_shapes_and_registry():
    from lammps_plugins_tpu_torch.potentials.none import PairNone
    from lammps_plugins_tpu_torch.registry import PAIR_STYLES
    assert PAIR_STYLES["none"] is PairNone and PAIR_STYLES["zero"] is PairNone
    deck = port_deck("lj")
    eng = deck.engine()
    eng.pair = PairNone(1.5)
    eng.pair.prepare(deck.state.type.numpy())
    assert eng.pair.neighbor_requests()["main"].shape == (2, 2)
    eng.rebuild_neighbors()
    st = eng.state
    E, F, W = eng.pair.energy_force_virial(st.x, st.type, eng.nbr, st.box.h)
    assert float(E) == 0.0 and F.shape == st.x.shape and W.shape == (3, 3)
    assert not F.any() and not W.any()
    assert not eng.pair.forces(st.x, st.type, eng.nbr, st.box.h).any()


# -- kernel I's row-local sum (ops/ljcut.py) on the host -------------------

#: the scenes of the row-local checks: (kind, n) of torch_parity.ljcut_scene
ROW_LOCAL = {"lj": 4, "charged": 4, "mixture": 3}


def _row_local_case(kind, lists):
    """(pair, x, types, nbr, h) of ROW_LOCAL[kind] in float64 on the CPU,
    on the host build's lists (no mirror table) or on the device
    rebuild's (with one)."""
    from lammps_plugins_tpu_torch.neighbor.build import build_neighbor_data
    from torch_parity import ljcut_scene
    eng = ljcut_scene(kind, ROW_LOCAL[kind])
    if lists == "device":
        eng.rebuild_neighbors()
        st, nbr = eng.state, eng.nbr
        assert nbr.lists["main"].mirror is not None
    else:
        st = eng.state
        nbr = build_neighbor_data(st.x.numpy(), st.type.numpy(), st.box,
                                  eng.pair.neighbor_requests(), skin=eng.skin,
                                  **CPU)
        assert nbr.lists["main"].mirror is None
    return eng.pair, st.x, st.type, nbr, st.box.h


@pytest.mark.parametrize("lists", ["host", "device"])
@pytest.mark.parametrize("kind", sorted(ROW_LOCAL))
def test_row_local_twin_equals_forces(kind, lists):
    """The twin of kernel I (each atom's force from its own row alone)
    equals forces() in float64: plain autograd on the host build's lists,
    the mirror combine on the device rebuild's; lj/cut, lj/cut/coul/cut
    and a 21-type mixture with a cut per type pair."""
    from lammps_plugins_tpu_torch.ops import ljcut
    pair, x, types, nbr, h = _row_local_case(kind, lists)
    f = pair.forces(x, types, nbr, h)
    args, kw = pair.kernel_inputs(x, types, nbr, h)
    assert ("q" in kw) == (kind == "charged")
    f_row = ljcut.ljcut_forces_ref(*args, **kw)
    assert float(f.abs().max()) > 1e-2
    assert rel_err(f_row.numpy(), f.numpy()) <= 1e-12


def test_ljcut_wrapper_takes_the_twin_on_the_cpu():
    """ops.ljcut.ljcut_forces on CPU tensors is its twin, bit for bit and
    without a launch, in float64 and float32; a coefficient table that is
    no T*T square and an unsupported device raise."""
    from lammps_plugins_tpu_torch.ops import ljcut
    pair, x, types, nbr, h = _row_local_case("charged", "device")
    args, kw = pair.kernel_inputs(x, types, nbr, h)
    before = ljcut.launches
    assert torch.equal(ljcut.ljcut_forces(*args, **kw),
                       ljcut.ljcut_forces_ref(*args, **kw))
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    kw32 = dict(kw, q=kw["q"].float())
    out32 = ljcut.ljcut_forces(*f32, **kw32)
    assert out32.dtype == torch.float32
    assert torch.equal(out32, ljcut.ljcut_forces_ref(*f32, **kw32))
    assert ljcut.launches == before
    with pytest.raises(ValueError, match="T\\*T"):
        ljcut.ljcut_forces(*args[:7], args[7][:-1], *args[8:], **kw)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        ljcut.ljcut_forces(*meta)


@pytest.mark.parametrize("style", ["lj", "coul"])
def test_row_local_twin_dimer_across_the_boundary(style):
    """Two atoms 0.5 and 9.7 along x in a periodic box 10.8 wide meet only
    through a ghost image, r = 1.6: the twin's forces are -dE/dr of the
    closed form along -x and +x, 1e-12 (lj/cut 3.0 eps 0.7 sigma 1.1;
    coul: charges 1 and -2, qqr2e 14.4, eps 0)."""
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.neighbor.build import build_neighbor_data
    from lammps_plugins_tpu_torch.ops import ljcut
    from lammps_plugins_tpu_torch.potentials.ljcut import (PairLJCut,
                                                           PairLJCutCoulCut)
    r, qq = 1.6, 14.4
    if style == "coul":
        pair = PairLJCutCoulCut(3.0, 3.0, ntypes=1, qqr2e=qq, **CPU)
        pair.set_coeff(1, 1, 0.0, 1.1)
        pair.bind_charges(torch.tensor([1.0, -2.0], dtype=torch.float64))
        dedr = -qq * -2.0 / r ** 2
    else:
        pair = PairLJCut(3.0, ntypes=1, **CPU)
        pair.set_coeff(1, 1, 0.7, 1.1)
        dedr = 4 * 0.7 * (-12 * 1.1 ** 12 / r ** 13 + 6 * 1.1 ** 6 / r ** 7)
    box = Box.triclinic(10.8, 9.0, 9.0, **CPU)
    x = torch.tensor([[0.5, 4.0, 4.0], [9.7, 4.0, 4.0]],
                     dtype=torch.float64)
    t = torch.tensor([1, 1])
    nbr = build_neighbor_data(x.numpy(), t.numpy(), box,
                              pair.neighbor_requests(), skin=0.5, **CPU)
    nl = nbr.lists["main"]
    assert bool((nl.idx[nl.mask] >= 2).all())      # only the ghost images
    args, kw = pair.kernel_inputs(x, t, nbr, box.h)
    f = ljcut.ljcut_forces_ref(*args, **kw).numpy()
    np.testing.assert_allclose(f[0], [-dedr, 0.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(f[1], [dedr, 0.0, 0.0], atol=1e-12)


def test_ljcut_ops_module_imports_without_cuda():
    """ops/ljcut.py imports with no card visible, builds and loads no
    kernel library, and its forces run on the CPU (the twin)."""
    import os
    import subprocess
    import sys
    code = (
        "import sys, torch\n"
        "from lammps_plugins_tpu_torch.ops import build, ljcut\n"
        "assert not torch.cuda.is_available()\n"
        "x = torch.tensor([[0.0, 0.0, 0.0], [1.1, 0.0, 0.0]])\n"
        "idx = torch.tensor([[1], [0]]); mask = torch.ones(2, 1, dtype=bool)\n"
        "tab = lambda v: torch.full((4,), v)\n"
        "f = ljcut.ljcut_forces(x, torch.ones(2, dtype=torch.int64),\n"
        "    torch.zeros(0, dtype=torch.int64), torch.zeros(0, 3),\n"
        "    torch.eye(3), idx, mask, tab(4.0), tab(4.0), tab(6.25))\n"
        "assert f[0, 0] < 0 < f[1, 0] and f[0, 0] == -f[1, 0]\n"
        "assert build._lib is None and ljcut.launches == 0\n"
        "assert 'triton' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
