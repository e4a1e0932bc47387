"""The plain reference: forces agree with finite differences of its own
energy and with the program's CPU path; the neighbour search and the
roofline's counts agree with brute force."""

import itertools
import os

import pytest
import torch

import harness as H
import roofline
from integrate import UNITS, Integrator, MDState, NoseHooverChain
from ljcut import LJCut
from neighbors import image_pairs
from rebomos import REBOMoS

PARAMS = os.path.join(H.ROOT, "mdbench", "configs", "MoS.REBO.synthetic")
F64 = dict(dtype=torch.float64, device="cpu")


def mono(nx, ny):
    return H.find("scenes", "mos2_monolayer").make(nx, ny, 20.0, "cpu")


def fcc(n):
    return H.find("scenes", "fcc_block").make(n, 0.8442, "cpu")


def jiggled(x, amp, seed):
    g = torch.Generator().manual_seed(seed)
    return x + amp * (torch.rand(x.shape, generator=g, **F64) - 0.5)


def brute_pairs(x, h, cut):
    """Every unordered image pair within cut, shifts in {-1, 0, 1}^3."""
    out = set()
    n = len(x)
    for s in itertools.product((-1, 0, 1), repeat=3):
        sv = torch.tensor(s, **F64) @ h
        d = x[None, :, :] + sv - x[:, None, :]
        r2 = (d * d).sum(-1)
        ii, jj = torch.nonzero(r2 < cut * cut, as_tuple=True)
        for i, j in zip(ii.tolist(), jj.tolist()):
            if i == j and s == (0, 0, 0):
                continue
            a = (i, j, s)
            b = (j, i, tuple(-v for v in s))
            out.add(min(a, b))
    assert n
    return out


@pytest.mark.parametrize("scene", ["mono", "fcc"])
def test_image_pairs_equal_brute_force(scene):
    if scene == "mono":
        x, _, h = mono(6, 6)
        cut = 7.0
    else:
        x, _, h = fcc(4)
        cut = 2.8
    x = jiggled(x, 0.3, 1)
    i, j, s = image_pairs(x, h, cut)
    got = {min((a, b, tuple(c)), (b, a, tuple(-v for v in c)))
           for a, b, c in zip(i.tolist(), j.tolist(), s.tolist())}
    assert len(got) == len(i)
    assert got == brute_pairs(x, h, cut)


def test_counts_equal_brute_force():
    x, types, h = mono(6, 6)
    x = jiggled(x, 0.2, 2)
    pot = REBOMoS(PARAMS, ["M", "S"])
    c = pot.counts(x, h, types, pot.pairs(x, h, types))
    el = pot.elem[types]
    n = torch.zeros(len(x), **F64)
    window = 0
    for a, b, s in brute_pairs(x, h, pot.cutoff):
        r = float(torch.linalg.norm(x[b] + torch.tensor(s, **F64) @ h - x[a]))
        ea, eb = int(el[a]), int(el[b])
        if r < float(pot.rcmax[ea, eb]):
            n[a] += 1
            n[b] += 1
        if float(pot.ljmin[ea, eb]) <= r <= float(pot.ljmax[ea, eb]):
            window += 2
    assert c["rebo_edges"] == float(n.sum())
    assert c["rebo_edge_pairs"] == float((n * (n - 1) / 2).sum())
    assert c["lj_window_pairs"] == window
    x, types, h = fcc(4)
    x = jiggled(x, 0.2, 3)
    lj = LJCut(2.5, 1.0, 1.0)
    c = lj.counts(x, h, types, lj.pairs(x, h, types, 0.3))
    assert c["ljcut_pairs"] == len(brute_pairs(x, h, 2.5))
    assert roofline.ljcut(c) > 0


@pytest.mark.parametrize("style", ["rebomos", "ljcut"])
def test_forces_are_minus_the_energy_gradient(style):
    if style == "rebomos":
        x, types, h = mono(5, 6)
        pot = REBOMoS(PARAMS, ["M", "S"])
        x = jiggled(x, 0.1, 4)
    else:
        x, types, h = fcc(3)
        pot = LJCut(2.5, 1.0, 1.0)
        x = jiggled(x, 0.1, 5)
    pairs = pot.pairs(x, h, types, 0.5)
    _, F = pot.energy_forces(x, h, types, pairs)
    eps = 1e-5
    for atom in (0, 7, 31):
        for a in range(3):
            xp, xm = x.clone(), x.clone()
            xp[atom, a] += eps
            xm[atom, a] -= eps
            ep = pot.energy_forces(xp, h, types, pairs)[0]
            em = pot.energy_forces(xm, h, types, pairs)[0]
            fd = -(ep - em) / (2 * eps)
            assert abs(float(fd) - float(F[atom, a])) <= 1e-6 * max(
                1.0, abs(float(fd)))


def test_rebomos_equals_the_programs_cpu_path_on_in_rebomos_bulk():
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS as P
    from lammps_plugins_tpu_torch.run.simulation import Engine
    st = rebomos_bulk(**F64)
    eng = Engine(st, P.from_file(PARAMS, ["M", "S"], **F64), [FixNVE()],
                 units.METAL)
    pe, _ = eng.evaluate()
    x = eng.state.x.double()
    h = torch.tensor(eng.state.box.h64, **F64)
    types = eng.state.type
    pot = REBOMoS(PARAMS, ["M", "S"])
    e, F = pot.energy_forces(x, h, types, pot.pairs(x, h, types))
    assert len(x) == 288
    assert abs(float(e) - float(pe)) <= 1e-9 * abs(float(pe))
    assert float((F - eng.state.f).abs().max()) <= 1e-9 * float(
        F.abs().max())


def test_ljcut_and_nve_equal_the_programs_cpu_path_on_a_melt():
    from lammps_plugins_tpu_torch.api.scenes import lj_melt
    deck = lj_melt(5, **F64)
    eng = deck.engine(check_every=20)
    x0 = deck.state.x.double().clone()
    v0 = deck.state.v.double().clone()
    h = torch.tensor(deck.state.box.h64, **F64)
    types = deck.state.type
    eng.run(20)
    lj = LJCut(2.5, 1.0, 1.0)
    mass = torch.tensor([0.0, 1.0], **F64)
    integ = Integrator(lj, h, types, mass, UNITS["lj"], 0.005, 0.3,
                       "every")
    s, _ = integ.follow(MDState(x=x0, v=v0), 20)
    xu = eng.state.x + eng.state.image.double() @ h
    assert float((xu - s.x).abs().max()) <= 1e-9
    assert float((eng.state.v - s.v).abs().max()) <= 1e-9
    assert float((eng.state.f - s.f).abs().max()) <= 1e-8


def test_nose_hoover_chain_equals_the_programs_fix_nvt():
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.base import StepContext
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    x, types, h = mono(4, 4)
    mass = torch.tensor([0.0, 95.95, 32.065], **F64)
    v = H.velocities(types, mass, 300.0, UNITS["metal"].boltz,
                          UNITS["metal"].mvv2e, 7, "cpu")
    st = State(x=x, v=v, f=torch.zeros_like(x), type=types,
               q=torch.zeros(len(x), **F64),
               image=torch.zeros((len(x), 3), dtype=torch.int32),
               mass=mass, box=Box.from_numpy(h.numpy(), **F64), step=0,
               extras={})
    fix = FixNVT(300.0, 300.0, 0.1)
    ctx = StepContext(units=units.METAL, dt=0.001)
    st = fix.setup(st, ctx)
    nhc = NoseHooverChain(300.0, 0.1)
    v2, ext = v * 1.1, H.find("fixes", "nvt").start({}, "cpu")
    st = st.replace(v=v2)
    for _ in range(3):
        st = fix._nhc_half_step(st, ctx)
        v2, ext = nhc.half_step(v2, mass[types], ext, 0.001, UNITS["metal"])
    chain = st.extras["nvt:nvt"]
    assert float((st.v - v2).abs().max()) <= 1e-12
    assert float((chain["eta_dot"] - ext["eta_dot"]).abs().max()) <= 1e-12
    assert float((chain["eta"] - ext["eta"]).abs().max()) <= 1e-12


@pytest.mark.parametrize("style", ["rebomos", "ljcut"])
def test_tallies_equal_the_programs_cpu_path(style):
    """compute pe/atom and stress/atom's tallies: the reference's
    half-half split against the program's on its CPU path, and the
    energies' sum against the energy."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.run.simulation import Engine
    if style == "rebomos":
        x, types, h = mono(5, 6)
        x = jiggled(x, 0.1, 6)
        pc = dict(style="rebomos", file="mdbench/configs/MoS.REBO.synthetic",
                  elements=["M", "S"])
        mass, u = [0.0, 95.95, 32.065], units.METAL
    else:
        x, types, h = fcc(3)
        x = jiggled(x, 0.1, 7)
        pc = dict(style="lj/cut", cutoff=2.5, epsilon=1.0, sigma=1.0)
        mass, u = [0.0, 1.0], units.LJ
    mod = H.find("styles", pc["style"])
    pair = mod.program(pc, H.ROOT, torch.float64, "cpu")
    n = len(x)
    st = State(x=x, v=torch.zeros_like(x), f=torch.zeros_like(x),
               type=types, q=torch.zeros(n, **F64),
               image=torch.zeros((n, 3), dtype=torch.int32),
               mass=torch.tensor(mass, **F64),
               box=Box.from_numpy(h.numpy(), **F64), step=0, extras={})
    eng = Engine(st, pair, [FixNVE()], u)
    eng.evaluate()
    s = eng.state
    eat = pair.energy_peratom(s.x, s.type, eng.nbr, s.box.h)
    vat = pair.virial_peratom(s.x, s.type, eng.nbr, s.box.h)
    pot = mod.reference(pc, H.ROOT, "cpu")
    ref = pot.evaluate(x, h, types, pot.pairs(x, h, types), tallies=True)
    assert float((eat - ref["eatom"]).abs().max()) <= 1e-9 * float(
        ref["eatom"].abs().max())
    assert float((vat - ref["vatom"]).abs().max()) <= 1e-9 * float(
        ref["vatom"].abs().max())
    assert abs(float(ref["eatom"].sum() - ref["e"])) <= 1e-9 * abs(
        float(ref["e"]))
