"""fix bfield of the port (fixes/bfield.py) against the JAX package's
(float64, CPU), and its state in the device loop.

  * the two cyclotron tests of tests/test_fixes.py (one free ion, pair
    style none, B = 10 along z, 2000 and 1000 steps of period / 2000) run
    through both packages: x and v within 1e-9 relative, and the JAX
    test's own bars;
  * the CHARGED_MELT deck of tests/test_ljcut.py (128 ions, lj/cut/coul/cut
    6/8, fix bfield 0 0 200, fix nve, thermo every 10, run 30): thermo
    rows, x, v and fsum within 1e-9 relative.  200 T is inside the
    weak-field bound (omega dt = qBm2f q/m B dt = 9.65e-5 / 22.99 * 200 *
    0.001 = 8.4e-7 for Na+, against 2 pi 0.001), so neither package warns;
    both warn alike past it;
  * a time-varying B (a callable of t, written with jnp for JAX and torch
    for the port), and region= and group_mask=, on eight free ions;
  * the fused iteration against the host loop on the CPU, bit for bit
    (x, v, f, image, the bfield extras, the rebuilds), with a constant and
    a time-varying field; a segment copies nothing from the host;
  * set-up: zero charges raise.
"""

import warnings

import numpy as np
import pytest
import torch

from torch_parity import rel_err
from test_torch_ljcut import CHARGED_MELT, port_deck

CPU = dict(dtype=torch.float64, device="cpu")
TOL = 1e-9
COLUMNS = ("temp", "press", "pe", "ke", "etotal")


def _ions(pkg, n=1, v0=0.5, seed=3):
    """(State, units) of n free ions of mass 1 and charge 1 in a 200 A box:
    one at the centre moving at v0 along x (n = 1), or n at seeded random
    places and velocities."""
    from importlib import import_module
    units = import_module(f"{pkg}.core.units")
    Box = import_module(f"{pkg}.core.box").Box
    State = import_module(f"{pkg}.core.state").State
    if n == 1:
        x, v = np.array([[100.0, 100.0, 100.0]]), np.array([[v0, 0.0, 0.0]])
    else:
        rng = np.random.default_rng(seed)
        x = rng.uniform(40.0, 160.0, (n, 3))
        v = rng.uniform(-v0, v0, (n, 3))
    q = np.ones(n)
    if pkg == "lammps_plugins_tpu":
        import jax.numpy as jnp
        box = Box.orthogonal([200.0] * 3, dtype=jnp.float64)
        st = State.create(x=jnp.asarray(x), type=np.ones(n, int), box=box,
                          mass=np.array([0.0, 1.0]), v=jnp.asarray(v),
                          q=jnp.asarray(q))
    else:
        box = Box.orthogonal([200.0] * 3, **CPU)
        st = State.create(x=x, type=np.ones(n, int), box=box,
                          mass=np.array([0.0, 1.0]), v=v, q=q)
    return st, units.METAL


def _engine(pkg, fix_kw, n=1, B=(0.0, 0.0, 10.0), check_every=100):
    from importlib import import_module
    Engine = import_module(f"{pkg}.run.simulation").Engine
    FixBfield = import_module(f"{pkg}.fixes.bfield").FixBfield
    FixNVE = import_module(f"{pkg}.fixes.nve").FixNVE
    PairNone = import_module(f"{pkg}.potentials.none").PairNone
    st, u = _ions(pkg, n)
    omega_c = u.qBm2f * 1.0 * 10.0 / 1.0
    dt = (2 * np.pi / omega_c) / 2000
    return Engine(st, PairNone(cutoff=1.0), [FixBfield(*B, **fix_kw),
                                              FixNVE()], u, dt=dt,
                  check_every=check_every)


def _final(pkg, eng):
    st = eng.state
    if pkg == "lammps_plugins_tpu":
        x = np.asarray(st.x) + np.asarray(st.image) @ st.box.h_np()
        return x, np.asarray(st.v)
    return st.box.unmap(st.x, st.image).numpy(), st.v.numpy()


@pytest.mark.parametrize("steps", [2000, 1000])
def test_cyclotron_matches_jax(steps):
    """tests/test_fixes.py's two cyclotron tests through both packages."""
    out = {}
    for pkg in ("lammps_plugins_tpu", "lammps_plugins_tpu_torch"):
        eng = _engine(pkg, {})
        eng.run(steps)
        out[pkg] = _final(pkg, eng)
    (jx, jv), (px, pv) = out.values()
    assert rel_err(px, jx) <= TOL and rel_err(pv, jv) <= TOL
    v0, period = 0.5, 2 * np.pi / (10.0 * _ions("lammps_plugins_tpu_torch")[
        1].qBm2f)
    if steps == 2000:                        # back at the start
        assert np.linalg.norm(px[0] - 100.0) < 5e-3 * v0 * period
        assert abs(pv[0, 0] - v0) < 5e-3 * v0 and abs(pv[0, 1]) < 5e-3 * v0
        assert abs(np.linalg.norm(pv[0]) - v0) < 1e-3 * v0
    else:                                    # velocity reversed
        assert abs(pv[0, 0] + 0.5) < 5e-3 and abs(pv[0, 2]) < 1e-12


def _varying(pkg):
    if pkg == "lammps_plugins_tpu":
        import jax.numpy as jnp
        return lambda t: 10.0 + 4.0 * jnp.sin(80.0 * t)
    return lambda t: 10.0 + 4.0 * torch.sin(80.0 * t)


def _block(pkg):
    from importlib import import_module
    R = import_module(f"{pkg}.core.region")
    return R.Block(lo=(-R.BIG, 60.0, -R.BIG), hi=(130.0, R.BIG, R.BIG))


@pytest.mark.parametrize("case", ["varying", "region", "group", "bx_by"])
def test_free_ions_match_jax(case):
    """Eight free ions, 600 steps (check every 100): a time-varying Bz, a
    region, a group mask, and a field with every component set."""
    out, vecs = {}, {}
    for pkg in ("lammps_plugins_tpu", "lammps_plugins_tpu_torch"):
        B, kw = (0.0, 0.0, 10.0), {}
        if case == "varying":
            B = (3.0, 0.0, _varying(pkg))
        elif case == "region":
            kw = dict(region=_block(pkg))
        elif case == "group":
            gm = np.arange(8) % 2 == 0
            kw = dict(group_mask=gm if pkg.endswith("torch")
                      else __import__("jax.numpy").numpy.asarray(gm))
        else:
            B = (4.0, -6.0, 10.0)
        eng = _engine(pkg, kw, n=8, B=B)
        eng.run(600)
        out[pkg] = _final(pkg, eng)
        fix = eng.fixes[0]
        vecs[pkg] = (np.asarray(fix.vector(eng.state)),
                     float(fix.energy(eng.state, eng.ctx)),
                     np.asarray(eng.state.extras[fix.key]["B"]))
    (jx, jv), (px, pv) = out.values()
    assert rel_err(px, jx) <= TOL and rel_err(pv, jv) <= TOL
    (jvec, je, jB), (pvec, pe, pB) = vecs.values()
    assert rel_err(pvec, jvec) <= TOL and abs(pe - je) <= TOL * abs(je)
    assert rel_err(pB, jB) <= TOL
    if case == "varying":
        assert float(pB[2]) != 10.0


def _weak_field_warnings(record):
    return [w for w in record if "weak-field" in str(w.message)]


@pytest.fixture(scope="module")
def charged_runs():
    """The CHARGED_MELT deck, 30 steps, thermo every 10, in both packages;
    neither warns about the 200 T field."""
    from lammps_plugins_tpu.api.script import Script
    from lammps_plugins_tpu_torch.api.scenes import charged_melt
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        s = Script()
        s.run_text(CHARGED_MELT + "thermo 10\nrun 30\n")
        eng = charged_melt(4, **CPU).engine()
    assert _weak_field_warnings(record) == []
    rows = eng.run(30, thermo_every=10)
    return s, eng, rows


@pytest.mark.parametrize("bz", [200.0, 2.0e6])
def test_weak_field_warning_matches_jax(bz):
    """Both packages warn past omega dt = 2 pi 0.001 (Na+ at dt 0.001 ps:
    B > 1.5e6 T) and not inside it."""
    from lammps_plugins_tpu.api.script import Script
    from lammps_plugins_tpu_torch.api.scenes import charged_melt
    warned = []
    for make in (lambda: Script().run_text(CHARGED_MELT.replace(
            "0.0 0.0 200.0", f"0.0 0.0 {bz}") + "run 0\n"),
                 lambda: charged_melt(4, bz=bz, **CPU).engine()):
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            make()
        warned.append(len(_weak_field_warnings(record)))
    assert warned == ([1, 1] if bz > 1e6 else [0, 0])


@pytest.mark.parametrize("column", COLUMNS)
def test_charged_melt_thermo_rows_match_jax(charged_runs, column):
    s, _, rows = charged_runs
    jrows = s.engine.thermo_rows
    assert [r["step"] for r in rows] == [int(r["step"]) for r in jrows] \
        == [0, 10, 20, 30]
    for pr, jr in zip(rows, jrows):
        j = float(jr[column])
        assert abs(pr[column] - j) <= TOL * abs(j), (column, pr["step"])


def test_charged_melt_state_and_fsum_match_jax(charged_runs):
    s, eng, _ = charged_runs
    js, ps = s.engine.state, eng.state
    jx = np.asarray(js.x) + np.asarray(js.image) @ js.box.h_np()
    assert rel_err(ps.box.unmap(ps.x, ps.image).numpy(), jx) <= TOL
    assert rel_err(ps.v.numpy(), js.v) <= TOL
    jf = np.asarray(js.extras["bfield:B"]["fsum"])
    pf = ps.extras["bfield:bfield"]["fsum"].numpy()
    assert rel_err(pf, jf) <= TOL and np.abs(pf[1:]).max() > 0


def test_zero_charges_raise():
    from lammps_plugins_tpu_torch.fixes.bfield import FixBfield
    from lammps_plugins_tpu_torch.fixes.base import StepContext
    st, u = _ions("lammps_plugins_tpu_torch", n=4)
    with pytest.raises(ValueError, match="charge"):
        FixBfield(0.0, 0.0, 1.0).setup(st.replace(q=torch.zeros(4, **CPU)),
                                       StepContext(units=u, dt=u.dt))


def _melt_engine(varying):
    deck = port_deck("charged", bz=2.0)
    if varying:
        deck.fixes[0] = type(deck.fixes[0])(
            0.5, 0.0, lambda t: 2.0 + torch.cos(500.0 * t),
            region=_block("lammps_plugins_tpu_torch"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return deck.engine()


@pytest.mark.parametrize("varying", [False, True])
def test_fused_iteration_equals_host_loop_bit_for_bit(varying):
    engines = {}
    for fused in (True, False):
        eng = _melt_engine(varying)
        eng.fused_loop = fused
        eng.run(40)
        engines[fused] = eng
    f, h = engines[True], engines[False]
    assert f.state.step == h.state.step == 40 and f.rebuilds == h.rebuilds
    for a in ("x", "v", "f", "image"):
        assert torch.equal(getattr(f.state, a), getattr(h.state, a)), a
    fe, he = (e.state.extras["bfield:bfield"] for e in (f, h))
    assert sorted(fe) == sorted(he) == sorted(
        ["v0", "B", "fsum"] + (["step"] if varying else []))
    for k in fe:
        assert torch.equal(fe[k], he[k]), k
    if varying:
        assert int(fe["step"]) == 40
        assert float(fe["B"][2]) != 2.0


_SPIED = [(torch, "tensor"), (torch, "as_tensor"), (torch.Tensor, "cpu"),
          (torch.Tensor, "item"), (torch.Tensor, "tolist"),
          (torch.Tensor, "__float__"), (torch.Tensor, "__int__"),
          (torch.Tensor, "__bool__")]


@pytest.mark.parametrize("varying", [False, True])
def test_rebuild_and_bfield_segment_copy_nothing_from_the_host(varying):
    eng = _melt_engine(varying)
    eng.fused_loop = True
    eng.run(10)
    loop = eng._device_loop()
    eng.state = loop.start(eng.state, eng.nbr, True, 0.0)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for owner, name in _SPIED:
            real = getattr(owner, name)

            def spy(*a, _real=real, _name=name, **k):
                if _name == "as_tensor" and a and torch.is_tensor(a[0]):
                    return _real(*a, **k)      # a tensor already: no copy
                calls.append(_name)
                return _real(*a, **k)

            mp.setattr(owner, name, spy)
        loop._rebuild()
        loop._segment()
    assert calls == []
    assert int(loop.n_rb) == 1 and int(loop.done) == 10
