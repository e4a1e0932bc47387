"""The port's input-script interpreter (api/script.py) against the JAX
package's, float64 on the CPU: the same deck text through both Scripts.

Every run's thermo rows (temp, press, pe, ke, etotal, the pressure
tensor) are held to 1e-9 relative to each column's scale (a ramped NVT
run to 3e-8: the JAX fix forms its ramp in float32, ROADMAP C11), and
every printed column, c_, f_ and v_ columns included, to its 8 printed
digits.  The decks: in.rebomos-bulk (20 steps, synthetic parameters),
sample.in at block 0 4 0 4 0 4 (synthetic AEAM), LJ_MELT and
CHARGED_MELT of tests/test_ljcut.py, the time-varying-Bz and
`pair_style none` cyclotron decks of tests/test_equalvar.py, a group
with a group-scoped fix nve, fix langevin with a ramp over two runs,
FIRE minimize from a data file, compute msd and v_ columns, and a
ramped fix nvt over two runs (the window re-anchored by each run).  Plus
`plugin load` of a port style, the port's ScriptErrors (as JAX's), the
card default of Script and its n_devices / devices arguments (the
sharded decks themselves: tests/test_torch_sharded_script.py).
"""

import math
import warnings

import numpy as np
import pytest
import torch

from torch_parity import SYNTH_AEAM, SYNTH_REBO

KEYS = ("temp", "press", "pe", "ke", "etotal", "pxx", "pyy", "pzz", "pxy",
        "pxz", "pyz")

REBO_DECK = """
units           metal
atom_style      atomic
boundary        p p p
lattice custom 1.0 a1 3.1903157234 0.0 0.0 a2 -1.5964590311 2.7651481541 0.0 &
        a3 0.0 0.0 13.9827680588 &
        basis 0.0 0.0 $(3.0/4.0) basis 0.0 0.0 $(1.0/4.0) &
        basis $(2.0/3.0) $(1.0/3.0) 0.862008989 &
        basis $(1.0/3.0) $(2.0/3.0) 0.137990996 &
        basis $(1.0/3.0) $(2.0/3.0) 0.362008989 &
        basis $(2.0/3.0) $(1.0/3.0) 0.637991011 origin 0.1 0.1 0.1
region          box prism 0 4 0 8 0 1 -2.0 0 0
create_box      2 box
create_atoms    1 box basis 1 1 basis 2 1 basis 3 2 basis 4 2 basis 5 2 basis 6 2
mass            1 95.95
mass            2 32.065
pair_style      rebomos
pair_coeff      * * {rebo} M S
thermo          10
fix             1 all nve
run             20
""".replace("{rebo}", SYNTH_REBO)

SAMPLE_DECK = """
units           metal
atom_style      atomic
boundary        p p p
lattice         fcc 4.045
region          box block 0 4 0 4 0 4
create_box      2 box
create_atoms    1 box
set             group all type/fraction 2 0.05 7683797
mass            1 27.0
mass            2 28.0
pair_style      aeam
pair_coeff      * * {aeam} Al Si
velocity        all create 863.0 4928459
neighbor        1.2 bin
timestep        0.001
fix             1 all nvt temp 863.0 863.0 0.1
thermo_style    custom step temp pe ke etotal press f_1
thermo          6
run             24
""".replace("{aeam}", SYNTH_AEAM)

LJ_SETUP = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 4 0 4 0 4
create_box      1 box
create_atoms    1 box
mass            1 1.0
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
"""


def _bz_deck():
    from test_equalvar import BZ_DECK
    from lammps_plugins_tpu_torch.core import units
    omega0 = units.METAL.qBm2f * 10.0
    dt = 2 * math.pi / omega0 / 2000.0
    deck = BZ_DECK.format(dt=dt, b0=10.0, tper=1600 * dt)
    deck = deck.replace("run 400\nrun 400", "thermo_style custom step temp "
                        "ke etotal f_1 f_1[1] f_1[2] f_1[3]\nthermo 100\n"
                        "run 200\nrun 200")
    return deck


def _none_deck():
    deck = _bz_deck()
    deck = deck.replace("fix 1 all bfield 0 0 v_bz", "fix 1 all bfield 0 0 "
                        "10.0")
    return deck.replace("run 200\nrun 200", "run 500")


def _decks():
    from test_ljcut import CHARGED_MELT, LJ_MELT
    return {
        "rebomos": REBO_DECK,
        "sample": SAMPLE_DECK,
        "lj_melt": LJ_MELT,
        "charged_melt": CHARGED_MELT,
        "bz_variable": _bz_deck(),
        "none_cyclotron": _none_deck(),
        "group_nve": LJ_SETUP + """
velocity        all create 1.44 87287
region          left block 0 2 INF INF INF INF
group           mobile region left
fix             1 mobile nve
thermo          10
run             30
""",
        "langevin": LJ_SETUP + """
fix             1 all nve
fix             2 all langevin 0.1 1.5 0.5 48279
thermo          10
run             30
run             20
""",
        "msd_vcols": LJ_SETUP + """
velocity        all create 1.44 87287
fix             1 all nve
compute         2 all msd
variable        e2 equal etotal*2+step
variable        pv equal press*vol
thermo_style    custom step temp c_2[1] c_2[2] c_2[3] c_2[4] v_e2 v_pv
thermo          10
run             40
""",
        "nvt_ramp": SAMPLE_DECK.replace("863.0 863.0 0.1", "863.0 1000.0 "
                                        "0.1").replace("run             24",
                                                       "run 12\nrun 12"),
    }


def run_deck(pkg, text, tmp_path=None):
    """(Script, rows of every run, printed thermo rows as floats)."""
    if pkg == "jax":
        from lammps_plugins_tpu.api.script import Script
        s = Script(log=lambda _: None)
    else:
        from lammps_plugins_tpu_torch.api.script import Script
        s = Script(log=lambda _: None, dtype=torch.float64, device="cpu")
    printed, rows = [], []
    s.log = printed.append
    run = s.cmd_run
    s.cmd_run = lambda args: rows.extend(run(args))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.run_text(text)
    table = [[float(v) for v in ln.split()] for ln in printed
             if ln.startswith("   ") and ln.split()[0].lstrip("-").isdigit()]
    return s, rows, np.array(table)


def _close(a, b, tol, groups=()):
    """(all |a - b| <= tol * scale, max |a - b| per column): a value that
    is not finite (the temperature of one atom, which has no degree of
    freedom) must be the same in both; a column's scale is its max |b|
    over finite values, shared by the columns of each group in `groups`
    (the pressure tensor's)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    odd = ~np.isfinite(a) | ~np.isfinite(b)
    np.testing.assert_array_equal(a[odd], b[odd])
    scale = np.where(odd, 0.0, np.abs(b)).max(axis=0)
    for g in groups:
        scale[list(g)] = scale[list(g)].max()
    d = np.abs(np.where(odd, 0.0, a) - np.where(odd, 0.0, b))
    return np.all(d <= tol * np.maximum(scale, 1e-300)), d.max(axis=0)


@pytest.mark.parametrize("name", ["rebomos", "sample", "lj_melt",
                                  "charged_melt", "bz_variable",
                                  "none_cyclotron", "group_nve", "langevin",
                                  "msd_vcols", "nvt_ramp"])
def test_deck_thermo_matches_jax(name):
    text = _decks()[name]
    js, jrows, jtab = run_deck("jax", text)
    ps, prows, ptab = run_deck("port", text)
    assert len(prows) == len(jrows) > 1
    assert [r["step"] for r in prows] == [r["step"] for r in jrows]
    tol = 3e-8 if name == "nvt_ramp" else 1e-9
    ok, err = _close([[r[k] for k in KEYS] for r in prows],
                     [[r[k] for k in KEYS] for r in jrows], tol,
                     groups=[range(5, 11)])
    assert ok, dict(zip(KEYS, err))
    # 8 printed digits; the ramped run's pressure, a difference of large
    # terms, carries its 3e-8 to the 7th digit
    ok, err = _close(ptab, jtab, 1e-6 if name == "nvt_ramp" else 1.5e-7)
    assert ok, err
    if name in ("bz_variable", "none_cyclotron", "charged_melt"):
        key = [k for k in ps.engine.state.extras if k.startswith("bfield")]
        jf = np.asarray(js.engine.state.extras[key[0]]["fsum"])
        pf = ps.engine.state.extras[key[0]]["fsum"].numpy()
        assert np.abs(pf - jf).max() <= 1e-9 * np.abs(jf).max()


def test_minimize_deck_from_a_data_file(tmp_path):
    """read_data of a jiggled LJ crystal, fixes defined, FIRE to the
    force tolerance, then 30 steps of fix langevin + fix nve: the same
    MinResult and rows in both packages."""
    from lammps_plugins_tpu.api.data import write_data
    from lammps_plugins_tpu.api.script import Script
    s = Script(log=lambda _: None)
    s.run_text(LJ_SETUP)
    st = s._state()
    import jax.numpy as jnp
    x = np.asarray(st.x) + 0.05 * np.random.default_rng(7).standard_normal(
        st.x.shape)
    path = str(tmp_path / "jiggled.data")
    write_data(path, st.replace(x=jnp.asarray(x)))
    deck = f"""
units           lj
atom_style      atomic
read_data       {path}
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
fix             1 all langevin 1.44 1.44 0.1 48279
fix             2 all nve
thermo          10
min_style       fire
minimize        0.0 1e-4 200 2000
run             30
"""
    js, jrows, _ = run_deck("jax", deck)
    ps, prows, _ = run_deck("port", deck)
    jm, pm = js.last_min, ps.last_min
    assert (pm.stop_criterion, pm.iterations) == (jm.stop_criterion,
                                                  jm.iterations)
    assert pm.iterations > 20
    assert abs(pm.e_final - jm.e_final) <= 1e-9 * abs(jm.e_final)
    ok, err = _close([[r[k] for k in KEYS] for r in prows],
                     [[r[k] for k in KEYS] for r in jrows], 1e-9)
    assert ok, err


def test_ramp_window_reanchors_and_recaptures():
    """Two runs of a ramped fix nvt: each run sets its own window, which
    is part of the device loop's key, so the loop of the second run is
    not the first's (the stale-window fault); the eager device-loop
    iteration and the host loop agree bit for bit across both runs."""
    from lammps_plugins_tpu_torch.api.script import Script
    deck = _decks()["nvt_ramp"]
    states, keys = [], []
    for fused in (True, False):
        s = Script(log=lambda _: None, dtype=torch.float64, device="cpu")
        s.run_text(deck.replace("run 12\nrun 12", "neigh_modify every 6\n"
                                "thermo 12\nrun 0"))
        s.engine.fused_loop = fused
        s.command("run 12")
        k1 = s.engine._loop_key
        fx = s.fixes[0]
        assert (fx.begin_step, fx.end_step) == (0, 12)
        s.command("run 12")
        assert (fx.begin_step, fx.end_step) == (12, 24)
        keys.append((k1, s.engine._loop_key))
        states.append(s.engine.state)
    k1, k2 = keys[0]
    assert k1 is not None and k1 != k2
    a, b = states
    for f in ("x", "v", "f", "image"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for k in ("eta", "eta_dot", "step"):
        assert torch.equal(a.extras["nvt:1"][k], b.extras["nvt:1"][k]), k


def test_plugin_load_registers_port_style(tmp_path):
    from lammps_plugins_tpu import registry as jreg
    from lammps_plugins_tpu_torch import registry
    from lammps_plugins_tpu_torch.api.script import Script
    plug = tmp_path / "port_plugin.py"
    plug.write_text(
        "from lammps_plugins_tpu_torch.registry import register_fix_style\n"
        "from lammps_plugins_tpu_torch.fixes.nve import FixNVE\n"
        "@register_fix_style('nve_port_plugin_test')\n"
        "class FixNVEPlugin(FixNVE):\n"
        "    pass\n")
    lines = []
    s = Script(log=lines.append, dtype=torch.float64, device="cpu")
    s.run_text(f"plugin load {plug}\nplugin list\n")
    try:
        assert "nve_port_plugin_test" in registry.FIX_STYLES
        assert "nve_port_plugin_test" not in jreg.FIX_STYLES
        assert any("nve_port_plugin_test" in ln for ln in lines)
    finally:
        registry.FIX_STYLES.pop("nve_port_plugin_test", None)


_BFIELD_BASE = """
units metal
atom_style charge
boundary p p p
lattice fcc 4.05
region box block 0 2 0 2 0 2
create_box 1 box
create_atoms 1 box
mass 1 26.98
set type 1 charge 1.0
pair_style aeam
pair_coeff * * {aeam} Al
""".replace("{aeam}", SYNTH_AEAM)

ERRORS = {
    "unknown": ("", "frobnicate 1 2", "Unknown command"),
    "bfield_order": (_BFIELD_BASE + "fix 1 all nve\nfix 2 all bfield 0 0 "
                     "5.0\n", "run 1", "must be defined before"),
    "bfield_nvt": (_BFIELD_BASE + "fix 1 all bfield 0 0 5.0\nfix 2 all nvt "
                   "temp 300 300 0.1\n", "run 1", "NVE style integrator"),
    "min_style": (LJ_SETUP, "min_style cg", "min_style"),
    "langevin_kw": (LJ_SETUP, "fix 2 all langevin 300 300 0.1 48279 zero "
                    "yes", "langevin keywords"),
    "bfield_thermo_var": (_BFIELD_BASE + "variable hot equal temp*0.1\n",
                          "fix 1 all bfield 0 0 v_hot", "thermo keyword"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_script_errors_match_jax(case):
    from lammps_plugins_tpu.api.script import Script as JS
    from lammps_plugins_tpu.api.script import ScriptError as JE
    from lammps_plugins_tpu_torch.api.script import Script as PS
    from lammps_plugins_tpu_torch.api.script import ScriptError as PE
    setup, cmd, match = ERRORS[case]
    msgs = []
    for S, E, kw in ((JS, JE, {}), (PS, PE, dict(dtype=torch.float64,
                                                 device="cpu"))):
        s = S(log=lambda _: None, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.run_text(setup)
            with pytest.raises(E, match=match) as info:
                s.command(cmd)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_script_runs_on_the_card_by_default():
    """Script() asks for the card in float32; without one it raises (no
    CPU fallback); n_devices > 1 keeps the shards' devices for the sharded
    engine that its first run builds."""
    from lammps_plugins_tpu_torch.api.script import Script
    import inspect
    sig = inspect.signature(Script)
    assert sig.parameters["device"].default == "cuda"
    assert sig.parameters["dtype"].default == torch.float32
    assert sig.parameters["devices"].default is None
    s = Script(device="cpu", n_devices=4, devices=["cpu"] * 4)
    assert (s.n_devices, s.devices, s.engine) == (4, ["cpu"] * 4, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Script()


def test_helpers_of_the_slice_match_jax():
    """Box.with_geometry / lengths / perpendicular_widths /
    cell_angles_deg, thermo.pressure, NeighborData.max_displacement_sq /
    needs_rebuild, PairStyle.max_cutoff / ghost_margin: the JAX
    package's values on the 288-atom scene (float64)."""
    import jax.numpy as jnp
    from lammps_plugins_tpu.api.scenes import rebomos_bulk as jbulk
    from lammps_plugins_tpu.core import units as ju
    from lammps_plugins_tpu.potentials.rebomos import REBOMoS as JR
    from lammps_plugins_tpu.run import thermo as jthermo
    from lammps_plugins_tpu_torch import convert
    from lammps_plugins_tpu_torch.core import units as pu
    from lammps_plugins_tpu_torch.neighbor.build import build_neighbor_data
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS as PR
    from lammps_plugins_tpu_torch.run import thermo as pthermo
    js = jbulk()
    js = js.replace(v=jnp.asarray(np.random.default_rng(3).normal(
        size=js.v.shape)))
    ps = convert.state_from_numpy(js)
    jb, pb = js.box, ps.box
    h2 = jb.h_np() * 1.01
    lo2 = (0.5, -0.25, 1.0)
    jg, pg = jb.with_geometry(h=h2, lo=lo2), pb.with_geometry(h=h2, lo=lo2)
    np.testing.assert_array_equal(pg.h_np(), jg.h_np())
    np.testing.assert_array_equal(pg.lo_np(), jg.lo_np())
    np.testing.assert_allclose(pg.h.numpy(), np.asarray(jg.h), rtol=0,
                               atol=0)
    np.testing.assert_allclose(pb.lengths.numpy(), np.asarray(jb.lengths),
                               rtol=1e-14)
    np.testing.assert_allclose(pb.perpendicular_widths().numpy(),
                               np.asarray(jb.perpendicular_widths()),
                               rtol=1e-14)
    np.testing.assert_allclose([float(a) for a in pb.cell_angles_deg()],
                               [float(a) for a in jb.cell_angles_deg()],
                               rtol=1e-14)
    W = np.random.default_rng(4).normal(size=(3, 3)) * 10.0
    assert float(pthermo.pressure(ps, torch.as_tensor(W), pu.METAL)) \
        == pytest.approx(float(jthermo.pressure(js, jnp.asarray(W),
                                                ju.METAL)), rel=1e-14)
    jp = JR.from_file(SYNTH_REBO, ["M", "S"])
    pp = PR.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float64,
                      device="cpu")
    assert pp.max_cutoff() == jp.max_cutoff()
    assert pp.ghost_margin(0.8) == jp.ghost_margin(0.8)
    nbr = build_neighbor_data(ps.x.numpy(), ps.type.numpy(), ps.box,
                              pp.neighbor_requests(), skin=0.8,
                              dtype=torch.float64, device="cpu")
    for shift, moved in ((0.39, False), (0.41, True)):
        x = ps.x.clone()
        x[7, 1] += shift
        assert float(nbr.max_displacement_sq(x)) \
            == pytest.approx(shift ** 2, rel=1e-12)
        assert nbr.needs_rebuild(x) is moved
