"""Dumps, restart files and data files of the port (run/dump.py,
run/checkpoint.py, api/data.py) against the JAX package's, on the CPU.

  * DumpWriter: the same text as the JAX writer on the same state (atom
    and custom styles, computed columns, a group, a triclinic and an
    orthogonal box), and a deck's per-atom dump (compute pe/atom and
    stress/atom) within 1e-9 of the JAX Script's, written byte for byte
    the same on a rerun;
  * restart files: the JAX .npz keys; a 10-step resume lands within 1e-12
    of the uninterrupted run (tests/test_io.py's check); NVT and bfield
    restarts written by either package resume in the other to 1e-9; the
    periodic-restart filenames of `restart N file`;
  * data files: read_data and write_data give the JAX package's text and
    arrays (atomic and charge styles), and a round trip is exact.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from torch_parity import SYNTH_REBO
from test_torch_script import LJ_SETUP, REBO_DECK, run_deck

CPU = dict(dtype=torch.float64, device="cpu")


def _jax_state(seed=3):
    """The 288-atom scene (JAX) with velocities, forces, charges and image
    counters set from a numpy seed."""
    import jax.numpy as jnp
    from lammps_plugins_tpu.api.scenes import rebomos_bulk
    rng = np.random.default_rng(seed)
    st = rebomos_bulk()
    n = st.natoms
    return st.replace(v=jnp.asarray(rng.normal(size=(n, 3))),
                      f=jnp.asarray(rng.normal(size=(n, 3))),
                      q=jnp.asarray(rng.normal(size=n)),
                      image=jnp.asarray(rng.integers(-2, 3, (n, 3)),
                                        jnp.int32),
                      step=jnp.asarray(120, jnp.int32))


COLUMNS = ("id", "type", "x", "y", "z", "xs", "ys", "zs", "ix", "iy", "iz",
           "vx", "vy", "vz", "fx", "fy", "fz", "q", "c_pe")


@pytest.mark.parametrize("box", ["triclinic", "orthogonal"])
@pytest.mark.parametrize("style", ["atom", "custom", "group"])
def test_dump_text_equals_jax_writer(tmp_path, box, style):
    import jax.numpy as jnp
    from lammps_plugins_tpu.run.dump import DumpWriter as JW
    from lammps_plugins_tpu_torch import convert
    from lammps_plugins_tpu_torch.run.dump import DumpWriter as PW
    st = _jax_state()
    if box == "orthogonal":
        from lammps_plugins_tpu.core.box import Box
        st = st.replace(box=Box.orthogonal([13.0, 22.5, 14.25]))
    pe = np.random.default_rng(1).normal(size=st.natoms) * 1e3
    kw = {}
    if style != "atom":
        kw = dict(columns=COLUMNS)
    if style == "group":
        kw["group_mask"] = np.arange(st.natoms) % 3 == 1
    jw = JW(str(tmp_path / "j.dump"), providers={"c_pe": lambda s: pe}, **kw)
    pw = PW(str(tmp_path / "p.dump"),
            providers={"c_pe": lambda s: torch.as_tensor(pe)}, **kw)
    ps = convert.state_from_numpy(st)
    for step in (120, 130):
        jw.write(st.replace(step=jnp.asarray(step, jnp.int32)))
        pw.write(ps.replace(step=step))
    jw.close()
    pw.close()
    text = open(tmp_path / "p.dump").read()
    assert text == open(tmp_path / "j.dump").read()
    assert text.count("ITEM: TIMESTEP") == 2 and pw.frames == 2


PERATOM = """
velocity        all create 300.0 4928459
compute         pe all pe/atom
compute         s all stress/atom NULL
dump            1 all custom 10 {dump} id type x y z c_pe c_s[1] c_s[2] c_s[3] c_s[4] c_s[5] c_s[6]
"""


def _peratom_deck(dump):
    return REBO_DECK.replace("thermo          10",
                             PERATOM.format(dump=dump) + "thermo 10")


def _frames(path):
    """[(step, [N, cols] array)] of a custom dump."""
    lines = open(path).read().splitlines()
    out = []
    i = 0
    while i < len(lines):
        step = int(lines[i + 1])
        n = int(lines[i + 3])
        rows = [[float(v) for v in ln.split()] for ln in lines[i + 9:i + 9 + n]]
        out.append((step, np.array(rows)))
        i += 9 + n
    return out


def test_peratom_dump_matches_jax_and_reruns_byte_for_byte(tmp_path):
    paths = {k: str(tmp_path / f"{k}.dump") for k in ("jax", "p1", "p2")}
    run_deck("jax", _peratom_deck(paths["jax"]))
    rows = run_deck("port", _peratom_deck(paths["p1"]))[1]
    run_deck("port", _peratom_deck(paths["p2"]))
    assert open(paths["p1"], "rb").read() == open(paths["p2"], "rb").read()
    jf, pf = _frames(paths["jax"]), _frames(paths["p1"])
    assert [s for s, _ in pf] == [s for s, _ in jf] == [0, 10, 20]
    for (_, a), (_, b), row in zip(pf, jf, rows):
        np.testing.assert_array_equal(a[:, :2], b[:, :2])
        # within 1e-9 of each column's scale, or the 8 printed digits
        scale = np.abs(b).max(axis=0)
        assert np.all(np.abs(a - b) <= 1e-9 * scale + 5e-8 * np.abs(b))
        # pe/atom sums to the frame's pe (to the printed digits)
        assert abs(a[:, 5].sum() - row["pe"]) <= 1e-7 * abs(row["pe"])
        assert np.abs(b[:, 6:]).max() > 1.0


def _nve_engines(pkg, state=None):
    if pkg == "jax":
        from lammps_plugins_tpu.core import units
        from lammps_plugins_tpu.fixes.nve import FixNVE
        from lammps_plugins_tpu.fixes.velocity import velocity_create
        from lammps_plugins_tpu.api.scenes import rebomos_bulk
        from lammps_plugins_tpu.potentials.rebomos import REBOMoS
        from lammps_plugins_tpu.run.simulation import Engine
        pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"])
        if state is None:
            state = velocity_create(rebomos_bulk(), units.METAL, 100.0, 9)
        return Engine(state, pair, [FixNVE()], units.METAL)
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], **CPU)
    if state is None:
        state = velocity_create(rebomos_bulk(**CPU), units.METAL, 100.0, 9)
    return Engine(state, pair, [FixNVE()], units.METAL)


def test_restart_roundtrip_resumes(tmp_path):
    from lammps_plugins_tpu_torch.run.checkpoint import load_state, save_state
    eng = _nve_engines("port")
    eng.run(10)
    path = str(tmp_path / "ck.npz")
    save_state(path, eng.state)
    eng.run(10)
    st2 = load_state(path, **CPU)
    assert st2.step == 10
    eng2 = _nve_engines("port", st2)
    eng2.run(10)
    np.testing.assert_allclose(eng2.state.x.numpy(), eng.state.x.numpy(),
                               rtol=0, atol=1e-12)
    z = np.load(path)
    assert set(z.files) == {"x", "v", "f", "type", "q", "image", "mass",
                            "step", "box_h", "box_lo", "box_periodic"}


def _fix_engine(pkg, kind, state=None):
    """Engine of the 128-ion charged melt deck (bfield + nve) or the
    108-atom Al-Si cell under NVT, on `state` when given (a restart)."""
    if kind == "bfield":
        from test_torch_ljcut import jax_deck_engine, port_deck
        if pkg == "jax":
            eng = jax_deck_engine("charged")
            if state is not None:
                from lammps_plugins_tpu.run.simulation import Engine
                eng = Engine(state, eng.pair, eng.fixes, eng.units,
                             skin=eng.skin)
            return eng
        deck = port_deck("charged")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if state is None:
                return deck.engine()
            from lammps_plugins_tpu_torch.run.simulation import Engine
            return Engine(state, deck.pair, deck.fixes, deck.units,
                          skin=deck.skin)
    from test_torch_nvt import jax_engine as jax_nvt
    if pkg == "jax":
        eng = jax_nvt()
        if state is not None:
            from lammps_plugins_tpu.run.simulation import Engine
            eng = Engine(state, eng.pair, eng.fixes, eng.units,
                         skin=eng.skin, check_every=eng.check_every,
                         device_rebuild=True)
        return eng
    from test_torch_nvt import port_engine as port_nvt
    eng = port_nvt()
    if state is not None:
        from lammps_plugins_tpu_torch.run.simulation import Engine
        eng = Engine(state, eng.pair, eng.fixes, eng.units, skin=eng.skin,
                     check_every=eng.check_every)
    return eng


@pytest.mark.parametrize("kind", ["nvt", "bfield"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restart_crosses_packages(tmp_path, kind, writer):
    """A restart written by one package after 12 steps resumes in the
    other: 12 more steps from the file in each package agree to 1e-9, and
    the file holds the same keys either way."""
    from lammps_plugins_tpu.run.checkpoint import load_state as jload
    from lammps_plugins_tpu.run.checkpoint import save_state as jsave
    from lammps_plugins_tpu_torch.run.checkpoint import load_state as pload
    from lammps_plugins_tpu_torch.run.checkpoint import save_state as psave
    path = str(tmp_path / "ck.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = _fix_engine(writer, kind)
        eng.run(12)
        (jsave if writer == "jax" else psave)(path, eng.state)
        keys = set(np.load(path).files)
        assert any(k.startswith("extras/") for k in keys)
        assert not any(k.endswith("/step") for k in keys)
        je = _fix_engine("jax", kind, jload(path))
        pe = _fix_engine("port", kind, pload(path, **CPU))
        assert pe.state.step == int(je.state.step) == 12
        je.run(12)
        pe.run(12)
    # unwrapped positions: the two packages may wrap at other steps
    js, ps = je.state, pe.state
    pairs = {"x": (ps.box.unmap(ps.x, ps.image).numpy(),
                   np.asarray(js.x) + np.asarray(js.image) @ js.box.h_np()),
             "v": (ps.v.numpy(), np.asarray(js.v))}
    for f, (a, b) in pairs.items():
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), f


def test_periodic_restart_filenames(tmp_path):
    """`restart N file*` stamps the step; a bare name gets .<step>; two
    names alternate; no file at step 0 (LAMMPS semantics, as JAX)."""
    from lammps_plugins_tpu_torch.run.checkpoint import load_state
    base = LJ_SETUP + "velocity all create 1.44 87287\nfix 1 all nve\n"
    star, bare = str(tmp_path / "a.*"), str(tmp_path / "b")
    one, two = str(tmp_path / "c1"), str(tmp_path / "c2")
    for spec in (f"restart 10 {star}", f"restart 10 {bare}",
                 f"restart 10 {one} {two}"):
        s, _, _ = run_deck("port", base + spec + "\nrun 30\n")
    for step in (10, 20, 30):
        assert os.path.exists(str(tmp_path / f"a.{step}"))
        assert os.path.exists(str(tmp_path / f"b.{step}"))
    assert not os.path.exists(str(tmp_path / "a.0"))
    assert load_state(one, **CPU).step == 30       # 10, then 30 (c1 c2 c1)
    assert load_state(two, **CPU).step == 20
    np.testing.assert_array_equal(load_state(str(tmp_path / "a.30"),
                                             **CPU).x.numpy(),
                                  s.engine.state.x.numpy())


@pytest.mark.parametrize("style", ["atomic", "charge"])
def test_data_files_match_jax(tmp_path, style):
    from lammps_plugins_tpu.api.data import read_data as jread
    from lammps_plugins_tpu.api.data import write_data as jwrite
    from lammps_plugins_tpu_torch import convert
    from lammps_plugins_tpu_torch.api.data import read_data, write_data
    st = _jax_state()
    jp, pp = str(tmp_path / "j.data"), str(tmp_path / "p.data")
    jwrite(jp, st, atom_style=style)
    write_data(pp, convert.state_from_numpy(st), atom_style=style)
    assert open(pp).read() == open(jp).read()
    back = read_data(jp, atom_style=style, **CPU)
    ref = jread(jp, atom_style=style)
    for f in ("x", "v", "q", "type", "image", "mass"):
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_array_equal(back.box.h_np(), ref.box.h_np())
    # the round trip is exact
    write_data(str(tmp_path / "p2.data"), back, atom_style=style)
    assert open(tmp_path / "p2.data").read() == open(pp).read()


def test_data_file_errors_match_jax(tmp_path):
    from lammps_plugins_tpu.api.data import read_data as jread
    from lammps_plugins_tpu_torch.api.data import read_data
    path = tmp_path / "bonds.data"
    path.write_text("LAMMPS data file\n\n2 atoms\n1 atom types\n3 bonds\n")
    msgs = []
    for fn, kw in ((jread, {}), (read_data, CPU)):
        with pytest.raises(ValueError) as info:
            fn(str(path), **kw)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and "topology" in msgs[0]
