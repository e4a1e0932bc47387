"""The port's sharded engine against the JAX package's ShardedEngine on the
other styles and fixes, and the engine's own contracts, float64 on the
CPU (the JAX engine on the 8 virtual devices of tests/conftest.py, the
port's shards on the CPU, stacked and per device: each parity test runs
for both placements).

Held against JAX, one JAX engine per module fixture (a JAX sharded run
costs ~50 s of compilation):
  * AEAM (tests/data/AlSi.synthetic.aeam, 5 % Si, jiggled) in two slabs:
    static PE (1e-10 relative) and forces (1e-8 x scale);
  * the charged lj/cut/coul/cut melt in four slabs with fix bfield + fix
    nvt: static PE and forces, then 40 steps (atol 1e-9) and fix
    bfield's fsum read through fix_view_state (1e-9);
  * the lj/cut melt in four slabs with a group-scoped fix nve and fix
    langevin on the same group: static PE and forces, then 40 steps
    (atol 1e-9): the group follows the atoms by their tags, and each
    shard draws its own block of noise under fold_in(key, shard), as JAX
    does.  Skin 2.0 keeps both runs without a resettle, so that the
    blocks hold the same atoms in both packages.
The port's own contracts, on the charged melt: the device loop's
iteration (eager on the CPU) equal to the host loop bit for bit over
resettles; a re-list after a span equal to the span's last resettle; a
forced re-size (slack 1.01) giving the same trajectory (both
placements);
callbacks with the gathered state; fix_view_state against the
single-device Engine; the Comm timer above zero; group_sel by tag; the
per-device placement against the stacked one: the Langevin group bit for
bit, fix bfield with fix nve bit for bit but for fsum, and fix bfield
with fix nvt to 1e-12 relative (only the order of the psum differs); and
the refusals (a slab narrower than the halo margin, a grid that does not
tile the shards, fewer than two shards, a card the machine lacks, a
stacked layout asked for shards on several devices, a non-periodic split
axis).
"""

import numpy as np
import pytest
import torch

from torch_parity import SYNTH_AEAM

STEPS = 40
F64 = dict(dtype=torch.float64, device="cpu")
PLACEMENTS = ("stacked", "per_device")


def _min_image(d, h):
    f = d @ np.linalg.inv(h)
    return (f - np.round(f)) @ h


def _jax_melt(charged: bool):
    """The JAX-built 1,024-atom melt: fcc 4.05 A, 16 x 4 x 4 cells, types
    1 2 1 2, every atom moved by up to 0.1 A (numpy seed 3: off the
    lattice sites, where the forces are rounding noise), 300 K (charges
    +-1 when charged)."""
    import jax.numpy as jnp
    from lammps_plugins_tpu.core import units
    from lammps_plugins_tpu.core.box import Box
    from lammps_plugins_tpu.core.lattice import Lattice, create_atoms_box
    from lammps_plugins_tpu.core.state import State
    from lammps_plugins_tpu.fixes.velocity import velocity_create
    lat = Lattice.fcc(4.05)
    box = Box.orthogonal([4.05 * 16, 4.05 * 4, 4.05 * 4])
    pos, types = create_atoms_box(lat, box, [1, 2, 1, 2])
    pos = np.asarray(pos) + np.random.default_rng(3).uniform(
        -0.1, 0.1, np.shape(pos))
    q = (np.where(np.asarray(types) == 1, 1.0, -1.0) if charged
         else np.zeros(len(pos)))
    st = State.create(x=jnp.asarray(pos), type=types, box=box,
                      mass=np.array([0.0, 23.0, 35.5]), q=q)
    return velocity_create(st, units.METAL, 300.0, seed=17)


def _lj_pairs(charged: bool):
    """(JAX pair, port pair) with the same coefficients."""
    from lammps_plugins_tpu.core import units
    from lammps_plugins_tpu.potentials import ljcut as jlj
    from lammps_plugins_tpu_torch.potentials import ljcut as plj
    if charged:
        pairs = (jlj.PairLJCutCoulCut(6.0, 6.0, ntypes=2,
                                      qqr2e=units.METAL.qqr2e),
                 plj.PairLJCutCoulCut(6.0, 6.0, ntypes=2,
                                      qqr2e=units.METAL.qqr2e, **F64))
    else:
        pairs = (jlj.PairLJCut(6.0, ntypes=2), plj.PairLJCut(6.0, ntypes=2,
                                                             **F64))
    for p in pairs:
        p.set_coeff(1, 1, 0.4, 2.4 if charged else 2.6)
        p.set_coeff(2, 2, 0.4, 3.0 if charged else 2.6)
    return pairs


def _group(st):
    x = np.asarray(st.x)[:, 0]
    return x < np.median(x)


def _fixes(pkg: str, kind: str, gmask=None):
    """The fix list of a run, from package `pkg` ("jax" or "port")."""
    root = "lammps_plugins_tpu" if pkg == "jax" else \
        "lammps_plugins_tpu_torch"
    import importlib
    mod = {n: importlib.import_module(f"{root}.fixes.{n}")
           for n in ("bfield", "nvt", "nve", "langevin")}
    if kind == "bfield_nvt":
        return [mod["bfield"].FixBfield(0.0, 0.0, 5.0),
                mod["nvt"].FixNVT(500.0, 500.0, 0.1)]
    if kind == "bfield_nve":
        return [mod["bfield"].FixBfield(0.0, 0.0, 5.0), mod["nve"].FixNVE()]
    return [mod["nve"].FixNVE(group_mask=gmask),
            mod["langevin"].FixLangevin(300.0, 300.0, 0.1, 4242,
                                        group_mask=gmask)]


def _jax_run(st, pair, fixes, n, skin, steps):
    """The JAX sharded engine's static PE, forces, and its state and fix
    outputs after `steps`."""
    from lammps_plugins_tpu.core import units
    from lammps_plugins_tpu.parallel.sharded_engine import ShardedEngine
    if getattr(pair, "needs_charges", False):
        pair.bind_charges(st.q)
    se = ShardedEngine(st, pair, fixes, units.METAL, n_devices=n, skin=skin)
    out = dict(state=st, pe=se.potential_energy())
    se._setup_forces()
    out["f"] = np.asarray(se.to_state().f)
    if steps:
        se.run(steps)
        end = se.to_state()
        out.update(x=np.asarray(end.x), v=np.asarray(end.v),
                   view=se.fix_view_state())
    return out


def _port(ref, pair, fixes, n, skin, **kw):
    from lammps_plugins_tpu_torch.convert import state_from_numpy
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.parallel import ShardedEngine
    return ShardedEngine(state_from_numpy(ref["state"]), pair, fixes,
                         units.METAL, devices=["cpu"] * n, skin=skin, **kw)


@pytest.fixture(scope="module")
def jax_bfield_nvt():
    st = _jax_melt(True)
    return _jax_run(st, _lj_pairs(True)[0], _fixes("jax", "bfield_nvt"), 4,
                    1.0, STEPS)


@pytest.fixture(scope="module")
def jax_langevin_group():
    st = _jax_melt(False)
    return _jax_run(st, _lj_pairs(False)[0],
                    _fixes("jax", "langevin", _group(st)), 4, 2.0, STEPS)


@pytest.fixture(scope="module")
def jax_aeam():
    import jax.numpy as jnp
    from lammps_plugins_tpu.core.box import Box
    from lammps_plugins_tpu.core.lattice import Lattice, create_atoms_box
    from lammps_plugins_tpu.core.state import State
    from lammps_plugins_tpu.fixes.nve import FixNVE
    from lammps_plugins_tpu.fixes.velocity import set_type_fraction
    from lammps_plugins_tpu.potentials.aeam import AEAM
    pair = AEAM.from_file(SYNTH_AEAM, ["Al", "Si"])
    a, reps = 4.045, 8
    box = Box.orthogonal([a * reps] * 3)
    pos, types = create_atoms_box(Lattice.fcc(a), box, [1, 1, 1, 1])
    pos = np.asarray(pos) + np.random.default_rng(5).uniform(
        -0.1, 0.1, np.shape(pos))
    st = State.create(x=jnp.asarray(pos), type=types, box=box,
                      mass=pair.masses)
    st = set_type_fraction(st, 2, 0.05, seed=12)
    return _jax_run(st, pair, [FixNVE()], 2, 1.0, 0)


def _static(se, ref):
    pe = se.potential_energy()
    se._setup_forces()
    f = se.to_state().f.numpy()
    assert abs(pe - ref["pe"]) <= 1e-10 * max(1.0, abs(ref["pe"]))
    scale = np.abs(ref["f"]).max()
    np.testing.assert_allclose(f, ref["f"], rtol=0, atol=1e-8 * scale)


def _same_trajectory(se, ref):
    end = se.to_state()
    h = ref["state"].box.h_np()
    np.testing.assert_allclose(_min_image(end.x.numpy() - ref["x"], h), 0.0,
                               atol=1e-9)
    np.testing.assert_allclose(end.v.numpy(), ref["v"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_aeam_two_slabs_static_match_jax(jax_aeam, placement):
    """AEAM's angular embedding across the slab faces: the sharded view
    drops the angular row set (for_sharded) and takes autograd forces."""
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.aeam import AEAM
    pair = AEAM.from_file(SYNTH_AEAM, ["Al", "Si"], **F64)
    se = _port(jax_aeam, pair, [FixNVE()], 2, 1.0, placement=placement)
    assert se.pair is not pair and se.pair._ang_sel is None
    _static(se, jax_aeam)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_charged_melt_bfield_nvt_match_jax(jax_bfield_nvt, placement):
    """lj/cut/coul/cut with per-shard charges (q_loc), fix bfield's and
    fix nvt's sums over every block (per device: psums): static, then 40
    steps and fsum."""
    ref = jax_bfield_nvt
    fixes = _fixes("port", "bfield_nvt")
    se = _port(ref, _lj_pairs(True)[1], fixes, 4, 1.0, placement=placement)
    _static(se, ref)
    se.fused_loop = True
    se.run(STEPS)
    _same_trajectory(se, ref)
    key = fixes[0].key
    fsum = se.fix_view_state().extras[key]["fsum"].numpy()
    fsum_j = np.asarray(ref["view"].extras[key]["fsum"])
    np.testing.assert_allclose(fsum, fsum_j, rtol=1e-9,
                               atol=1e-9 * np.abs(fsum_j).max())


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_group_langevin_match_jax(jax_langevin_group, placement):
    """A group-scoped fix nve and fix langevin: membership by tag, the
    noise drawn block by block under fold_in(key, shard) (per device:
    each shard its own block)."""
    ref = jax_langevin_group
    gm = _group(ref["state"])
    se = _port(ref, _lj_pairs(False)[1], _fixes("port", "langevin", gm), 4,
               2.0, placement=placement)
    _static(se, ref)
    se.fused_loop = False
    se.run(STEPS)
    assert se.resettles == 1
    _same_trajectory(se, ref)


def _melt_engine(slack=1.4, fused=None, skin=0.3, kind="bfield_nve",
                 **kw):
    """The charged melt in four slabs (port), hot enough at skin 0.3 that
    the run resettles."""
    from lammps_plugins_tpu.core import units as junits
    from lammps_plugins_tpu.fixes.velocity import velocity_create
    st = velocity_create(_jax_melt(True), junits.METAL, 900.0, seed=5)
    se = _port(dict(state=st), _lj_pairs(True)[1], _fixes("port", kind), 4,
               skin, slack=slack, **kw)
    se.fused_loop = fused
    return se


def test_device_loop_iteration_equals_host_loop_bit_for_bit():
    """The iteration the card captures, run eagerly, against the host
    loop: x, v, f, the rows' layout and fix bfield's extras bit for bit,
    the same resettles."""
    from lammps_plugins_tpu_torch.run.device_loop import extras_items
    a, b = _melt_engine(fused=True), _melt_engine(fused=False)
    a.run(STEPS)
    b.run(STEPS)
    assert a.resettles >= 3 and a.resettles == b.resettles
    for f in ("x", "v", "f", "image", "type", "q", "tag", "valid"):
        assert torch.equal(getattr(a.shards, f), getattr(b.shards, f)), f
    for (p, t), (q, u) in zip(extras_items(a.shards.extras),
                              extras_items(b.shards.extras), strict=True):
        assert p == q and torch.equal(t, u), p


def test_relist_after_a_span_gives_the_same_tables():
    """After a span of the device loop's iteration (resettles inside it),
    a re-list runs the last resettle again from its inputs (the loop's
    rs_in): the same halo tables and lists bit for bit, as the overflow
    recovery of a discarded span needs."""
    from lammps_plugins_tpu_torch.run.device_loop import tensors
    se = _melt_engine(fused=True)
    se.run(20)
    assert se.resettles >= 3
    halo = {f: t.clone() for f, t in vars(se.halo).items()}
    lists = [[t.clone() for t in tensors(n)] for n in se.nbrs]
    se._relist()
    for f, t in halo.items():
        assert torch.equal(getattr(se.halo, f), t), f
    for old, new in zip(lists, se.nbrs, strict=True):
        for a, b in zip(old, tensors(new), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_forced_regrow_gives_the_same_trajectory(placement):
    """A re-size forced in the middle of a run (slack 1.01, then a
    migration overflow's _grow: n_cap and B_mig grow, the shards are
    repacked) continues the trajectory of an engine that never re-sized
    past its first resettle (other row orders, so to rounding)."""
    a = _melt_engine(slack=1.01, fused=True, placement=placement)
    b = _melt_engine(fused=True, placement=placement)
    b.run(STEPS)
    a.run(STEPS // 2)
    n_cap, grows = a.n_cap, a.regrows
    a._grow(dict(a._flags), ["mig_overflow"])
    a.resettle()
    a.run(STEPS // 2)
    assert a.n_cap > n_cap and a.regrows == grows + 1
    sa, sb = a.to_state(), b.to_state()
    assert sa.step == sb.step == STEPS
    h = sa.box.h_np()
    np.testing.assert_allclose(_min_image((sa.x - sb.x).numpy(), h), 0.0,
                               atol=1e-9)
    np.testing.assert_allclose(sa.v.numpy(), sb.v.numpy(), rtol=0,
                               atol=1e-9)


def test_callbacks_fix_view_state_and_comm_timer():
    """Callbacks see the gathered State at steps 0, 5 and 10; fix
    bfield's outputs through fix_view_state equal the single-device
    Engine's; the Comm section holds the halo refresh's share."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.run.simulation import Engine
    se = _melt_engine(skin=1.0, check_every=5)
    seen = []
    se.run(10, callbacks=((5, lambda st: seen.append((st.step,
                                                      st.natoms))),))
    assert seen == [(0, se.natoms), (5, se.natoms), (10, se.natoms)]
    assert se.timers.acc["Comm"] > 0.0
    fixes = _fixes("port", "bfield_nve")
    from lammps_plugins_tpu.core import units as junits
    from lammps_plugins_tpu.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.convert import state_from_numpy
    st = state_from_numpy(velocity_create(_jax_melt(True), junits.METAL,
                                          900.0, seed=5))
    eng = Engine(st, _lj_pairs(True)[1], fixes, units.METAL, skin=1.0,
                 check_every=5)
    eng.run(10)
    view = se.fix_view_state()
    e1 = float(fixes[0].energy(eng.state, eng.ctx))
    assert abs(float(se.fixes[0].energy(view, se.ctx)) - e1) \
        <= 1e-9 * max(1.0, abs(e1))
    np.testing.assert_allclose(se.fixes[0].vector(view).numpy(),
                               fixes[0].vector(eng.state).numpy(),
                               rtol=1e-9, atol=1e-9)


def test_group_sel_resolves_by_tag():
    """Fix.group_sel on a stacked state maps each row's tag through the
    [N] mask; pad rows (tag -1) are outside every group."""
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    fix = FixNVE(group_mask=np.array([True, False, True]))
    box = Box.orthogonal([10.0] * 3, **F64)
    st = State.create(np.zeros((5, 3)), np.ones(5), box, [0.0, 1.0])
    st = st.replace(extras={"__tag__": torch.tensor([2, -1, 1, 0, -1])})
    assert fix.group_sel(st).tolist() == [True, False, False, True, False]
    with pytest.raises(ValueError, match="no row tags"):
        fix.group_sel(st.replace(extras={}))


def test_refusals():
    from lammps_plugins_tpu_torch.convert import state_from_numpy
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.api.script import Script, ScriptError
    from lammps_plugins_tpu_torch.parallel import ShardedEngine
    st = state_from_numpy(_jax_melt(False))
    pair = _lj_pairs(False)[1]

    def make(**kw):
        kw.setdefault("skin", 1.0)
        return ShardedEngine(st, pair, [FixNVE()], units.METAL, **kw)

    with pytest.raises(ValueError, match="halo margin"):
        make(devices=["cpu"] * 8)                # 8.1 A slabs, 14 A margin
    with pytest.raises(ValueError, match="does not tile"):
        make(devices=["cpu"] * 4, grid=(3, 1))
    with pytest.raises(ValueError, match="invalid processor grid"):
        make(devices=["cpu"] * 4, grid=(-2, -2))
    with pytest.raises(ValueError, match=">= 2 shards"):
        make(devices=["cpu"])
    with pytest.raises(ValueError, match="the machine has"):
        make(devices=["cpu", "cpu"] + [f"cuda:{torch.cuda.device_count()}"]
             * 2)                                # a card the machine lacks
    with pytest.raises(ValueError, match="stacks the shards on one"):
        make(devices=["cpu", "cpu", "cuda:0", "cuda:0"], placement="stacked")
    with pytest.raises(ScriptError, match="needs devices"):
        Script(device="cpu", n_devices=4)        # shards named, not implied
    slab = st.replace(box=st.box.__class__.from_numpy(
        st.box.h_np(), st.box.lo_np(), (False, True, True), **F64))
    with pytest.raises(ValueError, match="periodic axis 0"):
        ShardedEngine(slab, pair, [FixNVE()], units.METAL,
                      devices=["cpu"] * 4, skin=1.0)


def _rows_and_extras(se):
    from lammps_plugins_tpu_torch.run.device_loop import extras_items
    ss = se.shards
    out = {f: getattr(ss, f) for f in ("x", "v", "f", "image", "tag",
                                       "valid")}
    out.update((":".join(p), t) for p, t in extras_items(ss.extras))
    return out


def test_per_device_langevin_group_equals_stacked_bit_for_bit():
    """The group-scoped fix nve + fix langevin melt (skin 0.3: resettles
    inside the run): each shard draws its block's noise alone, and the
    per-device run equals the stacked one bit for bit, extras included."""
    from lammps_plugins_tpu.core import units as junits
    from lammps_plugins_tpu.fixes.velocity import velocity_create
    st = velocity_create(_jax_melt(False), junits.METAL, 900.0, seed=5)
    gm = _group(st)
    out = {}
    for p in PLACEMENTS:
        se = _port(dict(state=st), _lj_pairs(False)[1],
                   _fixes("port", "langevin", gm), 4, 0.3, placement=p)
        se.fused_loop = True
        se.run(STEPS)
        out[p] = (se.resettles, _rows_and_extras(se))
    assert out["stacked"][0] == out["per_device"][0] >= 2
    for k, t in out["stacked"][1].items():
        assert torch.equal(t, out["per_device"][1][k]), k


@pytest.mark.parametrize("kind", ["bfield_nve", "bfield_nvt"])
def test_per_device_bfield_and_nvt_against_stacked(kind):
    """fix bfield with fix nve: the trajectory bit for bit, fsum (a psum
    of the shards' sums) to 1e-12 relative; with fix nvt the chain reads
    the psum'd temperature, so the whole state holds to 1e-12 relative
    (f64) and the resettles agree."""
    a, b = (_melt_engine(fused=True, kind=kind, placement=p)
            for p in PLACEMENTS)
    a.run(STEPS)
    b.run(STEPS)
    assert a.resettles == b.resettles >= 2
    ra, rb = _rows_and_extras(a), _rows_and_extras(b)
    exact = ("x", "v", "f", "image", "tag", "valid") \
        if kind == "bfield_nve" else ("image", "tag", "valid")
    for k, t in ra.items():
        if k in exact:
            assert torch.equal(t, rb[k]), k
        else:
            scale = max(float(t.abs().max()), 1e-300)
            assert float((t - rb[k]).abs().max()) <= 1e-12 * scale, k
    fa, fb = (e.fixes[0].energy(e.fix_view_state(), e.ctx) for e in (a, b))
    assert abs(float(fa) - float(fb)) <= 1e-12 * abs(float(fa))
