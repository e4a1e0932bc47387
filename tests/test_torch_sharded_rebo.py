"""The port's sharded engine (lammps_plugins_tpu_torch/parallel/) against
the JAX package's ShardedEngine on REBOMOS, synthetic parameters
(tests/data/MoS.REBO.synthetic), float64 on the CPU.

The JAX engine runs on the 8 virtual CPU devices of tests/conftest.py;
the port puts its shards on the CPU (devices=["cpu"] * n) in both of its
placements, stacked and per device (placement="per_device": each shard
its own program, the cross-shard moves collectives), and each parity test
runs for both.  Both packages start from the same JAX-built scene
(positions and velocities cross as numpy).  A JAX sharded run costs ~50 s
of compilation, so each JAX engine runs once, in a module fixture, and
every test reads it.

Held: the capacities (n_cap, Bhx, Bhy, B_mig, n_loc) equal to JAX's in
four x-slabs and in a 2x2 grid; the static PE (1e-10 relative) and forces
(1e-8 x scale) in both layouts; a 40-step NVE trajectory in four slabs
through the port's device-loop iteration (run eagerly on the CPU) against
JAX's sharded host loop (atol 1e-9, minimum image); migration after a
push across slab boundaries (four slabs forward, two slabs backward,
which is the P == 2 route, the 2x2 grid diagonally) against the port's
single-device Engine on the gathered state; and the lost-atom refusal.
Skin 0.5 keeps the halo margin at 11.0 A and makes the 600 K run
resettle within its 40 steps.  Then the per-device placement against the
stacked one bit for bit (a 40-step NVE run in the 2x2 grid), each
shard's tensors on its own device, and a shard that raises or hangs in
the middle of a step: the engine raises within its timeout.
"""

import numpy as np
import pytest
import torch

from torch_parity import SYNTH_REBO

SKIN = 0.5
STEPS = 40
#: 864 atoms, four x-slabs of 14.4 A; 1,296 atoms for the 2x2 grid
SLABS = dict(scene=dict(nx=12, ny=8, nz=1, tilt_xy=0.0), grid=(4, 1),
             temp=600.0, seed=3)
GRID = dict(scene=dict(nx=12, ny=12, nz=1, tilt_xy=0.0), grid=(2, 2),
            temp=300.0, seed=31)
CAPS = ("n_cap", "Bhx", "Bhy", "B_mig", "n_loc")
PLACEMENTS = ("stacked", "per_device")


def _jax_state(cfg):
    from lammps_plugins_tpu.api.scenes import rebomos_bulk
    from lammps_plugins_tpu.core import units
    from lammps_plugins_tpu.fixes.velocity import velocity_create
    st = rebomos_bulk(**cfg["scene"])
    return velocity_create(st, units.METAL, cfg["temp"], seed=cfg["seed"])


def _port_pair():
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    return REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float64,
                             device="cpu")


def _port_engine(state, grid, placement="stacked", fixes=None, **kw):
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.parallel import ShardedEngine
    return ShardedEngine(state, _port_pair(),
                         [FixNVE()] if fixes is None else fixes, units.METAL,
                         devices=["cpu"] * (grid[0] * grid[1]), grid=grid,
                         skin=SKIN, placement=placement, **kw)


def _reference(cfg, steps):
    """The JAX sharded engine's capacities, static PE and forces and, with
    steps, its state after that many steps; with the scene as numpy."""
    from lammps_plugins_tpu.core import units
    from lammps_plugins_tpu.fixes.nve import FixNVE
    from lammps_plugins_tpu.parallel.sharded_engine import ShardedEngine
    from lammps_plugins_tpu.potentials.rebomos import REBOMoS
    st = _jax_state(cfg)
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"])
    se = ShardedEngine(st, pair, [FixNVE()], units.METAL,
                       n_devices=cfg["grid"][0] * cfg["grid"][1],
                       grid=cfg["grid"], skin=SKIN)
    out = dict(state=st, caps={c: getattr(se, c) for c in CAPS},
               pe=se.potential_energy())
    se._setup_forces()
    out["f"] = np.asarray(se.to_state().f)
    if steps:
        se.run(steps)
        end = se.to_state()
        out.update(x=np.asarray(end.x), v=np.asarray(end.v))
    return out


@pytest.fixture(scope="module")
def jax_slabs():
    return _reference(SLABS, STEPS)


@pytest.fixture(scope="module")
def jax_grid():
    return _reference(GRID, 0)


def _port_state(ref):
    from lammps_plugins_tpu_torch.convert import state_from_numpy
    return state_from_numpy(ref["state"])


def _min_image(d, h):
    f = d @ np.linalg.inv(h)
    return (f - np.round(f)) @ h


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("which", ["slabs", "grid"])
def test_capacities_equal_jax(which, placement, request):
    ref = request.getfixturevalue(f"jax_{which}")
    cfg = SLABS if which == "slabs" else GRID
    se = _port_engine(_port_state(ref), cfg["grid"], placement)
    assert {c: getattr(se, c) for c in CAPS} == ref["caps"]


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("which", ["slabs", "grid"])
def test_static_energy_and_forces_match_jax(which, placement, request):
    ref = request.getfixturevalue(f"jax_{which}")
    cfg = SLABS if which == "slabs" else GRID
    se = _port_engine(_port_state(ref), cfg["grid"], placement)
    pe = se.potential_energy()
    se._setup_forces()
    f = se.to_state().f.numpy()
    assert abs(pe - ref["pe"]) <= 1e-10 * abs(ref["pe"])
    scale = np.abs(ref["f"]).max()
    np.testing.assert_allclose(f, ref["f"], rtol=0, atol=1e-8 * scale)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_trajectory_matches_jax_sharded_engine(jax_slabs, placement):
    """40 NVE steps in four slabs, resettles included, through the device
    loop's iteration (eager on the CPU; the per-device placement's host
    loop), against JAX's sharded run."""
    se = _port_engine(_port_state(jax_slabs), SLABS["grid"], placement)
    se.fused_loop = True
    se.run(STEPS)
    assert se.resettles >= 2 and se.shards.step == STEPS
    end = se.to_state()
    h = jax_slabs["state"].box.h_np()
    np.testing.assert_allclose(
        _min_image(end.x.numpy() - jax_slabs["x"], h), 0.0, atol=1e-9)
    np.testing.assert_allclose(end.v.numpy(), jax_slabs["v"], rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("grid,push", [((4, 1), (3.0, 0.0, 0.0)),
                                       ((2, 1), (-3.0, 0.0, 0.0)),
                                       ((2, 2), (3.0, 3.0, 0.0))],
                         ids=["4-slabs-forward", "2-slabs-backward",
                              "2x2-diagonal"])
def test_migration_after_a_push(grid, push, placement):
    """Rows pushed across slab boundaries change shard at the resettle
    (with two slabs both neighbours are one shard: a backward push takes
    the forward route), none is lost, and the PE and forces of the
    migrated shards equal the single-device Engine's on the gathered
    state."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.convert import state_from_numpy
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.run.simulation import Engine
    cfg = SLABS if grid[1] == 1 else GRID
    se = _port_engine(state_from_numpy(_jax_state(cfg)), grid, placement)
    se.resettle()
    tags0 = se.shards.tag.view(se.n_devices, -1).clone()
    x = se.shards.x + torch.where(se.shards.valid[:, None],
                                  torch.tensor(push, dtype=torch.float64),
                                  torch.zeros(3, dtype=torch.float64))
    se.shards = se.shards.replace(x=x)
    se._f_valid = False
    se.resettle()
    assert se._flags["lost_atoms"] == 0
    tags1 = se.shards.tag.view(se.n_devices, -1)
    assert any(set(tags0[d][tags0[d] >= 0].tolist())
               != set(tags1[d][tags1[d] >= 0].tolist())
               for d in range(se.n_devices))
    assert sorted(tags1[tags1 >= 0].tolist()) == list(range(se.natoms))
    pe = se.potential_energy()
    se._setup_forces()
    st = se.to_state()
    eng = Engine(st, _port_pair(), [FixNVE()], units.METAL, skin=SKIN)
    pe1, _ = eng.evaluate()
    assert abs(pe - float(pe1)) <= 1e-10 * abs(float(pe1))
    scale = float(eng.state.f.abs().max())
    np.testing.assert_allclose(st.f.numpy(), eng.state.f.numpy(), rtol=0,
                               atol=1e-8 * scale)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_atom_moved_past_a_slab_raises(placement):
    """A row that moved more than one slab between resettles is lost: the
    resettle raises (Comm::exchange drops it; JAX raises the same)."""
    from lammps_plugins_tpu_torch.convert import state_from_numpy
    se = _port_engine(state_from_numpy(_jax_state(SLABS)), SLABS["grid"],
                      placement)
    se.resettle()
    x = se.shards.x.clone()
    first = int(torch.nonzero(se.shards.valid)[0])     # a row of shard 0
    x[first, 0] += 0.5 * float(se.box.h_np()[0, 0])    # two slabs on
    se.shards = se.shards.replace(x=x)
    with pytest.raises(RuntimeError, match="more than one slab"):
        se.resettle()


def _shard_fields(se):
    """Every row, halo table and extras tensor of an engine's stacked view
    (the per-device placement's gathered), by name."""
    from lammps_plugins_tpu_torch.run.device_loop import extras_items
    out = {f: getattr(se.shards, f) for f in ("x", "v", "f", "image", "type",
                                             "q", "tag", "valid")}
    out.update(("halo:" + f, getattr(se.halo, f))
               for f in ("t_loc", "q_loc", "valid_loc", "exp_r", "exp_u"))
    out.update((":".join(p), t) for p, t in extras_items(se.shards.extras))
    return out


def test_per_device_equals_stacked_bit_for_bit():
    """The 2x2 grid at 600 K: 10 NVE steps, a resettle (migration along
    both axes, both halo stages), 10 more: the per-device placement's
    rows, halo tables and thermo row equal the stacked layout's bit for
    bit (the same per-shard arithmetic, no sum across shards but the
    thermo row's, in the same order)."""
    from lammps_plugins_tpu_torch.convert import state_from_numpy
    cfg = dict(GRID, temp=600.0)
    runs = {}
    for placement in PLACEMENTS:
        se = _port_engine(state_from_numpy(_jax_state(cfg)), cfg["grid"],
                          placement)
        se.fused_loop = True
        se.run(10)
        se.resettle()
        se.run(10)
        runs[placement] = (se, _shard_fields(se), se.thermo())
    (a, fa, ra), (b, fb, rb) = runs["stacked"], runs["per_device"]
    assert a.resettles == b.resettles >= 2
    for k, t in fa.items():
        assert torch.equal(t, fb[k]), k
    assert ra == rb


def test_per_device_shards_live_on_their_devices():
    """Each shard's rows, halo tables, lists, fix state and pair tables on
    devices[d], the blocks of n_cap rows; the stacked view is
    [Pn * n_cap] rows."""
    from lammps_plugins_tpu_torch.convert import state_from_numpy
    from lammps_plugins_tpu_torch.fixes.langevin import FixLangevin
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.parallel import PerDeviceEngine
    from lammps_plugins_tpu_torch.run.device_loop import extras_items, tensors
    se = _port_engine(state_from_numpy(_jax_state(SLABS)), SLABS["grid"],
                      "per_device", fixes=[FixNVE(), FixLangevin(
                          300.0, 300.0, 0.1, 7)])
    assert isinstance(se, PerDeviceEngine)
    se.run(10)
    for d, dev in enumerate(se.group.devices):
        blk = se.blocks[d]
        own = [getattr(blk, f) for f in ("x", "v", "f", "image", "type", "q",
                                         "tag", "valid")]
        assert all(t.shape[0] == se.n_cap for t in own)
        own += [t for _, t in extras_items(blk.extras)]
        own += list(vars(se.halos[d]).values()) + list(tensors(se.nbrs[d]))
        own += [v for v in vars(se._pairs[d]).values() if torch.is_tensor(v)]
        assert own and all(t.device == dev for t in own)
    assert se.shards.x.shape[0] == se.n_devices * se.n_cap


class _Boom(Exception):
    pass


def _faulty(shard, hang=None):
    """A fix whose post_force raises on shard `shard` (or, given a
    threading.Event, waits on it there: a hung shard)."""
    from lammps_plugins_tpu_torch.fixes.base import Fix

    class Faulty(Fix):
        def post_force(self, state, ctx):
            if ctx.shard == shard:
                if hang is None:
                    raise _Boom(f"shard {shard} fails")
                hang.wait(60.0)
            return state
    return Faulty()


@pytest.mark.parametrize("mode", ["raises", "hangs"])
def test_a_failing_shard_raises_without_a_hang(mode):
    """A shard that raises in the middle of a step makes run() raise that
    error; one that hangs makes it raise TimeoutError within the engine's
    timeout; the other shards' threads end either way."""
    import threading
    import time
    from lammps_plugins_tpu_torch.convert import state_from_numpy
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    hang = threading.Event() if mode == "hangs" else None
    se = _port_engine(state_from_numpy(_jax_state(SLABS)), SLABS["grid"],
                      "per_device", fixes=[FixNVE(), _faulty(2, hang)])
    se._setup_forces()
    se.lockstep.timeout = 2.0
    before = threading.active_count()
    t0 = time.monotonic()
    try:
        with pytest.raises(_Boom if hang is None else TimeoutError):
            se.run(10)
        assert time.monotonic() - t0 < 30.0
    finally:
        if hang is not None:
            hang.set()
    deadline = time.monotonic() + 30.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
