"""fix nvt, velocity create / set type/fraction and the AEAM NVT run of
the port against the JAX package (float64, CPU), and the device loop's
carrying of fix state (state.extras).

  * a 24-step NVT run (863 K, check every 6, skin 0.8) of the jiggled
    108-atom Al-Si cell with AEAM (tests/test_aeam.py's fused-loop case):
    the port's device loop (run eagerly on the CPU) against the JAX
    Engine's fused loop, thermo rows within 1e-8 relative, with and
    without a temperature ramp, and with a group mask;
  * the port's fused iteration against its own host loop, bit for bit (x,
    v, f, image, the chain state and its step count, the rebuilds), with
    a ramped FixNVT too;
  * a discarded span restores the chain state, and an in-loop rebuild plus
    a segment under NVT copy nothing from the host;
  * set_type_fraction picks JAX's sites in float32 and float64, alsi_sample
    builds JAX's scene, velocity_create with rot yes and a group matches;
  * FixNVT.energy and thermo_row(fix_energy=) match JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_plugins_tpu_torch import convert
from torch_parity import SYNTH_AEAM, rel_err

A = 4.045
CPU = dict(dtype=torch.float64, device="cpu")
COLUMNS = ("temp", "press", "pe", "ke", "etotal")


def _cell(nc=3, sites=(5, 17), kick=0.04, seed=3):
    """(positions, types) of the nc^3 fcc cell with Si at `sites`, kicked
    (normal, numpy seed), as tests/test_aeam.py builds it."""
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.lattice import (Lattice,
                                                       create_atoms_box)
    box = Box.orthogonal([A * nc] * 3, **CPU)
    pos, types = create_atoms_box(Lattice.fcc(A), box, [1, 1, 1, 1])
    types = np.asarray(types).copy()
    types[list(sites)] = 2
    pos = pos + np.random.default_rng(seed).normal(scale=kick,
                                                   size=pos.shape)
    return pos, types


def _half(n):
    return np.arange(n) % 2 == 0


def _fix_kw(variant, n):
    return dict(group_mask=_half(n)) if variant == "group" else {}


def _ramp(fix, variant):
    if variant == "ramp":
        fix.t_stop = 1100.0
        fix.begin_step, fix.end_step = 0, 24
    return fix


def jax_engine(variant="plain"):
    import jax.numpy as jnp
    from lammps_plugins_tpu.core import units
    from lammps_plugins_tpu.core.box import Box
    from lammps_plugins_tpu.core.state import State
    from lammps_plugins_tpu.fixes.nvt import FixNVT
    from lammps_plugins_tpu.fixes.velocity import velocity_create
    from lammps_plugins_tpu.potentials.aeam import AEAM
    from lammps_plugins_tpu.run.simulation import Engine
    pos, types = _cell()
    pair = AEAM.from_file(SYNTH_AEAM, ["Al", "Si"])
    st = State.create(x=jnp.asarray(pos), type=types,
                      box=Box.orthogonal([3 * A] * 3), mass=pair.masses)
    st = velocity_create(st, units.METAL, 863.0, seed=11)
    fix = _ramp(FixNVT(863.0, 863.0, 0.1, **_fix_kw(variant, len(pos))),
                variant)
    return Engine(st, pair, [fix], units.METAL, device_rebuild=True,
                  check_every=6, skin=0.8)


def port_engine(variant="plain", dtype=torch.float64):
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.aeam import AEAM
    from lammps_plugins_tpu_torch.run.simulation import Engine
    pos, types = _cell()
    pair = AEAM.from_file(SYNTH_AEAM, ["Al", "Si"], dtype=dtype,
                          device="cpu")
    st = State.create(x=pos, type=types,
                      box=Box.orthogonal([3 * A] * 3, dtype=dtype,
                                         device="cpu"),
                      mass=pair.masses)
    st = velocity_create(st, units.METAL, 863.0, seed=11)
    fix = _ramp(FixNVT(863.0, 863.0, 0.1, **_fix_kw(variant, len(pos))),
                variant)
    return Engine(st, pair, [fix], units.METAL, check_every=6, skin=0.8)


@pytest.fixture(scope="module", params=["plain", "ramp", "group"])
def runs(request):
    """24 steps, thermo every 6: the JAX fused loop and the port's device
    loop (eager on the CPU)."""
    je = jax_engine(request.param)
    je.fused_loop = True
    jrows = je.run(24, thermo_every=6)
    pe = port_engine(request.param)
    pe.fused_loop = True
    prows = pe.run(24, thermo_every=6)
    return je, jrows, pe, prows


@pytest.mark.parametrize("column", COLUMNS)
def test_nvt_thermo_rows_match_jax_fused_loop(runs, column):
    _, jrows, _, prows = runs
    assert [r["step"] for r in prows] == [int(r["step"]) for r in jrows] \
        == [0, 6, 12, 18, 24]
    for pr, jr in zip(prows, jrows):
        j = float(jr[column])
        assert abs(pr[column] - j) <= 1e-8 * max(abs(j), 1e-300), \
            (column, pr["step"])


def test_nvt_state_matches_jax_fused_loop(runs):
    je, _, pe, _ = runs
    assert int(je.state.step) == pe.state.step == 24
    # unwrapped: the two loops may wrap at other steps
    js, ps = je.state, pe.state
    jx = np.asarray(js.x) + np.asarray(js.image) @ js.box.h_np()
    assert rel_err(ps.box.unmap(ps.x, ps.image).numpy(), jx) < 1e-9
    assert rel_err(ps.v.numpy(), js.v) < 1e-9
    jc = je.state.extras["nvt:nvt"]
    pc = pe.state.extras["nvt:nvt"]
    # the JAX fused loop's ramp fraction is float32 (its traced int32 step
    # divided by an int), the port's the state's float64: the chain feels
    # it at ~3e-8 relative
    bar = 1e-7 if pe.fixes[0].end_step else 1e-9
    for k in ("eta", "eta_dot"):
        assert rel_err(pc[k].numpy(), jc[k]) < bar
    assert int(pc["step"]) == 24


@pytest.mark.parametrize("variant", ["plain", "ramp"])
def test_fused_iteration_equals_host_loop_bit_for_bit(variant):
    engines = {}
    for fused in (True, False):
        eng = port_engine(variant)
        eng.fused_loop = fused
        eng.run(24)
        engines[fused] = eng
    f, h = engines[True], engines[False]
    assert f.state.step == h.state.step == 24
    assert f.rebuilds == h.rebuilds
    for a in ("x", "v", "f", "image"):
        assert torch.equal(getattr(f.state, a), getattr(h.state, a)), a
    fc, hc = f.state.extras["nvt:nvt"], h.state.extras["nvt:nvt"]
    for k in ("eta", "eta_dot", "step"):
        assert torch.equal(fc[k], hc[k]), k
    if variant == "ramp":
        fix = f.fixes[0]
        assert float(fix._t_target(f.state)) == pytest.approx(1100.0)


def test_discarded_span_restores_the_chain_state():
    """The loop's snapshot covers the extras: restore() after a span puts
    the chain and its step count back to what start() loaded."""
    eng = port_engine()
    eng.fused_loop = True
    eng.run(12)
    loop = eng._device_loop()
    before = {k: v.clone() for k, v in eng.state.extras["nvt:nvt"].items()}
    st = loop.start(eng.state, eng.nbr, False, eng._seg_dprev)
    loop.replay(2)
    moved = st.extras["nvt:nvt"]
    assert not torch.equal(moved["eta_dot"], before["eta_dot"])
    assert int(moved["step"]) == int(before["step"]) + 12
    loop.restore()
    for k, v in before.items():
        assert torch.equal(st.extras["nvt:nvt"][k], v), k


def test_in_loop_overflow_keeps_the_host_loop_trajectory():
    """A fine-cell capacity too small for the in-loop rebuild: the span
    (chain state included) is discarded and run again, ending on the host
    loop's trajectory."""
    host = port_engine()
    host.run(24)
    eng = port_engine()
    eng.fused_loop = True
    eng.rebuild_neighbors()
    eng._plan = dataclasses.replace(eng._plan, cand_capacity=2)
    eng._pending_rebuild = True          # the first iteration rebuilds
    eng.run(24)
    assert eng._plan.cand_capacity > 2
    assert eng.state.step == 24
    assert rel_err(eng.state.v.numpy(), host.state.v.numpy()) < 1e-12
    for k in ("eta", "eta_dot"):
        assert rel_err(eng.state.extras["nvt:nvt"][k].numpy(),
                       host.state.extras["nvt:nvt"][k].numpy()) < 1e-12
    assert int(eng.state.extras["nvt:nvt"]["step"]) == 24


def test_loop_refuses_a_step_that_reshapes_extras():
    from lammps_plugins_tpu_torch.fixes.base import Fix

    class Grow(Fix):
        def end_of_step(self, state, ctx):
            return state.replace(extras=dict(state.extras,
                                             grow=state.x.new_zeros(3)))

    eng = port_engine()
    eng.fixes.append(Grow())
    eng.fused_loop = True
    with pytest.raises(RuntimeError, match="extras"):
        eng.run(6)


_SPIED = [(torch, "tensor"), (torch, "as_tensor"), (torch.Tensor, "cpu"),
          (torch.Tensor, "item"), (torch.Tensor, "tolist"),
          (torch.Tensor, "__float__"), (torch.Tensor, "__int__"),
          (torch.Tensor, "__bool__")]


@pytest.mark.parametrize("variant", ["plain", "ramp", "group"])
def test_rebuild_and_nvt_segment_copy_nothing_from_the_host(variant):
    eng = port_engine(variant)
    eng.fused_loop = True
    eng.run(6)
    loop = eng._device_loop()
    eng.state = loop.start(eng.state, eng.nbr, True, 0.0)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for owner, name in _SPIED:
            real = getattr(owner, name)

            def spy(*a, _real=real, _name=name, **k):
                calls.append(_name)
                return _real(*a, **k)

            mp.setattr(owner, name, spy)
        loop._rebuild()
        loop._segment()
    assert calls == []
    assert int(loop.n_rb) == 1 and int(loop.done) == 6


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_set_type_fraction_and_scene_match_jax(dtype):
    import jax.numpy as jnp
    from lammps_plugins_tpu.api.scenes import alsi_sample as jscene
    from lammps_plugins_tpu.fixes.velocity import set_type_fraction as jstf
    from lammps_plugins_tpu_torch.api.scenes import alsi_sample
    from lammps_plugins_tpu_torch.fixes.velocity import set_type_fraction
    jdt, pdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.float64, torch.float64))
    js = jscene(nc=10, dtype=jdt)
    ps = alsi_sample(nc=10, dtype=pdt, device="cpu")
    np.testing.assert_array_equal(ps.x.numpy(), np.asarray(js.x))
    np.testing.assert_array_equal(ps.type.numpy(), np.asarray(js.type))
    assert int((ps.type == 2).sum()) > 0
    np.testing.assert_array_equal(
        set_type_fraction(ps, 2, 0.3, 77).type.numpy(),
        np.asarray(jstf(js, 2, 0.3, 77).type))


def test_velocity_create_rot_and_group_match_jax():
    import jax.numpy as jnp
    from lammps_plugins_tpu.core import units as jun
    from lammps_plugins_tpu.core.box import Box as JBox
    from lammps_plugins_tpu.core.state import State as JState
    from lammps_plugins_tpu.fixes.velocity import velocity_create as jvc
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    pos, types = _cell()
    mass = np.array([0.0, 26.98, 28.0855])
    js = JState.create(x=jnp.asarray(pos), type=types,
                       box=JBox.orthogonal([3 * A] * 3), mass=mass)
    ps = State.create(x=pos, type=types,
                      box=Box.orthogonal([3 * A] * 3, **CPU), mass=mass)
    for kw in (dict(zero_rotation=True), dict(group_mask=_half(len(pos))),
               dict(zero_rotation=True, group_mask=_half(len(pos)),
                    dist="gaussian")):
        jv = np.asarray(jvc(js, jun.METAL, 500.0, 9, **kw).v)
        pv = velocity_create(ps, units.METAL, 500.0, 9, **kw).v.numpy()
        assert rel_err(pv, jv) < 1e-13


@pytest.mark.parametrize("variant", ["plain", "ramp", "group"])
def test_fix_energy_and_thermo_row_match_jax(variant):
    """FixNVT.energy on the chain state of the JAX run (ramp: at its step
    count), and thermo_row with that energy."""
    from lammps_plugins_tpu.run.thermo import thermo_row as jrow
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.base import StepContext
    from lammps_plugins_tpu_torch.run.thermo import thermo_row
    je = jax_engine(variant)
    je.run(12)
    jfix, js = je.fixes[0], je.state
    je_e = float(jfix.energy(js, je.ctx))
    pe = port_engine(variant)
    pfix = pe.fixes[0]
    ps = convert.state_from_numpy(js)
    jc = js.extras["nvt:nvt"]
    ps = ps.replace(extras={"nvt:nvt": {
        "eta": torch.as_tensor(np.array(jc["eta"])),
        "eta_dot": torch.as_tensor(np.array(jc["eta_dot"])),
        "step": torch.tensor(int(js.step))}})
    ctx = StepContext(units=units.METAL, dt=units.METAL.dt)
    pe_e = pfix.energy(ps, ctx)
    # a ramp makes JAX's target temperature float32 (a traced int32 step
    # divided by an int), and the chain masses with it; the port's is the
    # state's float64
    bar = 1e-7 if variant == "ramp" else 1e-12
    assert abs(float(pe_e) - je_e) <= bar * abs(je_e) and je_e != 0.0
    jep, jw = je.evaluate()
    prow = thermo_row(ps, torch.tensor(float(jep), dtype=torch.float64),
                      torch.as_tensor(np.array(jw)), units.METAL,
                      fix_energy=pe_e)
    jr = jrow(js, jep, jw, je.units, fix_energy=jfix.energy(js, je.ctx))
    for k in ("pe", "etotal", "temp", "press"):
        assert abs(prow[k] - float(jr[k])) <= bar * abs(float(jr[k]))
