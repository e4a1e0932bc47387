"""The port's device loop (run/device_loop.py) on the CPU, float64.

On a CPU state `Engine.fused_loop = True` runs the device loop's iteration
eagerly (a Python branch where the card has a conditional node).  Held
against:

  * the JAX Engine's fused loop (`fused_loop=True`, f64) on the 288-atom
    scene at 600 K (seed 77), skin 0.4, check every 5, 40 steps: the same
    final step and in-loop rebuilds, x and v within 1e-9 relative;
  * the port's own host loop: the same rebuild steps, x, v and f equal
    bit for bit;
  * an in-loop overflow (a sabotaged fine-cell capacity) that discards the
    span and ends on the host loop's trajectory, and a K overflow
    recovery that widens the re-tightening headroom to 10;
  * a failure inside a span, which raises and never falls back;
  * a spy on host copies: one in-loop rebuild and one segment (fixes and
    forces) call no torch.tensor, torch.as_tensor, Tensor.cpu, .item,
    .tolist or scalar conversion once the plan exists;
  * callbacks at the JAX Engine's steps, and memory_usage's JAX keys.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from torch_parity import SYNTH_REBO, rel_err

CPU = dict(dtype=torch.float64, device="cpu")


def _port(temp=600.0, seed=77, scene="bulk", **kw):
    from lammps_plugins_tpu_torch.api.scenes import (
        rebomos_bulk, rebomos_bulk_commensurate)
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    st = (rebomos_bulk(**CPU) if scene == "bulk"
          else rebomos_bulk_commensurate(3, 4, 1, **CPU))
    st = velocity_create(st, units.METAL, temp, seed)
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], **CPU)
    return Engine(st, pair, [FixNVE()], units.METAL,
                  **{"check_every": 5, "skin": 0.4, **kw})


def _jax(temp=600.0, seed=77, scene="bulk", **kw):
    from lammps_plugins_tpu.api.scenes import (rebomos_bulk,
                                               rebomos_bulk_commensurate)
    from lammps_plugins_tpu.core import units
    from lammps_plugins_tpu.fixes.nve import FixNVE
    from lammps_plugins_tpu.fixes.velocity import velocity_create
    from lammps_plugins_tpu.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu.run.simulation import Engine
    import jax.numpy as jnp
    st = (rebomos_bulk() if scene == "bulk"
          else rebomos_bulk_commensurate(nx=3, ny=4, nz=1,
                                         dtype=jnp.float64))
    st = velocity_create(st, units.METAL, temp, seed=seed)
    return Engine(st, REBOMoS.from_file(SYNTH_REBO, ["M", "S"]), [FixNVE()],
                  units.METAL, device_rebuild=True,
                  **{"check_every": 5, "skin": 0.4, **kw})


def _count_in_loop_rebuilds(eng):
    """Record the in-loop rebuilds of each fused span that rebuilt: the
    port's through the span's result (res.n_rb), the JAX Engine's through
    the Pair -> Neigh transfer it makes per such span (n_rb x cost)."""
    seen = []
    if hasattr(eng, "_after_span"):            # the port
        after = eng._after_span

        def spy(res):
            if res.n_rb:
                seen.append(res.n_rb)
            after(res)

        eng._after_span = spy
    else:
        eng._rebuild_cost_estimate = lambda: 1.0
        eng.timers.transfer = lambda src, dst, s: seen.append(round(s))
    return seen


def _rebuild_steps(eng):
    """Steps at which the port Engine rebuilds: host rebuilds through
    rebuild_neighbors, in-loop ones through the loop's rebuild."""
    from lammps_plugins_tpu_torch.run.device_loop import DeviceLoop
    steps = []
    host = eng.rebuild_neighbors

    def spy_host():
        steps.append(eng.state.step)
        host()

    eng.rebuild_neighbors = spy_host
    real = DeviceLoop._rebuild

    def spy_loop(loop):
        steps.append(loop.step0 + int(loop.done))
        real(loop)

    return steps, (DeviceLoop, "_rebuild", spy_loop)


@pytest.fixture(scope="module")
def runs():
    """40 steps each: the JAX fused loop, the port's span loop and the
    port's host loop, with their rebuild records."""
    je = _jax()
    je.fused_loop = True
    j_rb = _count_in_loop_rebuilds(je)
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # no fallback to the host loop
        je.run(40)
    assert je.fused_loop is True
    out = {"jax": (je, j_rb)}
    for name, fused in (("span", True), ("host", False)):
        pe = _port()
        pe.fused_loop = fused
        rb = _count_in_loop_rebuilds(pe)
        steps, (cls, attr, spy) = _rebuild_steps(pe)
        mp = pytest.MonkeyPatch()
        mp.setattr(cls, attr, spy)
        try:
            pe.run(40)
        finally:
            mp.undo()
        out[name] = (pe, rb, steps)
    return out


def test_span_loop_matches_jax_fused_loop(runs):
    je, j_rb = runs["jax"]
    pe, p_rb, _ = runs["span"]
    assert int(je.state.step) == pe.state.step == 40
    assert p_rb == j_rb and sum(p_rb) >= 1     # in-loop rebuilds per span
    assert rel_err(pe.state.x.numpy(), je.state.x) < 1e-9
    assert rel_err(pe.state.v.numpy(), je.state.v) < 1e-9


def test_span_loop_matches_host_loop_bit_for_bit(runs):
    span, _, s_steps = runs["span"]
    host, _, h_steps = runs["host"]
    assert s_steps == h_steps and len(s_steps) >= 2
    assert span.rebuilds == host.rebuilds
    assert span.state.step == host.state.step == 40
    for a in ("x", "v", "f", "image"):
        assert torch.equal(getattr(span.state, a), getattr(host.state, a)), a


def _unwrapped(eng):
    st = eng.state
    return st.box.unmap(st.x, st.image).numpy()


def test_in_loop_overflow_discards_the_span():
    """A fine-cell capacity too small for the first in-loop rebuild (the
    lists' shapes do not change): the span is discarded, the plan
    re-sized, and the run ends on the host loop's trajectory."""
    host = _port(seed=31)
    host.run(30)
    eng = _port(seed=31)
    eng.fused_loop = True
    eng.rebuild_neighbors()
    eng._plan = dataclasses.replace(eng._plan, cand_capacity=2)
    retries = []
    real = eng._run_span_device

    def spy(nsteps, _retry=0):
        retries.append(_retry)
        return real(nsteps, _retry)

    eng._run_span_device = spy
    eng.run(30)
    assert eng._plan.cand_capacity > 2, "no overflow re-size happened"
    assert max(retries) >= 1, "no span was discarded"
    assert eng.state.step == 30
    assert rel_err(_unwrapped(eng), _unwrapped(host)) < 1e-12
    assert rel_err(eng.state.v.numpy(), host.state.v.numpy()) < 1e-12


def test_k_overflow_recovery_widens_headroom():
    """A REBO K cap below the true kmax: the recovery converges, widens the
    re-tightening headroom to 10, and later spans never re-tighten into
    overflow (the 863 K tug-of-war of JAX simulation.py:265-277)."""
    from lammps_plugins_tpu_torch.run.simulation import _quantize_k
    host = _port(seed=7)
    host.run(20)
    eng = _port(seed=7)
    eng.fused_loop = True
    eng.rebuild_neighbors()
    kmax = int(eng.nbr.lists["rebo"].mask.sum(dim=1).max())
    good = eng._plan
    eng._plan = dataclasses.replace(good, k_caps=tuple(
        (n, 8 if n == "rebo" else k) for n, k in good.k_caps))
    eng.rebuild_neighbors()
    assert dict(eng._plan.k_caps)["rebo"] >= kmax
    assert eng._k_headroom == 10
    eng.run(20)
    assert eng.state.step == 20
    assert dict(eng._plan.k_caps)["rebo"] >= _quantize_k(kmax)
    assert rel_err(_unwrapped(eng), _unwrapped(host)) < 1e-12


def test_failure_in_a_span_raises():
    """No fallback: an exception inside the device loop reaches the
    caller, and the Engine keeps its fused setting."""
    from lammps_plugins_tpu_torch.run.device_loop import DeviceLoop
    eng = _port(scene="small", temp=300.0)
    eng.fused_loop = True

    def boom(self, n):
        raise RuntimeError("synthetic replay failure")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DeviceLoop, "replay", boom)
        with pytest.raises(RuntimeError, match="synthetic replay failure"):
            eng.run(10)
    assert eng.fused_loop is True


_SPIED = [(torch, "tensor"), (torch, "as_tensor"), (torch.Tensor, "cpu"),
          (torch.Tensor, "item"), (torch.Tensor, "tolist"),
          (torch.Tensor, "__float__"), (torch.Tensor, "__int__"),
          (torch.Tensor, "__bool__")]


def test_rebuild_and_segment_copy_nothing_from_the_host():
    eng = _port(scene="small", temp=300.0)
    eng.fused_loop = True
    eng.run(5)                          # plan, tightening, the loop
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
    assert int(loop.n_rb) == 1 and int(loop.done) == 5


def test_callbacks_fire_at_the_jax_steps():
    """(every, fn) callbacks cap the spans; both Engines call them at step
    0 and at every multiple, with the same positions there."""
    seen = {"jax": [], "port": []}

    def rec(key):
        # unwrapped positions: the two loops may wrap at other steps
        return lambda st: seen[key].append((int(st.step), np.asarray(st.x)
                                            + np.asarray(st.image)
                                            @ st.box.h_np()))

    je = _jax(temp=300.0, scene="small")
    je.run(30, callbacks=[(10, rec("jax")), (15, rec("jax"))])
    pe = _port(temp=300.0, scene="small")
    pe.fused_loop = True
    pe.run(30, callbacks=[(10, rec("port")), (15, rec("port"))])
    steps = [s for s, _ in seen["port"]]
    assert steps == [s for s, _ in seen["jax"]] == [0, 0, 10, 15, 20, 30,
                                                     30]
    for (_, a), (_, b) in zip(seen["port"], seen["jax"]):
        assert rel_err(a, b) < 1e-9


#: the keys of the JAX Engine's memory_usage (simulation.py:641-647).  That
#: method raises on a REBOMoS engine (it sums `.size` over every attribute
#: with a `dtype`, and the pair's own `dtype` attribute is a type), so the
#: keys are taken from its source.
JAX_MEMORY_KEYS = {"state_mb", "neighbor_mb", "pair_tables_mb", "total_mb"}


def test_memory_usage_has_the_jax_keys():
    pe = _port(temp=300.0, scene="small")
    pe.fused_loop = True
    pe.run(5)
    mp = pe.memory_usage()
    assert JAX_MEMORY_KEYS <= set(mp)
    assert mp["state_mb"] > 0 and mp["neighbor_mb"] > 0
    assert mp["graph_mb"] > 0
    assert abs(mp["total_mb"] - sum(v for k, v in mp.items()
                                    if k != "total_mb")) < 1e-12
