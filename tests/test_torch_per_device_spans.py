"""The per-device placement's spans and counters on the CPU: the force
calls and collectives of a segment stamped into each shard's slot and
booked as the mean over the shards (Pair.forces, Comm.collective,
Comm.copy, and the Comm row), and the host loop's discarded segments
counted once."""

import pytest
import torch
from torch_parity import SYNTH_REBO

SHARDS = 4


def _engine(skin=0.5, check_every=10, placement="per_device"):
    from lammps_plugins_tpu_torch import ShardedEngine
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    cpu = dict(dtype=torch.float64, device="cpu")
    st = velocity_create(rebomos_bulk(16, 8, 1, tilt_xy=0.0, **cpu),
                         units.METAL, 600.0, 3)
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"],
                             **cpu)
    return ShardedEngine(st, pair, [FixNVE()], units.METAL,
                         devices=["cpu"] * SHARDS, skin=skin,
                         check_every=check_every, placement=placement)


@pytest.fixture(scope="module")
def stamped():
    eng = _engine()
    eng.run(20)
    return eng


def test_stamped_spans_stay_within_the_wall(stamped):
    """Pair.forces + Comm.collective, each the mean over the shards, stay
    within the run's wall; the copies lie inside their collectives."""
    acc = stamped.timers.acc
    assert acc["Pair.forces"] > 0.0
    assert 0.0 < acc["Comm.copy"] <= acc["Comm.collective"]
    assert acc["Pair.forces"] + acc["Comm.collective"] <= \
        stamped.timers.wall


def test_comm_row_is_the_stamped_collectives(stamped):
    """The per-device Comm row is Comm.collective moved out of Pair (no
    probe of its own)."""
    acc = stamped.timers.acc
    assert acc["Comm"] > 0.0
    assert acc["Comm"] == pytest.approx(acc["Comm.collective"], rel=1e-12)
    assert "Comm" in stamped.timers.performance_summary(stamped.dt)


def test_slots_restart_with_each_run(stamped):
    """A run books only its own spans: the slots are zeroed at its
    start."""
    before = dict(stamped.timers.acc)
    stamped.run(10)
    acc = stamped.timers.acc
    grown = acc["Pair.forces"] - before["Pair.forces"]
    assert 0.0 < grown < before["Pair.forces"]


def test_a_discarded_segment_is_counted_once():
    """With a skin far below a segment's displacement, the run's first
    segment (on lists built before it, not pending) trips and is run
    again on fresh lists, whose segments are kept: one discarded segment
    of check_every steps, and the kept steps are the run's."""
    eng = _engine(skin=0.01)
    calls = []
    host_steps = eng._host_steps

    def counted(n):
        calls.append(n)
        return host_steps(n)
    eng._host_steps = counted
    eng.run(20)
    counts = eng.timers.counts
    assert eng.step == 20
    assert counts["redone_segments"] == 1
    assert counts["redone_steps"] == 10
    assert sum(calls) == 20 + counts["redone_steps"]
