"""The port's timing system (run/timers.py) on the CPU, float64.

  * a section's dotted parts stay inside its time, a section opened
    inside another (or `inner` seconds) keeps its time from the outer one,
    and the performance summary's Other counts the five sections only;
  * each section opens a host op `lpt.<key>` that torch.profiler records;
  * an Engine.run books Neigh and Pair.forces, through the device loop's
    iteration and through the host loop;
  * the device loop's eager iteration stamps one rebuild span per rebuild
    it takes (n_rb), and the spans' seconds reach Neigh;
  * a Script deck with `dump custom` books Output.thermo and the frames'
    Output.dump.compute, .copy and .text inside Output, and the frame's
    text is what a DumpWriter writes on its own;
  * the benchmark's readers of these spans (mdbench/metrics/rebuild_share,
    force_share, dump_text_share) read a number from a CPU deck's window.

The card's side (the stamps inside the captured loop, the one copy per
read) is in tests/test_torch_cuda.py.
"""

import importlib.util
import os
import time

import pytest
import torch

from test_torch_script import LJ_SETUP

CPU = dict(dtype=torch.float64, device="cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMP_COLUMNS = "id type x y z vx vy vz"


def _lj_engine(fused):
    from lammps_plugins_tpu_torch.api.scenes import lj_melt
    eng = lj_melt(4, **CPU).engine()
    eng.fused_loop = fused
    return eng


def test_parts_stay_inside_their_section():
    from lammps_plugins_tpu_torch.run.timers import Timers
    tm = Timers()
    t0 = time.perf_counter()
    with tm.section("Pair"):
        time.sleep(0.01)
        with tm.section("Neigh"):
            time.sleep(0.02)
        tm.inner("Neigh", 0.004)
        with tm.section("Pair.capture"):
            time.sleep(0.005)
    wall = time.perf_counter() - t0
    with tm.section("Output"):
        with tm.section("Output.thermo"):
            time.sleep(0.005)
        with tm.section("Output.dump.text"):
            time.sleep(0.01)
    acc = tm.acc
    assert acc["Neigh"] >= 0.024
    assert 0.01 <= acc["Pair"] <= wall - acc["Neigh"] + 1e-9
    assert abs(acc["Pair"] + acc["Neigh"] - wall) < 2e-3
    assert acc["Pair.capture"] <= acc["Pair"]
    assert acc["Output.thermo"] + acc["Output.dump.text"] <= acc["Output"]


def test_sections_open_host_ranges_for_the_profiler():
    """Each section and part shows in a torch.profiler trace as a host op
    named lpt.<key>, not as a user annotation (which the trace would
    mirror on the device's timeline over the kernels inside it)."""
    from torch.profiler import ProfilerActivity, profile
    from lammps_plugins_tpu_torch.run.timers import Timers
    tm = Timers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tm.section("Output"), tm.section("Output.dump.text"):
            torch.ones(4).sum()
    got = {e.name(): e.is_user_annotation()
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("lpt.")}
    assert got == {"lpt.Output": False, "lpt.Output.dump.text": False}


def test_summary_other_counts_the_sections_only():
    from lammps_plugins_tpu_torch.run.timers import Timers
    tm = Timers()
    tm.start_run(100)
    tm.end_run(10)
    tm.wall = 2.0
    tm.acc.update({"Pair": 1.0, "Neigh": 0.5, "Output": 0.25,
                   "Pair.forces": 0.8, "Pair.capture": 0.1,
                   "Output.thermo": 0.05, "Output.dump.text": 0.2})
    rows = {}
    for line in tm.performance_summary(0.001).splitlines():
        cells = [c.strip() for c in line.split("|")]
        if len(cells) == 3 and cells[0] != "Section":
            rows[cells[0]] = float(cells[1])
    assert rows == {"Pair": 1.0, "Neigh": 0.5, "Comm": 0.0, "Output": 0.25,
                    "Other": 0.25}


@pytest.mark.parametrize("fused", [True, False], ids=["device", "host"])
def test_engine_run_books_neigh_and_pair_forces(fused):
    eng = _lj_engine(fused)
    eng.run(100)
    acc = eng.timers.acc
    assert eng.rebuilds >= 2
    assert acc["Neigh"] > 0.0
    assert 0.0 < acc["Pair.forces"] <= acc["Pair"]
    assert (eng._loop is not None) == fused


def test_device_loop_stamps_one_rebuild_span_per_n_rb(monkeypatch):
    from lammps_plugins_tpu_torch.run import timers
    stamps = []
    real = timers.stamp

    def spy(slot, sign):
        stamps.append((slot.data_ptr(), sign))
        real(slot, sign)

    monkeypatch.setattr(timers, "stamp", spy)
    eng = _lj_engine(True)
    spans = []
    after = eng._after_span

    def record(res):
        spans.append(res)
        after(res)

    eng._after_span = record
    eng.run(100)
    n_rb = sum(r.n_rb for r in spans)
    assert n_rb >= 2
    slot = eng._loop.rebuild_ns.data_ptr()
    mine = [s for p, s in stamps if p == slot]
    assert mine == [-1, 1] * n_rb
    forces = [s for p, s in stamps if p == eng._loop.forces_ns.data_ptr()]
    assert len(forces) >= 2 * 100 and forces[:2] == [-1, 1]
    in_loop = sum(r.rebuild_s for r in spans)
    assert 0.0 < in_loop <= eng.timers.acc["Neigh"]


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    """An LJ deck on the CPU with thermo rows and a custom dump: (Script,
    dump path, the last run's window: its timers and wall seconds)."""
    from lammps_plugins_tpu_torch import Script
    path = str(tmp_path_factory.mktemp("trace") / "lj.dump")
    s = Script(log=lambda text: None, **CPU)
    s.run_text(LJ_SETUP + f"""
velocity        all create 1.44 87287
fix             1 all nve
thermo          10
dump            1 all custom 20 {path} {DUMP_COLUMNS}
run             20
""")
    acc0 = dict(s.engine.timers.acc)
    t0 = time.perf_counter()
    s.command("run 100")
    window_s = time.perf_counter() - t0
    timers = {k: v - acc0.get(k, 0.0)
              for k, v in s.engine.timers.acc.items()}
    return s, path, dict(timers=timers, window_s=window_s, steps=100)


def test_deck_books_thermo_and_dump_parts(deck):
    s, _, window = deck
    acc = s.engine.timers.acc
    parts = ("Output.thermo", "Output.dump.compute", "Output.dump.copy",
             "Output.dump.text")
    assert all(acc[k] > 0.0 for k in parts)
    assert sum(acc[k] for k in parts) <= acc["Output"]
    assert window["timers"]["Output.dump.text"] > 0.0


def test_deck_frame_text_is_the_writers_own(deck, tmp_path):
    from lammps_plugins_tpu_torch.run.dump import DumpWriter
    s, path, _ = deck
    w = DumpWriter(str(tmp_path / "one.dump"), columns=DUMP_COLUMNS.split())
    w.write(s.engine.state)
    w.close()
    text = open(path).read()
    frame = "ITEM: TIMESTEP" + text.rsplit("ITEM: TIMESTEP", 1)[1]
    assert s.engine.state.step == 120
    assert frame == open(tmp_path / "one.dump").read()


@pytest.mark.parametrize("name", ["rebuild_share", "force_share",
                                  "dump_text_share"])
def test_benchmark_readers_read_a_cpu_window(deck, name):
    _, _, window = deck
    path = os.path.join(ROOT, "mdbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    v = mod.read(dict(window, natoms=256, spans={}, counts={},
                      trace=dict(cards={}, launch_calls=0, idle_gaps=[])))
    assert isinstance(v, float) and 0.0 < v < 100.0
