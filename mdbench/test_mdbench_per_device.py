"""The per-device cell on the CPU at a size a test can hold: config 5's
scene at (32, 8, 2) cells in eight x-slabs through the per-device
placement, against the plain reference in float64; x_ulp, which the cell
checks in x_max's place; the cell's three metric readers."""

import math

import pytest
import torch

import harness as H
import run as R

SEED = 2 ** 31 + 7
K = 10
READERS = ("collective_share", "peer_copy_ms_per_step", "redone_step_share")


def small(dtype=None):
    c = H.cell(H.bench_file(), "bulk8m-4chip")
    c["cfg"]["scene"].update(nx=32, ny=8, nz=2)
    if dtype is not None:
        c["cfg"]["dtype"] = dtype
    c["trf"].update(warmup_steps=K, rate_steps=K, window_seconds=0.0)
    return c


@pytest.fixture(scope="module")
def f64():
    """The program in float64 on eight CPU shards, k steps from the seed's
    inputs, and the reference's potential."""
    c = small("float64")
    inp = H.inputs(c["cfg"], SEED, "cpu")
    start = H.start_state(c["cfg"], inp)
    drv = H.find("drivers", "per_device").Driver(c, inp, "cpu",
                                                  log=lambda s: None)
    got = drv.start(K)
    assert len(set(map(str, drv.eng.group.devices))) == 1
    assert drv.eng.n_devices == 8
    drv.close()
    pot = H.reference_potential(c["cfg"], [torch.device("cpu")])
    return dict(c=c, inp=inp, start=start, got=got, pot=pot)


def test_per_device_follows_the_reference_in_float64(f64):
    """Forces and positions after k steps through the per-device
    placement equal the float64 reference's to rounding."""
    nums = H.compare(f64["c"]["cfg"], f64["inp"], f64["pot"], f64["start"],
                     f64["got"], K)
    assert nums["f_rms"] < 1e-9 and nums["f_max"] < 1e-8, nums
    assert nums["x_max"] < 1e-9 and nums["v_rms"] < 1e-9, nums


def _x_ulp(f64, got, control=False):
    drv = H.find("drivers", "per_device")
    states = dict(start=f64["start"], end=f64["start"])
    return drv.compare_outputs(f64["c"], f64["inp"], f64["pot"],
                               dict(start=got, end=got), states,
                               control)["x_ulp"]


def test_x_ulp_passes_a_sound_run_and_fails_the_others(f64):
    """x_ulp within its limit for the float64 program; past it for the
    reference in bfloat16 (the control) and for a state left unchanged."""
    limit = f64["c"]["trf"]["limits"]["x_ulp"]
    assert _x_ulp(f64, f64["got"]) < 1e-3 * limit
    assert _x_ulp(f64, f64["got"], control=True) > limit
    unchanged = dict(f64["got"], x=f64["start"]["x"])
    assert _x_ulp(f64, unchanged) > limit


def test_x_ulp_reads_a_crossed_period_as_the_programs_box(f64):
    """A row that crossed the x face during the check's steps: the
    program moved it by its own float32 box length, and its snapshot
    unwraps the new image with the float64 box; x_ulp reads the row where
    the program has it, as if it had not crossed."""
    inp = dict(f64["inp"], dtype=torch.float32)
    got = f64["got"]
    h = inp["h"].double()
    gap = float(h[0, 0] - h[0, 0].float().double())
    assert gap != 0.0
    a = int(got["x"][:, 0].abs().argmin())
    image, x = got["image"].clone(), got["x"].clone()
    image[a, 0] += 1
    x[a, 0] += gap
    crossed = dict(got, image=image, x=x)
    drv = H.find("drivers", "per_device")
    states = dict(start=f64["start"], end=f64["start"])

    def x_ulp(g):
        return drv.compare_outputs(f64["c"], inp, f64["pot"],
                                   dict(start=g, end=g), states,
                                   False)["x_ulp"]

    assert x_ulp(crossed) == pytest.approx(x_ulp(got), rel=1e-6, abs=1e-3)


def test_f32_spacing_is_the_float32_ulp_above_the_floor():
    sp = H.find("drivers", "per_device").f32_spacing
    c = torch.tensor([0.0, -0.3, 1.0, 1.5, -3.0, 4153.9, 4096.0],
                     dtype=torch.float64)
    want = [2.0 ** -23, 2.0 ** -23, 2.0 ** -23, 2.0 ** -23, 2.0 ** -22,
            2.0 ** -11, 2.0 ** -11]
    assert sp(c).tolist() == want
    a = torch.tensor(4153.9, dtype=torch.float32)
    assert float(torch.nextafter(a, torch.tensor(math.inf)) - a) == want[5]


def test_the_cell_runs_correct_and_reports_its_metrics():
    """A whole traced run of the small cell in the configuration's
    float32: correct, with the per-device metrics read."""
    out = R.run_cell(small(), H.bench_file(), SEED, 0.1, True, "cpu",
                     t_proc=H.now(), log=lambda s: None)
    assert out["correct"], out["checks"]
    assert "x_ulp" in out["checks"] and "x_max" not in out["checks"]
    m = out["metrics"]
    assert {"collective_share", "peer_copy_ms_per_step",
            "redone_step_share", "force_share"} <= set(m)
    assert m["force_share"]["value"] + m["collective_share"]["value"] \
        <= 100.0


def _rec(timers, steps=100, window_s=2.0):
    return dict(steps=steps, natoms=8, window_s=window_s, spans={},
                counts={}, timers=timers,
                trace=dict(cards={}, launch_calls=0, idle_gaps=[]))


def test_readers_on_synthetic_records():
    rd = {n: H.reader(n) for n in READERS}
    rec = _rec({"Comm.collective": 0.1, "Comm.copy": 0.02,
                "redone_steps": 10})
    assert rd["collective_share"](rec) == pytest.approx(5.0)
    assert rd["peer_copy_ms_per_step"](rec) == pytest.approx(0.2)
    assert rd["redone_step_share"](rec) == pytest.approx(10.0)
    assert rd["redone_step_share"](_rec({"redone_steps": 0})) == 0.0


def test_readers_read_nothing_without_their_spans():
    rec = _rec({"Pair": 1.0, "Pair.forces": 0.5})
    for name in READERS:
        assert H.reader(name)(rec) is None
