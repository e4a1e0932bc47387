"""The comparison that decides `correct`, driven through a whole run on
the CPU at a size a test can hold: the program passes; the control (the
reference in bfloat16 in the program's place) and each fault the cells can
have, planted under the timed path, fail."""

import re

import pytest
import torch

import harness as H
import run as R

SEED = 2 ** 31 + 7


def small(name):
    c = H.cell(H.bench_file(), name)
    if c["cfg"]["scene"]["kind"] == "mos2_monolayer":
        c["cfg"]["scene"].update(nx=8, ny=8)
    else:
        c["cfg"]["scene"].update(n=5)
    every = c["cfg"]["check_every"]
    c["trf"].update(warmup_steps=every, rate_steps=every, chunk_steps=every)
    if c["trf"]["driver"] == "script":
        # thermo rows every `every` steps, a frame every two periods
        c["trf"]["period_steps"] = 2 * every
        c["trf"]["outputs"] = [
            re.sub(r"^(thermo) \d+", rf"\1 {every}",
                   re.sub(r"^(dump \S+ \S+ \S+) \d+",
                          rf"\1 {2 * every}", ln))
            for ln in c["trf"]["outputs"]]
    return c


def run(c, **kw):
    return R.run_cell(c, H.bench_file(), SEED, 0.2, False, "cpu",
                      t_proc=H.now(), log=lambda s: None, **kw)


CELLS = ["mono-nvt", "lj-nve", "mono-deck"]


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct_and_the_control_is_not(name):
    ok = run(small(name))
    assert ok["correct"], ok["checks"]
    ctl = run(small(name), control=True)
    assert not ctl["correct"], ctl["checks"]
    assert list(ok)[-1] == "checks"


def _unchanged(monkeypatch):
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    for cls in (FixNVE, FixNVT):
        monkeypatch.setattr(cls, "initial_integrate", lambda s, st, c: st)
        monkeypatch.setattr(cls, "final_integrate", lambda s, st, c: st)


def _forces(monkeypatch, edit):
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCut
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    for cls in (PairLJCut, REBOMoS):
        orig = cls.forces

        def forces(self, *a, _orig=orig, **kw):
            return edit(_orig(self, *a, **kw))
        monkeypatch.setattr(cls, "forces", forces)


def _half_left_out(f):
    f = f.clone()
    f[f.shape[0] // 2:] = 0.0
    return f


def _one_altered(f):
    f = f.clone()
    f[3] = -f[3]
    return f


def _peratom_altered(monkeypatch):
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    orig = REBOMoS.energy_peratom

    def energy_peratom(self, *a, **kw):
        e = orig(self, *a, **kw).clone()
        e[5] = 2.0 * e[5]
        return e
    monkeypatch.setattr(REBOMoS, "energy_peratom", energy_peratom)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_faults_under_the_timed_path_are_not_correct(name, fault,
                                                     monkeypatch):
    if fault == "unchanged":
        _unchanged(monkeypatch)
    else:
        _forces(monkeypatch, _half_left_out if fault == "half"
                else _one_altered)
    out = run(small(name))
    assert not out["correct"], out["checks"]


def test_an_altered_output_of_the_deck_is_not_correct(monkeypatch):
    _peratom_altered(monkeypatch)
    out = run(small("mono-deck"))
    assert not out["correct"], out["checks"]
    assert out["checks"]["pe_atom"]["value"] > \
        out["checks"]["pe_atom"]["limit"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_small_run_on_the_card_is_correct(name, card):
    c = small(name)
    out = R.run_cell(c, H.bench_file(), SEED, 0.5, True, card,
                     t_proc=H.now(), log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
