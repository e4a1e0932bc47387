"""The benchmark is driven by data: every configuration, cell and
per-layer metric of BENCHMARK.json loads by name, and new ones are found
as new files and entries, with no edit to a file that is there."""

import json
import os
import re
import shutil

import pytest

import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return H.bench_file()


def test_benchmark_file_keeps_to_its_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["mdbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len({c["name"] for c in bench["configs"]}) == len(
        bench["configs"])
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        # each cell that reports a per-layer metric reports what it moves
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in H.end_to_end(bench, w)}
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_every_cell_loads_by_name(bench):
    for w in bench["workloads"]:
        c = H.cell(bench, w["name"])
        assert c["cfg"]["name"] == w["config"]
        assert c["chips"] in (1, 4)
        trf = c["trf"]
        assert H.find("drivers", trf["driver"]).Driver
        assert H.find("scenes", c["cfg"]["scene"]["kind"]).make
        assert H.find("styles", c["cfg"]["pair"]["style"]).program
        assert all(mod.program for _, mod in H.fix_modules(c["cfg"]))
        assert trf["limits"] and all(v > 0 for v in trf["limits"].values())
        steps = [trf[key] for key in ("chunk_steps", "period_steps")
                 if key in trf]
        for n in steps + [trf["check_steps"]]:
            assert n % c["cfg"]["check_every"] == 0
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        e2e = {m["name"] for m in H.end_to_end(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert H.per_layer(bench, w["name"])


def test_every_metric_reader_loads_and_reads_nothing_from_nothing(bench):
    empty = dict(steps=0, natoms=0, window_s=0.0, spans={}, counts={},
                 timers={}, trace=dict(cards={}, launch_calls=0,
                                       idle_gaps=[]))
    for m in bench["per_layer"]:
        assert H.reader(m["name"])(empty) is None


def test_configuration_files_state_what_they_run(bench):
    for c in bench["configs"]:
        cfg = H.load_json(H.ROOT, c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["list_rule"] in ("exact", "every")
        assert cfg["dtype"] == "float32"
        if "file" in cfg["pair"]:
            assert cfg["pair"]["file"].startswith("mdbench/")


DUMMY = {
    "scenes/dummy_sc.py": """
import torch


def make(n, a, device):
    r = torch.arange(n, dtype=torch.float64, device=device)
    x = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1)
    x = x.reshape(-1, 3) * a
    types = torch.ones(len(x), dtype=torch.int64, device=device)
    return x, types, torch.eye(3, dtype=torch.float64, device=device) * n * a
""",
    "styles/dummy_soft.py": """
def program(pc, root, dtype, device):
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCut
    pair = PairLJCut(pc["cutoff"], ntypes=1, dtype=dtype, device=device)
    pair.set_coeff(1, 1, pc["epsilon"], pc["sigma"], pc["cutoff"])
    return pair


def reference(pc, root, device):
    from ljcut import LJCut
    return LJCut(pc["cutoff"], pc["epsilon"], pc["sigma"])
""",
    "fixes/dummy_nve.py": """
def program(fc):
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    return FixNVE()


def reference(fc):
    return None


def start(fc, device):
    return {}


def snapshot(fc, extras):
    return {}
""",
    "drivers/dummy_engine.py": """
import harness as H


class Driver(H.find("drivers", "engine").Driver):
    pass
""",
    "metrics/dummy_metric.py": """
def read(rec):
    return 42.0 if rec["steps"] else None
""",
}


def test_new_files_and_entries_are_found_without_edits(tmp_path, bench):
    """A configuration with a new scene kind, pair style and fix, a cell
    with a new driver, and a new per-layer metric, each added as files
    and entries, run through a whole (traced) run on the CPU; no file
    that was there changes."""
    import run as R
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(H.ROOT, "mdbench"), root / "mdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))

    def files():
        return {p: p.read_bytes() for p in (root / "mdbench").rglob("*")
                if p.is_file()}
    before = files()
    for rel, text in DUMMY.items():
        (root / "mdbench" / rel).write_text(text.lstrip())
    cfg = dict(name="dummy-config", scene=dict(kind="dummy_sc", n=4, a=1.1),
               masses=[1.0], units="lj", dtype="float32", dt=0.005,
               pair=dict(style="dummy/soft", cutoff=2.0, epsilon=1.0,
                         sigma=1.0),
               fixes=[dict(style="dummy_nve")], temperature=0.5, skin=0.3,
               check_every=10, list_rule="exact", reduced=[])
    (root / "mdbench" / "configs" / "dummy-config.json").write_text(
        json.dumps(cfg))
    trf = dict(driver="dummy_engine", warmup_steps=10, rate_steps=10,
               chunk_steps=10, check_steps=10,
               limits=dict(f_rms=1e-3, f_max=1e-2, x_max=1e-3, v_rms=1e-3))
    (root / "mdbench" / "workloads" / "dummy-traffic.json").write_text(
        json.dumps(trf))
    new = json.loads(json.dumps(bench))
    new["configs"].append(dict(name="dummy-config", source="a test",
                               file="mdbench/configs/dummy-config.json",
                               reduced=[]))
    new["workloads"].append(dict(name="dummy-cell", config="dummy-config",
                                 traffic="dummy-traffic", chips=1,
                                 why="a dummy"))
    new["per_layer"].append(dict(name="dummy_metric", unit="%",
                                 better="higher", source="program_counter",
                                 layer="Engine", moves="atom_steps_per_s",
                                 workloads=["dummy-cell"]))
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    b = H.bench_file(root)
    c = H.cell(b, "dummy-cell", root=root)
    assert c["cfg"]["name"] == "dummy-config"
    assert [m["name"] for m in H.per_layer(b, "dummy-cell")] == [
        "dummy_metric"]
    out = R.run_cell(c, b, 2 ** 31 + 11, 0.1, True, "cpu", t_proc=H.now(),
                     log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["metrics"] == {"dummy_metric": {"value": 42.0, "unit": "%"}}
    after = files()
    for p, data in before.items():
        assert after[p] == data
