"""The kernel plumbing of lammps_plugins_tpu_torch/ops/build.py that runs
without a card: the device dispatch rule, the argument checks every
wrapper makes before a launch, and the rebuild-when-stale rule of the
nvcc build."""

import os

import pytest
import torch

from lammps_plugins_tpu_torch.ops import build


def test_dispatch_rule_cpu_takes_twin_other_devices_raise():
    for dt in (torch.float32, torch.float64):
        assert build.use_kernel(torch.zeros(2, dtype=dt), "k") is False
    with pytest.raises(ValueError):
        build.use_kernel(torch.zeros(2, device="meta"), "k")


def test_check_rejects_what_a_kernel_cannot_take():
    t = torch.zeros((4, 6), dtype=torch.float32)
    cpu = torch.device("cpu")
    assert build.check(t, "t", (4, 6), torch.float32, cpu) == t.data_ptr()
    with pytest.raises(ValueError):
        build.check(t, "t", (6, 4), torch.float32, cpu)
    with pytest.raises(TypeError):
        build.check(t.double(), "t", (4, 6), torch.float32, cpu)
    with pytest.raises(ValueError):
        build.check(t.t(), "t", (6, 4), torch.float32, cpu)
    with pytest.raises(ValueError):
        build.check(t, "t", (4, 6), torch.float32, torch.device("meta"))
    with pytest.raises(RuntimeError):
        build.raise_on_error(1, "k")
    build.raise_on_error(0, "k")


def test_constant_vectors_are_uploaded_once_per_device_and_value():
    cpu = torch.device("cpu")
    a = build.device_constants((1.0, 2.5), cpu)
    assert a is build.device_constants((1.0, 2.5), cpu)
    assert a.dtype == torch.float32 and a.tolist() == [1.0, 2.5]
    assert build.device_constants((1.0, 3.5), cpu).tolist() == [1.0, 3.5]


def test_library_is_stale_until_newer_than_every_source(tmp_path,
                                                        monkeypatch):
    srcs = build.sources()
    assert {os.path.basename(s) for s in srcs} >= {
        "rebo.cu", "mirror.cu", "lj_cells.cu", "select_k.cu"}
    lib = tmp_path / "liblpt_kernels.so"
    monkeypatch.setattr(build, "LIB_PATH", str(lib))
    assert build._stale()                               # missing
    lib.write_bytes(b"")
    newest = max(os.path.getmtime(s) for s in srcs)
    os.utime(lib, (newest + 10, newest + 10))
    assert not build._stale()
    os.utime(lib, (newest - 10, newest - 10))
    assert build._stale()                               # a source is newer


def test_build_runs_one_nvcc_per_source_then_links(tmp_path, monkeypatch):
    """_build starts one compile per csrc/*.cu (all at once), links their
    objects into the library, removes the objects and returns the log."""
    calls = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'while [ $# -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi\n'
        '  shift\n'
        'done\n'
        'echo "ptxas info : fake"\n')
    fake.chmod(0o755)
    lib = tmp_path / "out" / "liblpt_kernels.so"
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(lib.parent))
    monkeypatch.setattr(build, "LIB_PATH", str(lib))
    log = build._build()
    lines = calls.read_text().splitlines()
    cus = [s for s in build.sources() if s.endswith(".cu")]
    compiles = [ln for ln in lines if " -c " in f" {ln} "]
    links = [ln for ln in lines if "-shared" in ln.split()]
    assert len(compiles) == len(cus) and len(links) == 1
    assert all("sm_90a" in ln for ln in lines)
    assert lib.read_text().strip() == "built"
    assert sorted(os.listdir(lib.parent)) == ["liblpt_kernels.so"]
    assert log.count("ptxas info") == len(cus) + 1
