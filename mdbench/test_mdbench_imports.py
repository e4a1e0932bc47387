"""Nothing under mdbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names are
compared whole (the port's name begins with the JAX package's)."""

import ast
import os

import harness as H

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_SIDE = {"jax", "jaxlib", "flax", "lammps_plugins_tpu"}
PROGRAM = "lammps_plugins_tpu_torch"


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax_or_the_jax_package():
    found = [(p, m) for p in sources() for m in top_level_imports(p)
             if m in JAX_SIDE]
    assert not found
    assert len(list(sources())) > 10


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    found = [(p, m) for p in sources() if p.startswith(ref)
             for m in top_level_imports(p) if m == PROGRAM]
    assert not found


def test_the_run_time_guard_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "lammps_plugins_tpu_torch_fake",
                        types.ModuleType("x"))
    assert not [m for m in H.loaded_forbidden()
                if m.startswith("lammps_plugins_tpu_torch")]
    monkeypatch.setitem(sys.modules, "lammps_plugins_tpu.core",
                        types.ModuleType("x"))
    assert "lammps_plugins_tpu.core" in H.loaded_forbidden()
