"""Style registries of the PyTorch port.

Kept apart from ``lammps_plugins_tpu.registry``: that module's dicts are
process-wide and keyed by style name, so a process that imports both
packages (the parity tests) would otherwise hand the torch class to the
JAX package's script interpreter, or the reverse.
"""

from __future__ import annotations

from typing import Callable, Dict

PAIR_STYLES: Dict[str, Callable] = {}
FIX_STYLES: Dict[str, Callable] = {}


def register_pair_style(name: str):
    def deco(cls):
        PAIR_STYLES[name] = cls
        cls.name = name
        return cls
    return deco


def register_fix_style(name: str):
    def deco(cls):
        FIX_STYLES[name] = cls
        cls.name = name
        return cls
    return deco


def create_pair_style(name: str, *args, **kw):
    if name not in PAIR_STYLES:
        raise ValueError(f"Unknown pair style {name!r}; "
                         f"registered: {sorted(PAIR_STYLES)}")
    return PAIR_STYLES[name](*args, **kw)


def create_fix_style(name: str, *args, **kw):
    if name not in FIX_STYLES:
        raise ValueError(f"Unknown fix style {name!r}; "
                         f"registered: {sorted(FIX_STYLES)}")
    return FIX_STYLES[name](*args, **kw)
