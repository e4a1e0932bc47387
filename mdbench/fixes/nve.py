"""fix nve: the program's FixNVE; the reference's velocity Verlet needs
no thermostat and the fix keeps no state of its own."""

from __future__ import annotations


def program(fc: dict):
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    return FixNVE()


def reference(fc: dict):
    return None


def start(fc: dict, device) -> dict:
    return {}


def snapshot(fc: dict, extras: dict) -> dict:
    return {}


def deck(fc: dict, fid: str) -> str:
    return f"fix {fid} all nve"
