"""fix nvt temp T T t_damp: the program's FixNVT and the reference's
Nose-Hoover chain, which starts at rest (eta and eta_dot zero)."""

from __future__ import annotations

import torch


def program(fc: dict):
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    return FixNVT(fc["t_start"], fc["t_stop"], fc["t_damp"])


def reference(fc: dict):
    from integrate import NoseHooverChain
    if fc["t_stop"] != fc["t_start"]:
        raise ValueError("the reference's chain holds one temperature")
    return NoseHooverChain(fc["t_start"], fc["t_damp"])


def start(fc: dict, device) -> dict:
    f64 = dict(dtype=torch.float64, device=device)
    return dict(eta=torch.zeros(3, **f64), eta_dot=torch.zeros(4, **f64))


def snapshot(fc: dict, extras: dict) -> dict:
    """The chain's state from the program's extras (key nvt:<fix id>)."""
    chain = next(v for k, v in extras.items() if k.startswith("nvt:"))
    return dict(eta=chain["eta"].double().clone(),
                eta_dot=chain["eta_dot"].double().clone())


def deck(fc: dict, fid: str) -> str:
    return (f"fix {fid} all nvt temp {fc['t_start']!r} {fc['t_stop']!r} "
            f"{fc['t_damp']!r}")
