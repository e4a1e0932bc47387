"""Thermo quantities (port of lammps_plugins_tpu/run/thermo.py).

LAMMPS conventions: T = sum(m v^2) mvv2e / (dof boltz), dof = 3N - 3;
P_ab = (sum m v_a v_b mvv2e + W_ab) / V * nktv2p, press = tr/3, where W is
the strain-derivative virial.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.state import State
from ..core.units import UnitSystem


def kinetic_tensor(state: State, units: UnitSystem) -> torch.Tensor:
    m = state.per_atom_mass
    v = state.v
    rows = [[torch.sum(m * v[:, a] * v[:, b]) for b in range(3)]
            for a in range(3)]
    return units.mvv2e * torch.stack([torch.stack(r) for r in rows])


def kinetic_energy(state: State, units: UnitSystem) -> torch.Tensor:
    m = state.per_atom_mass
    return 0.5 * units.mvv2e * torch.sum(m * torch.sum(state.v ** 2, dim=1))


def temperature(state: State, units: UnitSystem, extra_dof: int = 3):
    dof = 3 * state.natoms - extra_dof
    return 2.0 * kinetic_energy(state, units) / (dof * units.boltz)


def pressure_tensor(state: State, virial_w, units: UnitSystem):
    kin = kinetic_tensor(state, units)
    return (kin + virial_w) / state.box.volume * units.nktv2p


def pressure(state: State, virial_w, units: UnitSystem):
    """Scalar pressure: the trace of pressure_tensor over 3."""
    return torch.trace(pressure_tensor(state, virial_w, units)) / 3.0


def thermo_row(state: State, pe, virial_w, units: UnitSystem,
               fix_energy=0.0) -> dict:
    """Thermo row as Python numbers (one device-to-host copy).
    fix_energy (fix_modify energy yes) joins pe and etotal."""
    ke = kinetic_energy(state, units)
    pt = pressure_tensor(state, virial_w, units)
    h = state.box.h
    names = ("temp", "press", "pe", "ke", "etotal", "vol", "pxx", "pyy",
             "pzz", "pxy", "pxz", "pyz", "lx", "ly", "lz")
    vals = torch.stack([
        temperature(state, units), torch.trace(pt) / 3.0, pe + fix_energy,
        ke, pe + fix_energy + ke,
        state.box.volume, pt[0, 0], pt[1, 1], pt[2, 2],
        0.5 * (pt[0, 1] + pt[1, 0]), 0.5 * (pt[0, 2] + pt[2, 0]),
        0.5 * (pt[1, 2] + pt[2, 1]), h[0, 0], h[1, 1], h[2, 2]])
    row = dict(zip(names, vals.detach().cpu().tolist()))
    alpha, beta, gamma = state.box.cell_angles_deg_np()
    row.update(step=int(state.step), cellalpha=alpha, cellbeta=beta,
               cellgamma=gamma,
               vol=float(abs(np.linalg.det(state.box.h_np()))))
    return row
