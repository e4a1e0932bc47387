"""velocity create and set type/fraction (port of
lammps_plugins_tpu/fixes/velocity.py).

Both run on the host in numpy, exactly as the JAX package runs them, so
the two packages start from the same velocities and the same atom types:
velocity_create draws with np.random.default_rng(seed) (uniform in
[-1/2, 1/2) scaled by 1/sqrt(m), momentum and optionally rotation zeroed,
exact rescale to T); set_type_fraction hashes the coordinates in the
state's own float type (float32 numpy for a float32 state, as JAX hashes
np.asarray(state.x)).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.state import State
from ..core.units import UnitSystem


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def velocity_create(state: State, units: UnitSystem, t_target: float,
                    seed: int, dist: str = "uniform",
                    zero_momentum: bool = True,
                    zero_rotation: bool = False,
                    group_mask=None,
                    extra_dof: int = 3) -> State:
    """`velocity <group> create T seed [dist ...] [mom ...] [rot ...]`.

    zero_rotation implements `rot yes` (LAMMPS Velocity::zero_rotation):
    subtract the rigid-body rotation omega x r about the group's center of
    mass, with omega from the inertia tensor.  group_mask restricts
    creation (and the momentum/rotation zeroing and rescale) to a subset.
    """
    rng = np.random.default_rng(seed)
    n = state.natoms
    m_full = _np(state.per_atom_mass)
    sel = (np.ones(n, bool) if group_mask is None
           else np.asarray(group_mask, bool))
    m = np.where(sel, m_full, 0.0)
    ng = int(sel.sum())

    if dist == "uniform":
        raw = rng.uniform(-0.5, 0.5, size=(n, 3))
    elif dist == "gaussian":
        raw = rng.normal(size=(n, 3))
    else:
        raise ValueError(f"Unknown velocity distribution {dist!r}")
    # per-atom 1/sqrt(m) scaling so each atom carries ~equal kinetic energy
    v = raw / np.sqrt(m_full)[:, None]
    v[~sel] = 0.0

    if zero_momentum:
        p = (m[:, None] * v).sum(axis=0) / m.sum()
        v[sel] -= p[None, :]

    if zero_rotation:
        x = _np(state.x).astype(np.float64)
        com = (m[:, None] * x).sum(axis=0) / m.sum()
        r = x - com
        L = (m[:, None] * np.cross(r, v)).sum(axis=0)
        rsq = (r * r).sum(axis=1)
        inertia = np.zeros((3, 3))
        for a in range(3):
            for b in range(3):
                inertia[a, b] = (m * ((rsq if a == b else 0.0)
                                      - r[:, a] * r[:, b])).sum()
        omega = np.linalg.solve(inertia, L)
        v[sel] -= np.cross(omega[None, :], r[sel])

    # exact rescale to the target temperature (group dof)
    dof = 3 * ng - extra_dof
    ke2 = units.mvv2e * float((m[:, None] * v * v).sum())
    t_now = ke2 / (dof * units.boltz)
    v[sel] *= np.sqrt(t_target / t_now)

    v_out = _np(state.v).astype(np.float64)
    v_out[sel] = v[sel]
    return state.replace(v=torch.as_tensor(v_out, dtype=state.x.dtype,
                                           device=state.x.device))


def set_type_fraction(state: State, newtype: int, fraction: float,
                      seed: int, region=None) -> State:
    """`set ... type/fraction newtype fraction seed` (sample.in:19).

    Deterministic per-atom decision from a hash of (seed, position), so
    the result is decomposition-independent like LAMMPS's
    coordinate-seeded RanPark reset in Set::selection (a statistically
    equivalent stream).  region: only atoms inside it (core/region.py,
    LAMMPS `set region ID type/fraction`)."""
    x = _np(state.x)
    # coordinate hash -> uniform [0, 1)
    h = np.abs(np.sin(x[:, 0] * 12.9898 + x[:, 1] * 78.233
                      + x[:, 2] * 37.719 + seed * 0.0001) * 43758.5453)
    u = h - np.floor(h)
    sel = u < fraction
    if region is not None:
        sel &= _np(region.inside(state.x))
    types = _np(state.type).copy()
    types[sel] = newtype
    return state.replace(type=torch.as_tensor(types, dtype=torch.int64,
                                              device=state.x.device))
