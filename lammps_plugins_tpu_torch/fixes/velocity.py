"""velocity create (port of lammps_plugins_tpu/fixes/velocity.py).

Draws with np.random.default_rng(seed) exactly as the JAX package does,
so both packages start from the same velocities: uniform in [-1/2, 1/2)
scaled by 1/sqrt(m), linear momentum zeroed, exact rescale to T.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.state import State
from ..core.units import UnitSystem


def velocity_create(state: State, units: UnitSystem, t_target: float,
                    seed: int, dist: str = "uniform",
                    zero_momentum: bool = True,
                    extra_dof: int = 3) -> State:
    """`velocity all create T seed [dist uniform|gaussian] [mom yes|no]`."""
    rng = np.random.default_rng(seed)
    n = state.natoms
    m = state.per_atom_mass.detach().cpu().double().numpy()
    if dist == "uniform":
        raw = rng.uniform(-0.5, 0.5, size=(n, 3))
    elif dist == "gaussian":
        raw = rng.normal(size=(n, 3))
    else:
        raise ValueError(f"Unknown velocity distribution {dist!r}")
    v = raw / np.sqrt(m)[:, None]
    if zero_momentum:
        v -= ((m[:, None] * v).sum(axis=0) / m.sum())[None, :]
    dof = 3 * n - extra_dof
    t_now = units.mvv2e * float((m[:, None] * v * v).sum()) \
        / (dof * units.boltz)
    v *= np.sqrt(t_target / t_now)
    return state.replace(v=torch.as_tensor(v, dtype=state.x.dtype,
                                           device=state.x.device))
