"""fix nve — velocity Verlet (port of lammps_plugins_tpu/fixes/nve.py;
LAMMPS FixNVE semantics).

initial_integrate: v += dtf * f / m ; x += dt * v
final_integrate:   v += dtf * f / m
"""

from __future__ import annotations

import numpy as np

from ..core.state import State
from ..registry import register_fix_style
from .base import Fix, StepContext


@register_fix_style("nve")
class FixNVE(Fix):
    time_integrate = True

    def __init__(self, group_mask=None):
        """group_mask: optional [N] bool — integrate only these atoms
        (LAMMPS `fix ID <group> nve`); None = all."""
        self.group_mask = (None if group_mask is None
                           else np.asarray(group_mask, bool))

    def setup(self, state: State, ctx: StepContext) -> State:
        self.group_sel(state)      # the mask reaches the device here
        return state

    def _kick(self, state: State, ctx: StepContext):
        """The half-kick dtf * f / m, zero outside the group."""
        dv = ctx.dtf * state.f / state.per_atom_mass[:, None]
        sel = self.group_sel(state)
        return dv if sel is None else sel.to(dv.dtype)[:, None] * dv

    def initial_integrate(self, state: State, ctx: StepContext) -> State:
        v = state.v + self._kick(state, ctx)
        dx = ctx.dt * v
        sel = self.group_sel(state)
        if sel is not None:
            dx = sel.to(dx.dtype)[:, None] * dx
        return state.replace(x=state.x + dx, v=v)

    def final_integrate(self, state: State, ctx: StepContext) -> State:
        return state.replace(v=state.v + self._kick(state, ctx))
