"""fix nve — velocity Verlet (LAMMPS FixNVE semantics).

initial_integrate: v += dtf * f / m ; x += dt * v
final_integrate:   v += dtf * f / m
"""

from __future__ import annotations

from ..core.state import State
from ..registry import register_fix_style
from .base import Fix, StepContext


@register_fix_style("nve")
class FixNVE(Fix):
    time_integrate = True

    def initial_integrate(self, state: State, ctx: StepContext) -> State:
        m = state.per_atom_mass[:, None]
        v = state.v + ctx.dtf * state.f / m
        return state.replace(x=state.x + ctx.dt * v, v=v)

    def final_integrate(self, state: State, ctx: StepContext) -> State:
        m = state.per_atom_mass[:, None]
        return state.replace(v=state.v + ctx.dtf * state.f / m)
