"""Fix interface (port of lammps_plugins_tpu/fixes/base.py).

Hooks run in definition order as in Verlet::run; each maps State -> State
without writing tensors in place.  The Engine's device loop captures the
hooks in a CUDA graph, which replays their device work and nothing else:
a hook must compute from the state's tensors and the context's constants
only, never from a value it reads back from the device or that changes on
the host between steps.  A fix that cannot keep to this sets
`capturable = False`, and the device loop refuses it.
"""

from __future__ import annotations

import dataclasses

from ..core.state import State
from ..core.units import UnitSystem


@dataclasses.dataclass
class StepContext:
    """Static per-run parameters visible to every hook."""

    units: UnitSystem
    dt: float

    @property
    def dtf(self) -> float:
        """0.5 * dt * ftm2v — the half-kick prefactor."""
        return 0.5 * self.dt * self.units.ftm2v


class Fix:
    """Base fix: every hook is the identity."""

    name: str = "fix"
    time_integrate: bool = False
    capturable: bool = True

    def setup(self, state: State, ctx: StepContext) -> State:
        return state

    def initial_integrate(self, state: State, ctx: StepContext) -> State:
        return state

    def post_integrate(self, state: State, ctx: StepContext) -> State:
        return state

    def post_force(self, state: State, ctx: StepContext) -> State:
        return state

    def final_integrate(self, state: State, ctx: StepContext) -> State:
        return state

    def end_of_step(self, state: State, ctx: StepContext) -> State:
        return state
