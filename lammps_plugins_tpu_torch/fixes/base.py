"""Fix interface (port of lammps_plugins_tpu/fixes/base.py).

Hooks run in definition order as in Verlet::run; each maps State -> State
without writing tensors in place.  The Engine's device loop captures the
hooks in a CUDA graph, which replays their device work and nothing else:
a hook must compute from the state's tensors and the context's constants
only, never from a value it reads back from the device or that changes on
the host between steps.  Host values that the hooks read as constants and
that a caller may change between runs (a ramp's window) are listed by
`capture_key`, which is part of the device loop's key.  A fix that cannot
keep to this sets `capturable = False`, and the device loop refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.state import State
from ..core.units import UnitSystem


@dataclasses.dataclass
class StepContext:
    """Static per-run parameters visible to every hook.

    shards: (Pn, n_cap) when the hooks see the sharded engine's stacked
    state, Pn blocks of n_cap rows (JAX's `axis`; None on one device);
    natoms_global: the global atom count for degrees of freedom (None on
    one device); shard: the shard whose block alone the hooks see under
    the per-device placement (JAX's axis_index; None otherwise), and
    allreduce its cross-shard sum (parallel/collectives.ShardComm.psum)."""

    units: UnitSystem
    dt: float
    natoms_global: "int | None" = None
    shards: "tuple[int, int] | None" = None
    shard: "int | None" = None
    allreduce: "Callable | None" = None

    @property
    def dtf(self) -> float:
        """0.5 * dt * ftm2v — the half-kick prefactor."""
        return 0.5 * self.dt * self.units.ftm2v

    def asum(self, value):
        """Sum a per-shard scalar across shards (the MPI_Allreduce
        analogue, fix_bfield.cpp:545): the psum of every shard's value
        under the per-device placement; otherwise the identity, since a
        hook's sum already runs over every row, the stacked shards'
        included."""
        return value if self.allreduce is None else self.allreduce(value)


class Fix:
    """Base fix: every hook is the identity."""

    name: str = "fix"
    time_integrate: bool = False
    capturable: bool = True

    def setup(self, state: State, ctx: StepContext) -> State:
        return state

    def group_sel(self, state: State):
        """This fix's group as a bool tensor over the state's rows, or None
        for 'all' (LAMMPS `fix ID <group> style`).  The [N] mask is put on
        the device once and kept (a hook may not copy from the host inside
        a captured step).  Under the sharded engine the rows are migrating
        slab blocks whose identity is the global atom id in
        state.extras["__tag__"] (-1 on a pad row): the mask is gathered by
        tag, so membership travels with the atoms (JAX fixes/base.py:66)."""
        gm = getattr(self, "group_mask", None)
        if gm is None:
            return None
        on = self.__dict__.setdefault("_group_on", {})   # one per device
        cached = on.get(state.x.device)
        if cached is None:
            cached = on[state.x.device] = torch.as_tensor(
                np.asarray(gm, bool), device=state.x.device)
        tag = state.extras.get("__tag__")
        if tag is None:
            if gm.shape[0] != state.x.shape[0]:
                raise ValueError(f"group mask length {gm.shape[0]} does not "
                                 f"match state rows {state.x.shape[0]} and "
                                 "no row tags are present")
            return cached
        safe = torch.clamp(tag, 0, gm.shape[0] - 1)
        return (tag >= 0) & cached[safe]

    def capture_key(self) -> tuple:
        """The host values the hooks read as constants (a ramp's window
        and end points): the device loop captures anew when they change,
        so a graph never replays a stale window."""
        return ()

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

    def energy(self, state: State, ctx: StepContext):
        """compute_scalar() analogue: the fix's contribution to thermo."""
        return 0.0
