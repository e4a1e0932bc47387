"""fix langevin — Langevin thermostat (port of
lammps_plugins_tpu/fixes/langevin.py; LAMMPS FixLangevin semantics).

`fix ID group langevin Tstart Tstop damp seed` adds a friction and a
random force in post_force; it does not integrate (pair it with fix nve,
as LAMMPS requires):

    f += gamma1 * v + gamma2 * uniform(-0.5, 0.5)
    gamma1 = -m / (damp ftm2v),  gamma2 = sqrt(24 kB T(t) m mvv2e / (damp dt))

T(t) ramps linearly from Tstart to Tstop over the run, clipped to the
window.  The noise is the JAX package's draw for draw:
jax.random.uniform(fold_in(PRNGKey(seed), step), (N, 3), dtype, -0.5,
0.5) through core/threefry.py, with 32-bit words in float32 and 64-bit
words in float64.

The step that keys the draw and the ramp is the fix's own device count in
state.extras["langevin:<id>"]["step"] (State.step is a Python int, frozen
inside a captured CUDA graph), advanced in end_of_step, so each replay
draws fresh noise.  The ramp's window (begin_step, end_step), which the
script interpreter re-anchors at every `run`, is in capture_key.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import threefry
from ..core.state import State
from ..registry import register_fix_style
from .base import Fix, StepContext


@register_fix_style("langevin")
class FixLangevin(Fix):
    time_integrate = False

    def __init__(self, t_start: float, t_stop: float, damp: float,
                 seed: int, group_mask=None, fix_id: str = "langevin"):
        if damp <= 0.0:
            raise ValueError("fix langevin: damp must be > 0")
        if seed <= 0:
            raise ValueError("fix langevin: seed must be > 0")
        self.t_start = float(t_start)
        self.t_stop = float(t_stop)
        self.damp = float(damp)
        self.seed = int(seed)
        self.prng_key = threefry.prng_key(self.seed)
        self.key = f"langevin:{fix_id}"
        self.begin_step = 0
        self.end_step = 0
        self.group_mask = (None if group_mask is None
                           else np.asarray(group_mask, bool))

    def capture_key(self) -> tuple:
        return (self.t_start, self.t_stop, self.begin_step, self.end_step)

    def setup(self, state: State, ctx: StepContext) -> State:
        self.group_sel(state)      # the mask reaches the device here
        extras = dict(state.extras)
        extras[self.key] = {"step": torch.tensor(
            int(state.step), dtype=torch.int64, device=state.x.device)}
        return state.replace(extras=extras)

    def _sel(self, state: State) -> torch.Tensor:
        sel = self.group_sel(state)
        if sel is None:
            return state.x.new_ones((state.x.shape[0], 1))
        return sel.to(state.x.dtype)[:, None]

    def _t_target(self, state: State):
        """The ramp's target at the fix's device step (a Python float
        without a ramp).  The fraction is formed in float32 as the JAX
        package's compiled step forms it: its int32 step over an int
        becomes a float32 product with the float32 reciprocal of the
        window (XLA's rewrite of the division by a constant)."""
        if self.end_step <= self.begin_step:
            return self.t_start
        step = state.extras[self.key]["step"]
        inv = np.float32(1.0 / max(1, self.end_step - self.begin_step))
        delta = (step - self.begin_step).to(torch.float32) * float(inv)
        delta = torch.clamp(delta.to(state.x.dtype), 0.0, 1.0)
        return self.t_start + delta * (self.t_stop - self.t_start)

    def noise(self, state: State, ctx: StepContext | None = None
              ) -> torch.Tensor:
        """[N, 3] uniform(-0.5, 0.5) of the fix's current step.  On the
        sharded engine's stacked state (ctx.shards = (Pn, n_cap)) each
        block d draws its own [n_cap, 3] under fold_in(key, d), as each
        JAX shard does (JAX langevin.py:78-82); under the per-device
        placement shard d (ctx.shard) draws that block alone."""
        step = state.extras[self.key]["step"]
        key = threefry.fold_in(self.prng_key, step)
        dtype, dev = state.x.dtype, state.x.device
        if ctx is not None and ctx.shard is not None:
            key = threefry.fold_in(key, torch.full_like(step, ctx.shard))
        if ctx is None or ctx.shards is None:
            return threefry.uniform(key, tuple(state.v.shape), dtype,
                                    -0.5, 0.5, dev)
        n_shards, n_cap = ctx.shards
        return torch.cat([
            threefry.uniform(threefry.fold_in(key, torch.full_like(step, d)),
                             (n_cap, 3), dtype, -0.5, 0.5, dev)
            for d in range(n_shards)])

    def post_force(self, state: State, ctx: StepContext) -> State:
        u = ctx.units
        m = state.per_atom_mass[:, None]
        t_target = self._t_target(state)
        gamma1 = -m / (self.damp * u.ftm2v)
        gamma2 = torch.sqrt(24.0 * u.boltz * t_target * m * u.mvv2e
                            / (self.damp * ctx.dt))
        f = state.f + self._sel(state) * (gamma1 * state.v
                                          + gamma2 * self.noise(state, ctx))
        return state.replace(f=f)

    def end_of_step(self, state: State, ctx: StepContext) -> State:
        """Advance the fix's device step count (State.step's twin)."""
        extras = dict(state.extras)
        extras[self.key] = {"step": state.extras[self.key]["step"] + 1}
        return state.replace(extras=extras)
