"""fix nvt — Nose-Hoover chain thermostat (port of
lammps_plugins_tpu/fixes/nvt.py; LAMMPS FixNH semantics).

The Martyna-Tobias-Klein chain update of LAMMPS `fix nvt temp Tstart Tstop
Tdamp` with the defaults of USER-AEAM/sample.in:25: mtchain=3,
nc_tchain=1, drag=0.

The chain state lives in state.extras["nvt:<id>"] as device tensors: eta
[mtchain], eta_dot [mtchain + 1] and step, the fix's own step count.  The
Engine's device loop carries every extras tensor in its buffers, snapshot
and accept/discard step, as it carries x, v and f.  State.step is a Python
int, frozen inside a captured CUDA graph, so the temperature ramp
(_t_target, between begin_step and end_step) reads the fix's device step
count instead: end_of_step advances it, and a ramped NVT replays correctly
in the graph.  The window (begin_step, end_step), which the script
interpreter re-anchors at every `run`, is a constant of the captured
graph: capture_key puts it into the device loop's key, so a changed
window captures anew.

Half-step structure per LAMMPS Verlet + FixNH:
  initial_integrate: thermostat half-step (scale v), then NVE half-kick +
                     drift
  final_integrate:   NVE half-kick, then thermostat half-step
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.state import State
from ..registry import register_fix_style
from .base import Fix, StepContext


@register_fix_style("nvt")
class FixNVT(Fix):
    time_integrate = True

    def __init__(self, t_start: float, t_stop: float, t_damp: float,
                 mtchain: int = 3, nc_tchain: int = 1, fix_id: str = "nvt",
                 group_mask=None):
        """group_mask: optional [N] bool — thermostat and integrate only
        these atoms (LAMMPS `fix ID <group> nvt`); None = all."""
        self.t_start = float(t_start)
        self.t_stop = float(t_stop)
        self.t_damp = float(t_damp)
        self.mtchain = mtchain
        self.nc_tchain = nc_tchain
        self.key = f"nvt:{fix_id}"
        self.begin_step = 0
        self.end_step = 0
        self.group_mask = (None if group_mask is None
                           else np.asarray(group_mask, bool))

    # -- helpers -----------------------------------------------------------
    def _sel(self, state: State) -> torch.Tensor:
        """[N, 1] float selector (1 inside the group)."""
        sel = self.group_sel(state)
        if sel is None:
            return state.x.new_ones((state.x.shape[0], 1))
        return sel.to(state.x.dtype)[:, None]

    def _tdof(self, state: State, ctx: StepContext | None = None) -> float:
        if self.group_mask is not None:
            return 3 * int(self.group_mask.sum()) - 3
        n = state.natoms
        if ctx is not None and ctx.natoms_global is not None:
            n = ctx.natoms_global
        return 3 * n - 3

    def _t_current(self, state: State, ctx: StepContext):
        m = state.per_atom_mass * self._sel(state)[:, 0]
        ke2 = ctx.units.mvv2e * ctx.asum(
            torch.sum(m * torch.sum(state.v ** 2, dim=1)))
        return ke2 / (self._tdof(state, ctx) * ctx.units.boltz)

    def _t_target(self, state: State):
        """The ramp's target at the fix's device step count (a Python float
        when there is no ramp)."""
        if self.end_step <= self.begin_step:
            return self.t_start
        step = state.extras[self.key]["step"]
        delta = (step - self.begin_step).to(state.x.dtype) / max(
            1, self.end_step - self.begin_step)
        return self.t_start + delta * (self.t_stop - self.t_start)

    def capture_key(self) -> tuple:
        return (self.t_start, self.t_stop, self.begin_step, self.end_step)

    def setup(self, state: State, ctx: StepContext) -> State:
        self.group_sel(state)      # the mask reaches the device here
        extras = dict(state.extras)
        dev, dt = state.x.device, state.x.dtype
        extras[self.key] = {
            "eta": torch.zeros(self.mtchain, dtype=dt, device=dev),
            "eta_dot": torch.zeros(self.mtchain + 1, dtype=dt, device=dev),
            "step": torch.tensor(int(state.step), dtype=torch.int64,
                                 device=dev),
        }
        return state.replace(extras=extras)

    def _nhc_half_step(self, state: State, ctx: StepContext) -> State:
        """One thermostat half-step: update the chain, scale velocities."""
        dt = ctx.dt
        dthalf, dt4, dt8 = dt / 2, dt / 4, dt / 8
        boltz = ctx.units.boltz
        tdof = self._tdof(state, ctx)
        t_target = self._t_target(state)
        t_freq = 1.0 / self.t_damp
        ke_target = tdof * boltz * t_target

        chain = state.extras[self.key]
        eta = chain["eta"]
        eta_dot = list(chain["eta_dot"].unbind())

        eta_mass0 = tdof * boltz * t_target / (t_freq * t_freq)
        eta_massk = boltz * t_target / (t_freq * t_freq)

        t_current = self._t_current(state, ctx)
        kecurrent = tdof * boltz * t_current
        eta_dotdot0 = (kecurrent - ke_target) / eta_mass0

        ncfac = 1.0 / self.nc_tchain
        v = state.v
        M = self.mtchain

        for _ in range(self.nc_tchain):
            # backward sweep over the chain
            eta_dotdot = [None] * M
            eta_dotdot[0] = eta_dotdot0
            for ich in range(1, M):
                m_prev = eta_mass0 if ich == 1 else eta_massk
                eta_dotdot[ich] = (m_prev * eta_dot[ich - 1] ** 2
                                   - boltz * t_target) / eta_massk
            for ich in range(M - 1, 0, -1):
                expfac = torch.exp(-ncfac * dt8 * eta_dot[ich + 1])
                eta_dot[ich] = (eta_dot[ich] * expfac
                                + eta_dotdot[ich] * ncfac * dt4) * expfac
            expfac1 = torch.exp(-ncfac * dt8 * eta_dot[1])
            eta_dot[0] = (eta_dot[0] * expfac1
                          + eta_dotdot0 * ncfac * dt4) * expfac1

            # scale particle velocities (group atoms only)
            factor_eta = torch.exp(-ncfac * dthalf * eta_dot[0])
            v = v * (1.0 + self._sel(state) * (factor_eta - 1.0))
            t_current = t_current * factor_eta ** 2
            kecurrent = tdof * boltz * t_current
            eta_dotdot0 = (kecurrent - ke_target) / eta_mass0

            eta = eta + ncfac * dthalf * torch.stack(eta_dot[:M])

            # forward sweep
            eta_dot[0] = (eta_dot[0] * expfac1
                          + eta_dotdot0 * ncfac * dt4) * expfac1
            for ich in range(1, M):
                expfac = torch.exp(-ncfac * dt8 * eta_dot[ich + 1])
                m_prev = eta_mass0 if ich == 1 else eta_massk
                edd = (m_prev * eta_dot[ich - 1] ** 2
                       - boltz * t_target) / eta_massk
                eta_dot[ich] = (eta_dot[ich] * expfac
                                + edd * ncfac * dt4) * expfac

        extras = dict(state.extras)
        extras[self.key] = dict(chain, eta=eta, eta_dot=torch.stack(eta_dot))
        return state.replace(v=v, extras=extras)

    # -- hooks --------------------------------------------------------------
    def initial_integrate(self, state: State, ctx: StepContext) -> State:
        state = self._nhc_half_step(state, ctx)
        m = state.per_atom_mass[:, None]
        s = self._sel(state)
        v = state.v + s * (ctx.dtf * state.f / m)
        x = state.x + s * (ctx.dt * v)
        return state.replace(x=x, v=v)

    def final_integrate(self, state: State, ctx: StepContext) -> State:
        m = state.per_atom_mass[:, None]
        s = self._sel(state)
        v = state.v + s * (ctx.dtf * state.f / m)
        state = state.replace(v=v)
        return self._nhc_half_step(state, ctx)

    def end_of_step(self, state: State, ctx: StepContext) -> State:
        """Advance the fix's device step count (State.step's twin)."""
        chain = state.extras[self.key]
        extras = dict(state.extras)
        extras[self.key] = dict(chain, step=chain["step"] + 1)
        return state.replace(extras=extras)

    def energy(self, state: State, ctx: StepContext):
        """Thermostat conserved-quantity contribution (fix_modify energy)."""
        chain = state.extras[self.key]
        eta, eta_dot = chain["eta"], chain["eta_dot"]
        boltz = ctx.units.boltz
        tdof = self._tdof(state, ctx)
        t_target = self._t_target(state)
        t_freq = 1.0 / self.t_damp
        eta_mass0 = tdof * boltz * t_target / (t_freq * t_freq)
        eta_massk = boltz * t_target / (t_freq * t_freq)
        e = tdof * boltz * t_target * eta[0] \
            + 0.5 * eta_mass0 * eta_dot[0] ** 2
        for ich in range(1, self.mtchain):
            e = e + boltz * t_target * eta[ich] \
                + 0.5 * eta_massk * eta_dot[ich] ** 2
        return e
