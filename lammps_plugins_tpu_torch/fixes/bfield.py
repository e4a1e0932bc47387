"""fix bfield — the analytic Lorentz-force (q v x B) integrator (port of
lammps_plugins_tpu/fixes/bfield.py; USER-BFIELD/fix_bfield.cpp, the
weak-field Taylor expansion of Spreiter & Walter, J. Comp. Phys. 1999).

  initial_integrate (before the integrator's half kick, so fix bfield is
      defined before fix nve; the Engine keeps definition order): snapshot
      v0 = v(t) (fix_bfield.cpp:300-320)
  post_integrate (after the half kick and drift): the velocity rotation
      and position correction axis by axis from v0 and the current force
      (cpp:392-410; omega = qBm2f q/m B, cpp:375-377), then the Lorentz
      diagnostics (cpp:412-421): fsum[0] = -sum F_L . x_unwrapped, fsum[1:4]
      = the total Lorentz force, summed through ctx.asum
  post_force: a time-varying B (a component given as a callable t -> B,
      the equal-style variable of cpp:513-519)

The fix's state lives in state.extras["bfield:<id>"] as device tensors:
v0, B, fsum, and for a time-varying B the fix's own step count.  The
Engine's device loop carries them like x, v and f.  State.step is a
Python int, frozen inside a captured CUDA graph, so a time-varying B reads
the fix's device step count (advanced in end_of_step, as fix nvt's ramp
does): each callable is called with t, a 0-d tensor of the state's dtype
on its device, and must return a tensor there (torch ops on t).  Constant
components sit on the device from setup on; the group mask and the
region's bounds reach the device in setup too, so no hook copies from the
host.

The weak-field validity warning (omega dt > 2 pi 0.001, Spreiter Eq. 1,
cpp:236-278) is raised in setup.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..core.region import Region
from ..core.state import State
from ..registry import register_fix_style
from .base import Fix, StepContext


@register_fix_style("bfield")
class FixBfield(Fix):
    def __init__(self, bx, by, bz, region: Optional[Region] = None,
                 group_mask=None, fix_id: str = "bfield"):
        """bx, by, bz: constants, or callables t -> value (see above)."""
        self.b_spec = (bx, by, bz)
        self.region = region
        self.group_mask = (None if group_mask is None
                           else np.asarray(group_mask, bool))
        self.key = f"bfield:{fix_id}"
        self.time_varying = any(callable(b) for b in self.b_spec)
        self._b_on = {}

    def _b_const(self, t: torch.Tensor) -> torch.Tensor:
        """[3] the constant components (0 where a callable) on t's device
        and in its dtype, made there once (setup or the first step)."""
        key = (t.device, t.dtype)
        if key not in self._b_on:
            self._b_on[key] = torch.as_tensor(
                [0.0 if callable(b) else float(b) for b in self.b_spec],
                dtype=t.dtype, device=t.device)
        return self._b_on[key]

    def _b_at(self, t: torch.Tensor) -> torch.Tensor:
        """[3] B at time t (a 0-d tensor): the constant components from the
        device copy, the callables evaluated on t."""
        b_const = self._b_const(t)
        if not self.time_varying:
            return b_const
        return torch.stack([
            torch.as_tensor(b(t), dtype=t.dtype, device=t.device).reshape(())
            if callable(b) else b_const[a]
            for a, b in enumerate(self.b_spec)])

    def _sel(self, state: State):
        """[N] bool of the atoms the fix acts on (group and region), or
        None for all."""
        sel = self.group_sel(state)
        if self.region is not None:
            inside = self.region.inside(state.x)
            sel = inside if sel is None else sel & inside
        return sel

    def setup(self, state: State, ctx: StepContext) -> State:
        # the Lorentz force needs charges (fix_bfield.cpp:135): with all q
        # zero the fix would do nothing without saying so
        if not bool(torch.any(state.q != 0)):
            raise ValueError(
                "fix bfield requires atom attribute q (all charges are "
                "zero; the Lorentz force q v x B would be identically 0)")
        dev, dtype = state.x.device, state.x.dtype
        self._sel(state)            # the mask and the bounds reach the device
        B = self._b_at(torch.zeros((), dtype=dtype, device=dev))
        entry = {"v0": torch.zeros_like(state.v), "B": B,
                 "fsum": torch.zeros(4, dtype=dtype, device=dev)}
        if self.time_varying:
            entry["step"] = torch.tensor(int(state.step), dtype=torch.int64,
                                         device=dev)
        extras = dict(state.extras)
        extras[self.key] = entry
        # weak-field check (fix_bfield.cpp:236-278)
        q = state.q.detach().cpu().double().numpy()
        m = state.per_atom_mass.detach().cpu().double().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            omega = np.abs(np.outer(ctx.units.qBm2f * q / m,
                                    B.detach().cpu().double().numpy()))
        if np.any(np.nan_to_num(omega) > 2 * np.pi * 0.001 / ctx.dt):
            warnings.warn("fix bfield does not support strong magnetic "
                          "fields (omega*dt exceeds the weak-field bound)")
        return state.replace(extras=extras)

    def _with_entry(self, state: State, **changes) -> State:
        extras = dict(state.extras)
        extras[self.key] = dict(extras[self.key], **changes)
        return state.replace(extras=extras)

    # -- hooks --------------------------------------------------------------
    def initial_integrate(self, state: State, ctx: StepContext) -> State:
        return self._with_entry(state, v0=state.v)

    def post_integrate(self, state: State, ctx: StepContext) -> State:
        entry = state.extras[self.key]
        B, v0 = entry["B"], entry["v0"]
        dtv = ctx.dt
        m = state.per_atom_mass
        q = state.q
        dtfm = ctx.dtf / m                        # 0.5 dt ftm2v / m
        omega = (ctx.units.qBm2f * q / m)[:, None] * B[None, :]   # [N, 3]
        vx, vy, vz = v0[:, 0], v0[:, 1], v0[:, 2]
        fx, fy, fz = state.f[:, 0], state.f[:, 1], state.f[:, 2]
        dw = dtv * omega
        hdtfm = 0.5 * dtfm
        hdw = 0.5 * dw
        dw0, dw1, dw2 = dw[:, 0], dw[:, 1], dw[:, 2]
        h0, h1, h2 = hdw[:, 0], hdw[:, 1], hdw[:, 2]

        # velocity rotation, the omega_x, omega_y, omega_z terms in the
        # JAX package's order (fix_bfield.cpp:392-399)
        dv = torch.stack([
            -dw1 * (vz + hdtfm * fx + h1 * vx)
            + dw2 * (vy + hdtfm * fy - h2 * vx),
            dw0 * (vz + hdtfm * fy - h0 * vy)
            - dw2 * (vx + hdtfm * fx + h2 * vy),
            -dw0 * (vy + hdtfm * fx + h0 * vz)
            + dw1 * (vx + hdtfm * fy - h1 * vz)], dim=1)
        # position correction (fix_bfield.cpp:403-410)
        dx = torch.stack([
            -dtv * h1 * vz + dtv * h2 * vy,
            dtv * h0 * vz + -dtv * h2 * vx,
            -dtv * h0 * vy + dtv * h1 * vx], dim=1)

        sel = self._sel(state)
        if sel is None:
            v_new, x_new = state.v + dv, state.x + dx
        else:
            s = sel.to(dv.dtype)[:, None]
            v_new, x_new = state.v + s * dv, state.x + s * dx

        # Lorentz-force diagnostics (cpp:412-421), not used by the dynamics
        flx = q * (vy * B[2] - vz * B[1])
        fly = q * (vz * B[0] - vx * B[2])
        flz = q * (vx * B[1] - vy * B[0])
        u = state.box.unmap(x_new, state.image)
        if sel is not None:
            s1 = sel.to(flx.dtype)
            flx, fly, flz = s1 * flx, s1 * fly, s1 * flz
        # ctx.asum: the MPI_Allreduce of fix_bfield.cpp:545
        fsum = ctx.asum(torch.stack([
            -torch.sum(flx * u[:, 0] + fly * u[:, 1] + flz * u[:, 2]),
            torch.sum(flx), torch.sum(fly), torch.sum(flz)]))
        state = state.replace(x=x_new, v=v_new)
        return self._with_entry(state, fsum=fsum)

    def post_force(self, state: State, ctx: StepContext) -> State:
        if not self.time_varying:
            return state
        step = state.extras[self.key]["step"]
        return self._with_entry(state,
                                B=self._b_at(step.to(state.x.dtype) * ctx.dt))

    def end_of_step(self, state: State, ctx: StepContext) -> State:
        """Advance the fix's device step count (State.step's twin)."""
        if not self.time_varying:
            return state
        return self._with_entry(
            state, step=state.extras[self.key]["step"] + 1)

    # -- outputs (compute_scalar / compute_vector) ---------------------------
    def energy(self, state: State, ctx: StepContext):
        return state.extras[self.key]["fsum"][0]

    def vector(self, state: State):
        return state.extras[self.key]["fsum"][1:4]
