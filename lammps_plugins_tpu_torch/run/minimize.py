"""Energy minimization — FIRE (port of lammps_plugins_tpu/run/minimize.py;
LAMMPS `min_style fire` + `minimize etol ftol maxiter maxeval`).

The FIRE iteration is a damped MD step, so it reuses the pair style's
forces and the Engine's neighbor lists unchanged.  LAMMPS min_fire.cpp
defaults: delaystep 5, dt_grow 1.1, dt_shrink 0.5, alpha0 0.25,
alpha_shrink 0.99, tmax 10 (dtmax = 10 dt), halfstepback yes, integrator
eulerimplicit.  Stop rules as LAMMPS Min::run, etol checked before ftol:
  * etol: |E_prev - E| <= etol (|E_prev| + |E| + EPS_ENERGY) / 2
  * ftol: ||F||_2 < ftol (2-norm of the global force vector)
  * maxiter iterations.

The iterations run in chunks of max(4, check_every), as the JAX package
runs its lax.scan chunks: every decision inside a chunk is a device
tensor (a converged carry freezes in place), and the host reads the
chunk's done flag and maximum displacement once per chunk.  A chunk that
outran half the skin on a stale list is discarded and run again from a
fresh build; the iteration count advances by whole chunks, as in the JAX
package.  The chunks run eagerly on the card.  Energy and forces come
from the pair style's energy_forces: its force path (the kernels on the
card, no autograd scatter) and its energy, which REBOMoS takes from the
same launch of the LJ cell kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EPS_ENERGY = 1e-8

DELAYSTEP = 5
DT_GROW = 1.1
DT_SHRINK = 0.5
ALPHA0 = 0.25
ALPHA_SHRINK = 0.99
TMAX = 10.0


@dataclasses.dataclass
class MinResult:
    stop_criterion: str
    iterations: int
    e_initial: float
    e_final: float
    fnorm2_final: float
    fnorm_inf_final: float

    def __repr__(self):
        return (f"Minimization stats: {self.stop_criterion}\n"
                f"  Iterations = {self.iterations}\n"
                f"  Energy initial/final = {self.e_initial:.10g} "
                f"{self.e_final:.10g}\n"
                f"  Force 2-norm final = {self.fnorm2_final:.6g}, "
                f"max component = {self.fnorm_inf_final:.6g}")


def _energy_forces(engine, x):
    """(pe, f) at positions x on the Engine's current lists."""
    st = engine.state
    return engine.pair.energy_forces(x, st.type, engine.nbr, st.box.h)


def minimize(engine, etol: float = 0.0, ftol: float = 1e-6,
             maxiter: int = 1000, chunk: int = 0) -> MinResult:
    """Relax engine.state's positions with FIRE.  Leaves the relaxed
    positions with v = 0 and f the final forces, so a following run
    starts from a valid set-up, as LAMMPS does after minimize."""
    units = engine.units
    dt_md = engine.ctx.dt
    ftm2v = units.ftm2v
    dtmax = TMAX * dt_md
    if chunk <= 0:
        chunk = max(4, engine.check_every)
    half_skin_sq = (0.5 * engine.skin) ** 2

    engine._ensure_neighbors()
    state = engine.state
    dev, dtype = state.x.device, state.x.dtype
    m = state.per_atom_mass[:, None]

    def body(c):
        x, v, dt, alpha, npos, e_prev, done, crit = c
        pe, f = _energy_forces(engine, x)
        fnorm2 = torch.sqrt(torch.sum(f * f))
        e_ok = torch.abs(e_prev - pe) <= (
            etol * (torch.abs(e_prev) + torch.abs(pe) + EPS_ENERGY) * 0.5)
        e_hit = e_ok & (etol > 0.0)
        f_hit = (fnorm2 < ftol) & (ftol > 0.0)
        new_crit = torch.where(e_hit, 1, torch.where(f_hit, 2, 0))
        crit = torch.where(done == 0, new_crit, crit)
        done = torch.maximum(done, new_crit)

        uphill = torch.sum(v * f) <= 0.0
        # halfstepback on reversal, then reset the dynamics
        x = torch.where(uphill, x - (0.5 * dt) * v, x)
        v = torch.where(uphill, 0.0, v)
        npos = torch.where(uphill, 0, npos + 1)
        grow = npos > DELAYSTEP
        dt = torch.where(uphill, dt * DT_SHRINK,
                         torch.where(grow, torch.clamp(dt * DT_GROW,
                                                       max=dtmax), dt))
        alpha = torch.where(uphill, ALPHA0,
                            torch.where(grow, alpha * ALPHA_SHRINK, alpha))

        # euler-implicit kick, then velocity mixing toward the force
        v = v + (dt * ftm2v) * f / m
        vmag = torch.sqrt(torch.sum(v * v))
        fmag = torch.sqrt(torch.sum(f * f))
        fhat = f / torch.clamp(fmag, min=1e-300)
        v = (1.0 - alpha) * v + (alpha * vmag) * fhat
        xn = x + dt * v

        frozen = done > 0
        x = torch.where(frozen, x, xn)
        v = torch.where(frozen, 0.0 * v, v)
        return x, v, dt, alpha, npos, pe, done, crit

    def run_chunk(x, carry, n):
        c = (x,) + carry
        for _ in range(n):
            c = body(c)
        d = c[0] - engine.nbr.x_build
        return c[0], c[1:], torch.max(torch.sum(d * d, dim=-1))

    pe0, _ = _energy_forces(engine, state.x)
    e_initial = float(pe0)
    # e_prev sentinel: offset so that the first energy check cannot pass
    # (LAMMPS compares successive iterates only)
    e_prev0 = e_initial + max(1.0, 2.0 * abs(e_initial))
    scalar = dict(dtype=dtype, device=dev)
    index = dict(dtype=torch.int32, device=dev)
    carry = (torch.zeros_like(state.v), torch.tensor(dt_md, **scalar),
             torch.tensor(ALPHA0, **scalar), torch.tensor(0, **index),
             torch.tensor(e_prev0, **scalar), torch.tensor(0, **index),
             torch.tensor(0, **index))

    x = state.x
    it = 0
    crit_code = 0
    fresh_list = True            # the list was just built at the current x
    while it < maxiter:
        n = min(chunk, maxiter - it)
        x_new, carry_new, maxdisp_sq = run_chunk(x, carry, n)
        if float(maxdisp_sq) > half_skin_sq and not fresh_list:
            # the chunk outran the list's half-skin slack: its forces (and
            # any stop it decided) used a stale list, so run it again from
            # a fresh build; a fresh-list chunk that still trips is kept,
            # and the next one rebuilds first
            engine.state = engine.state.replace(x=x)
            engine.rebuild_neighbors()
            x = engine.state.x           # the rebuild wraps positions
            fresh_list = True
            continue
        x, carry = x_new, carry_new
        it += n
        if int(carry[5]):
            crit_code = int(carry[6])
            break
        fresh_list = False
        if float(maxdisp_sq) > half_skin_sq:
            engine.state = engine.state.replace(x=x)
            engine.rebuild_neighbors()
            x = engine.state.x
            fresh_list = True

    engine.state = engine.state.replace(x=x, v=torch.zeros_like(state.v))
    engine._ensure_neighbors()
    pe1, f1 = _energy_forces(engine, engine.state.x)
    engine.state = engine.state.replace(f=f1)
    engine._f_valid = True
    f_np = f1.detach().cpu().double().numpy()
    crit = {0: "max iterations", 1: "energy tolerance",
            2: "force tolerance"}[crit_code]
    return MinResult(stop_criterion=crit, iterations=it,
                     e_initial=e_initial, e_final=float(pe1),
                     fnorm2_final=float(np.sqrt((f_np ** 2).sum())),
                     fnorm_inf_final=float(np.abs(f_np).max()))
