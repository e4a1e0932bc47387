"""Velocity Verlet with LAMMPS's fix nve and fix nvt (Nose-Hoover chain,
Martyna-Tobias-Klein, FixNH with mtchain 3, nc_tchain 1, no drag), in
float64, and the unit systems the configurations use.

`follow` advances a state k steps with forces from a plain potential.
Its neighbour pairs are rebuilt by the configured rule: "exact" keeps the
pairs within the cutoff at every step (a list with a skin of its own,
rebuilt before any atom moves half that skin); "every" takes the pairs
within cutoff + skin at the start and keeps them for the k steps, as
LAMMPS does under `neigh_modify every k check no`.

A thermostat is an object with `half_step(v, m, ext, dt, units) -> (v,
ext)`, run before the first and after the second half kick; `ext` holds
its own state by the names it chooses.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class Units:
    boltz: float
    mvv2e: float
    ftm2v: float
    nktv2p: float


UNITS = {
    "metal": Units(boltz=8.617343e-5, mvv2e=1.0364269e-4,
                   ftm2v=1.0 / 1.0364269e-4, nktv2p=1.6021765e6),
    "lj": Units(boltz=1.0, mvv2e=1.0, ftm2v=1.0, nktv2p=1.0),
}

#: the per-atom virial's components: xx yy zz xy xz yz
VIRIAL_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))

#: the reference's own skin under the "exact" rule (length units)
EXACT_SKIN = 1.0


def temperature(v, m, units: Units) -> torch.Tensor:
    ke2 = units.mvv2e * (m[:, None] * v * v).sum()
    return ke2 / ((3 * v.shape[0] - 3) * units.boltz)


class NoseHooverChain:
    """The chain of fix nvt temp T T t_damp; its state in ext: eta [3],
    eta_dot [4]."""

    def __init__(self, t_target: float, t_damp: float, mtchain: int = 3):
        self.t = float(t_target)
        self.freq = 1.0 / float(t_damp)
        self.M = mtchain

    def half_step(self, v, m, ext: dict, dt: float, units: Units):
        """One thermostat half step: new (v, ext)."""
        eta, eta_dot = ext["eta"], ext["eta_dot"]
        tdof = 3 * v.shape[0] - 3
        kb = units.boltz
        ke_target = tdof * kb * self.t
        mass0 = tdof * kb * self.t / self.freq ** 2
        massk = kb * self.t / self.freq ** 2
        ed = list(eta_dot.unbind())
        M = self.M
        ke = tdof * kb * temperature(v, m, units)
        edd0 = (ke - ke_target) / mass0
        for ich in range(M - 1, 0, -1):
            mp = mass0 if ich == 1 else massk
            edd = (mp * ed[ich - 1] ** 2 - kb * self.t) / massk
            ex = torch.exp(-dt / 8 * ed[ich + 1])
            ed[ich] = (ed[ich] * ex + edd * dt / 4) * ex
        ex1 = torch.exp(-dt / 8 * ed[1])
        ed[0] = (ed[0] * ex1 + edd0 * dt / 4) * ex1
        fac = torch.exp(-dt / 2 * ed[0])
        v = v * fac
        ke = ke * fac * fac
        edd0 = (ke - ke_target) / mass0
        eta = eta + dt / 2 * torch.stack(ed[:M])
        ed[0] = (ed[0] * ex1 + edd0 * dt / 4) * ex1
        for ich in range(1, M):
            mp = mass0 if ich == 1 else massk
            edd = (mp * ed[ich - 1] ** 2 - kb * self.t) / massk
            ex = torch.exp(-dt / 8 * ed[ich + 1])
            ed[ich] = (ed[ich] * ex + edd * dt / 4) * ex
        return v, dict(ext, eta=eta, eta_dot=torch.stack(ed))


@dataclass
class MDState:
    """Unwrapped positions, velocities, forces (float64) and the
    thermostats' own state."""

    x: torch.Tensor
    v: torch.Tensor
    f: torch.Tensor | None = None
    ext: dict = field(default_factory=dict)


class Integrator:
    def __init__(self, pot, h, types, mass_of_type, units: Units, dt: float,
                 skin: float, rule: str, thermostats=(), dtype=torch.float64):
        self.pot, self.h, self.types = pot, h.to(torch.float64), types
        self.m = mass_of_type.to(torch.float64)[types]
        self.units, self.dt, self.skin, self.rule = units, dt, skin, rule
        self.thermostats, self.dtype = list(thermostats), dtype
        self.dtf = 0.5 * dt * units.ftm2v
        self._pairs = None
        self._x_list = None

    def forces(self, x) -> torch.Tensor:
        """Forces at x under the neighbour rule (rebuilds as it needs)."""
        if self.rule == "exact":
            if self._pairs is None or float(torch.max(torch.linalg.norm(
                    x - self._x_list, dim=1))) > 0.5 * EXACT_SKIN:
                self._pairs = self.pot.pairs(x, self.h, self.types,
                                             EXACT_SKIN)
                self._x_list = x.clone()
        elif self._pairs is None:
            self._pairs = self.pot.pairs(x, self.h, self.types, self.skin)
        return self.pot.energy_forces(x, self.h, self.types, self._pairs,
                                      self.dtype)[1]

    def step(self, s: MDState) -> MDState:
        v, ext = s.v, s.ext
        for t in self.thermostats:
            v, ext = t.half_step(v, self.m, ext, self.dt, self.units)
        v = v + self.dtf * s.f / self.m[:, None]
        x = s.x + self.dt * v
        f = self.forces(x)
        v = v + self.dtf * f / self.m[:, None]
        for t in self.thermostats:
            v, ext = t.half_step(v, self.m, ext, self.dt, self.units)
        return MDState(x=x, v=v, f=f, ext=ext)

    def follow(self, s: MDState, k: int):
        """(the state k steps from s, the forces at s's positions), which
        are computed here first."""
        f0 = self.forces(s.x)
        s = MDState(x=s.x, v=s.v, f=f0, ext=s.ext)
        for _ in range(k):
            s = self.step(s)
        return s, f0


def thermo(e, w, v, m, volume: float, units: Units) -> dict:
    """A thermo row's quantities from the potential energy e, the virial
    trace w (sum of W_aa), the velocities and masses, LAMMPS's
    conventions: dof 3N - 3, press = (sum m v.v mvv2e + w) / 3V nktv2p.
    `press_scale` is the size of press's two parts, for a relative gap."""
    kin = units.mvv2e * float((m[:, None] * v * v).sum())
    ke = 0.5 * kin
    pk = kin / (3.0 * volume) * units.nktv2p
    pw = float(w) / (3.0 * volume) * units.nktv2p
    return dict(temp=kin / ((3 * v.shape[0] - 3) * units.boltz),
                epair=float(e), pe=float(e), ke=ke, etotal=float(e) + ke,
                press=pk + pw, press_scale=abs(pk) + abs(pw))


def stress_atom(vatom, v, m, units: Units) -> torch.Tensor:
    """compute stress/atom NULL: -(m v_a v_b mvv2e + vatom) nktv2p, [N, 6]
    in the order xx yy zz xy xz yz."""
    kin = units.mvv2e * m[:, None] * torch.stack(
        [v[:, a] * v[:, b] for a, b in VIRIAL_PAIRS], dim=1)
    return -(kin + vatom) * units.nktv2p


def rms(t: torch.Tensor) -> float:
    return math.sqrt(float((t.double() ** 2).sum(-1).mean()))
