"""LAMMPS-compatible unit systems (the port's own copy of
lammps_plugins_tpu/core/units.py, which the port does not import).

Constants reproduce LAMMPS's `update.cpp` values exactly so thermo output
(temp, press, ke) and integrator prefactors (ftm2v) match the golden logs
in float64.  The fix-bfield charge/mass/time conversion (qBm2f) follows
USER-BFIELD/fix_bfield.cpp:179-202.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    name: str
    boltz: float        # Boltzmann constant [energy/K]
    mvv2e: float        # mass*velocity^2 -> energy
    ftm2v: float        # force/mass -> velocity/time (1/mvv2e)
    nktv2p: float       # N k T / V -> pressure units
    qe2f: float         # charge*E-field -> force
    qqr2e: float        # q*q/r -> energy
    mv2d: float         # mass/volume -> density
    dt: float           # default timestep
    skin: float         # default neighbor skin
    qBm2f: float        # fix bfield: (q/m)*B -> angular frequency [1/time]
                        # fix_bfield.cpp:179-202


_QE = 1.60217646e-19   # C per electron charge, value used by fix_bfield.cpp
_AMU = 1.66054e-27     # kg per amu, value used by fix_bfield.cpp


METAL = UnitSystem(
    name="metal",
    boltz=8.617343e-5,          # eV/K
    mvv2e=1.0364269e-4,         # g/mol (A/ps)^2 -> eV
    ftm2v=1.0 / 1.0364269e-4,
    nktv2p=1.6021765e6,         # eV/A^3 -> bar
    qe2f=1.0,
    qqr2e=14.399645,
    mv2d=1.0 / 0.602214129,
    dt=0.001,                   # ps
    skin=2.0,                   # Angstrom
    qBm2f=_QE / _AMU / 1e12,    # fix_bfield.cpp:186-188 (metal: ps per s)
)

REAL = UnitSystem(
    name="real",
    boltz=0.0019872067,         # kcal/mol/K
    mvv2e=48.88821291 * 48.88821291,
    ftm2v=1.0 / (48.88821291 * 48.88821291),
    nktv2p=68568.415,
    qe2f=23.060549,
    qqr2e=332.06371,
    mv2d=1.0 / 0.602214129,
    dt=1.0,                     # fs
    skin=2.0,
    qBm2f=_QE / _AMU / 1e15,    # fix_bfield.cpp:183-185 (real: fs per s)
)

LJ = UnitSystem(
    name="lj",
    boltz=1.0, mvv2e=1.0, ftm2v=1.0, nktv2p=1.0, qe2f=1.0, qqr2e=1.0,
    mv2d=1.0, dt=0.005, skin=0.3,
    qBm2f=1.0,                  # fix_bfield.cpp:181-182
)

SI = UnitSystem(
    name="si",
    boltz=1.3806504e-23, mvv2e=1.0, ftm2v=1.0, nktv2p=1.0,
    qe2f=1.0, qqr2e=8.9876e9, mv2d=1.0, dt=1e-8, skin=0.001,
    qBm2f=1.0,                  # fix_bfield.cpp:189-190
)

CGS = UnitSystem(
    name="cgs",
    boltz=1.3806504e-16, mvv2e=1.0, ftm2v=1.0, nktv2p=1.0,
    qe2f=1.0, qqr2e=1.0, mv2d=1.0, dt=1e-8, skin=0.1,
    qBm2f=3.356e-10 / 1.66054e-24 / 1.0,   # fix_bfield.cpp:191-192
)

ELECTRON = UnitSystem(
    name="electron",
    boltz=3.16681534e-6, mvv2e=1.06657236, ftm2v=0.937582899,
    nktv2p=2.94210108e13, qe2f=1.94469051e-10, qqr2e=1.0,
    mv2d=1.0, dt=0.001, skin=2.0,
    qBm2f=_QE / _AMU / 1e15,    # fix_bfield.cpp:193-195
)

MICRO = UnitSystem(
    name="micro",
    boltz=1.3806504e-8, mvv2e=1.0, ftm2v=1.0, nktv2p=1.0,
    qe2f=1.0, qqr2e=8.9876e30, mv2d=1.0, dt=2.0, skin=0.1,
    qBm2f=1e-12 / 1.66054e-12 / 1e6,       # fix_bfield.cpp:196-197
)

NANO = UnitSystem(
    name="nano",
    boltz=0.013806504, mvv2e=1.0, ftm2v=1.0, nktv2p=1.0,
    qe2f=1.0, qqr2e=230.7078669, mv2d=1.0, dt=0.00045, skin=0.1,
    qBm2f=_QE / 1.66054e-6 / 1e9,          # fix_bfield.cpp:198-200
)

_SYSTEMS = {u.name: u for u in
            (METAL, REAL, LJ, SI, CGS, ELECTRON, MICRO, NANO)}


def get(name: str) -> UnitSystem:
    try:
        return _SYSTEMS[name]
    except KeyError:
        raise ValueError(f"Unknown unit style: {name!r}") from None
