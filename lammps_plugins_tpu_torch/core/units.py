"""LAMMPS unit systems.

The JAX package's core/units.py is framework-free (plain Python floats),
so the port re-exports it rather than copying it: users of the port
import everything from lammps_plugins_tpu_torch.
"""

from lammps_plugins_tpu.core.units import (  # noqa: F401
    CGS, ELECTRON, LJ, METAL, MICRO, NANO, REAL, SI, UnitSystem, get)
