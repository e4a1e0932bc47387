"""lammps_plugins_tpu_torch — the PyTorch/CUDA port of lammps_plugins_tpu.

The JAX package beside it (``lammps_plugins_tpu``) is the reference; this
package mirrors its module paths so each counterpart is easy to find:

  core/        State, triclinic Box, lattice fills
  api/         scene builders
  neighbor/    ghosts, padded [N, K] lists, host build, on-device rebuild
  potentials/  PairStyle base (autograd forces / strain virial), REBOMoS
  ops/         hand-written CUDA kernels (sources in csrc/) with their
               plain-PyTorch twins, plus the nvcc build and ctypes loader
  fixes/       nve, velocity create
  run/         Engine (host loop, half-skin rebuild rule), thermo
  convert.py   numpy bridge from the JAX package's objects

The port imports torch and never jax.  The framework-free modules of the
JAX package (core/units.py, potentials/tables.py, run/timers.py,
ops/native.py) are imported from there, not copied; core/units.py is
re-exported as lammps_plugins_tpu_torch.core.units.

Dispatch rule shared by every kernel wrapper: a CPU tensor takes the plain
PyTorch twin, a CUDA float32 tensor launches the kernel, and a CUDA tensor
of any other dtype raises.
"""

__version__ = "0.1.0"
