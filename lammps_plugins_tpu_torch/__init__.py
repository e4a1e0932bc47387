"""lammps_plugins_tpu_torch — the PyTorch/CUDA port of lammps_plugins_tpu.

The JAX package beside it (``lammps_plugins_tpu``) is the reference; this
package mirrors its module paths so each counterpart is easy to find:

  core/        State, triclinic Box, lattice fills, units, regions, the
               device rule, jax.random's threefry draws
  api/         the input-script interpreter (Script), equal-style
               variables, LAMMPS data files, scene builders (REBOMOS bulk
               and monolayer, AEAM sample.in, the LJ melt decks of
               bench/in.lj and config 2)
  neighbor/    ghosts, padded [N, K] lists, host build, on-device rebuild
  potentials/  PairStyle base (autograd forces / strain virial), REBOMoS,
               AEAM, lj/cut, lj/cut/coul/cut, none, the REBOMOS and AEAM
               file readers, AEAM splines and their piecewise-Chebyshev
               refits
  ops/         hand-written CUDA kernels (sources in csrc/) with their
               plain-PyTorch twins, the nvcc build and ctypes loader, and
               the g++-built native pair search of the host build
  fixes/       nve, nvt (Nose-Hoover chain), langevin, bfield (Lorentz
               force), velocity create, set type/fraction
  run/         Engine (device loop as CUDA graphs, host loop, half-skin
               rebuild rule), FIRE minimize, thermo, dumps, restart
               files, timers
  parallel/    ShardedEngine: x-slabs and Px x Py grids with migration,
               halo exchange and per-shard rebuilds; the shards stacked
               on one device (its iteration one CUDA graph) or each on
               its own device and stream (per_device.py, the collectives
               in collectives.py)
  entry.py     entry checks: one force pass, a sharded dryrun
  convert.py   numpy bridge from the JAX package's objects

The port imports torch, never jax, and nothing of the JAX package: it
keeps its own copies of the framework-free modules it needs
(core/units.py, potentials/tables.py, potentials/polyfit.py, the spline
coefficients of potentials/spline.py, run/timers.py, ops/native.py with
csrc/neighbor_native.cpp).  What it builds goes into build/ at the
repository root.

The entry points (scene functions, Box constructors, REBOMoS, AEAM, the
LJ styles, the host neighbor build) run on the card unless the caller passes device="cpu"
(core/device.py); without a CUDA device they raise.

Dispatch rule shared by every kernel wrapper: a CPU tensor takes the plain
PyTorch twin, a CUDA float32 tensor launches the kernel, and a CUDA tensor
of any other dtype raises.
"""

__version__ = "0.1.0"

__all__ = ["Script", "ScriptError", "ShardedEngine"]


def __getattr__(name):
    """`from lammps_plugins_tpu_torch import Script, ShardedEngine`
    (imported on first use, so that importing the package stays light)."""
    if name == "ShardedEngine":
        from .parallel import ShardedEngine
        return ShardedEngine
    if name in __all__:
        from .api import script
        return getattr(script, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
