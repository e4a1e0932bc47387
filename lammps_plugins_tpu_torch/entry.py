"""Entry checks of the port (its counterpart of the repository's
__graft_entry__.py): a single-device force pass and a sharded dryrun.

entry(device="cuda", dtype=torch.float32): (fn, args) with fn(*args) one
energy / force / virial evaluation of REBOMoS on the 288-atom
in.rebomos-bulk scene and its rebuild lists, with the synthetic parameters
tests/data/MoS.REBO.synthetic (the published set5b is not in the
repository).

dryrun_multichip(n, device="cuda", dtype=torch.float32): the sharded
engine on n shards stacked on one device: one resettle (migration, halo packing, every shard's
device rebuild), a segment of steps with the per-step halo refresh, and a
second resettle that migrates again.

    python -m lammps_plugins_tpu_torch.entry [--cpu]              # entry()
    python -m lammps_plugins_tpu_torch.entry multichip 4 [--cpu]  # dryrun

on the card, or on the CPU in float64 with --cpu.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REBO_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data", "MoS.REBO.synthetic")


def _pair(dtype, device):
    from .potentials.rebomos import REBOMoS
    return REBOMoS.from_file(REBO_FILE, ["M", "S"], dtype=dtype,
                             device=device)


def entry(device="cuda", dtype=torch.float32):
    """(fn, example_args): fn(x, types, nbr, h) -> (E, F, W) on the
    288-atom scene and the Engine's rebuild lists (skin 2.0), the tables
    its kernels read: on the card one launch each of the REBO cotangent
    kernel, the mirror combine and the LJ cell sweep, no autograd."""
    from .api.scenes import rebomos_bulk
    from .core import units
    from .fixes.nve import FixNVE
    from .run.simulation import Engine
    eng = Engine(rebomos_bulk(dtype=dtype, device=device),
                 _pair(dtype, device), [FixNVE()], units.METAL, skin=2.0)
    eng.rebuild_neighbors()
    st = eng.state
    return eng.pair.energy_force_virial, (st.x, st.type, eng.nbr, st.box.h)


def dryrun_multichip(n_devices: int, device="cuda",
                     dtype=torch.float32) -> None:
    """One resettle, a 3-step segment and a second resettle of the sharded
    engine on n_devices shards stacked on `device`, on a long thin MoS2
    box (every slab wider than the halo margin)."""
    from .api.scenes import rebomos_bulk
    from .core import units
    from .fixes.nve import FixNVE
    from .fixes.velocity import velocity_create
    from .parallel import ShardedEngine
    state = rebomos_bulk(nx=3 * n_devices, ny=2, nz=1, tilt_xy=0.0,
                         dtype=dtype, device=device)
    state = velocity_create(state, units.METAL, 300.0, seed=11)
    eng = ShardedEngine(state, _pair(dtype, device), [FixNVE()],
                        units.METAL, devices=[device] * n_devices,
                        check_every=3)
    eng.resettle()
    eng._setup_forces()
    eng.shards, _ = eng._steps(eng.shards, eng.halo, eng.nbrs, 3)
    eng.resettle()                     # migration and halos again
    st = eng.to_state()
    if not bool(torch.isfinite(st.x).all()):
        raise AssertionError("sharded step produced a non-finite state")
    if st.natoms != state.natoms:
        raise AssertionError(f"{st.natoms} atoms after the dryrun, "
                             f"{state.natoms} before")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    where = (dict(device="cpu", dtype=torch.float64) if "--cpu" in sys.argv
             else {})
    if args and args[0] == "multichip":
        n = int(args[1]) if len(args) > 1 else 4
        dryrun_multichip(n, **where)
        print(f"dryrun_multichip({n}) OK")
    else:
        fn, fargs = entry(**where)
        out = fn(*fargs)
        print("entry() OK; PE =", float(out[0]),
              "max |F| =", float(np.abs(out[1].detach().cpu().numpy()).max()))
