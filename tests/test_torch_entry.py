"""The port's entry checks (lammps_plugins_tpu_torch/entry.py, its
counterpart of __graft_entry__.py) on the CPU: entry() evaluates the
288-atom scene's energy, forces and virial (held against the port's
Engine on the same scene, float64), and dryrun_multichip(4) runs one
resettle, a segment and a second resettle on four shards."""

import numpy as np
import torch


def test_entry_force_pass_on_the_cpu():
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.entry import REBO_FILE, entry
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    f64 = dict(dtype=torch.float64, device="cpu")
    fn, args = entry(**f64)
    e, f, w = fn(*args)
    assert f.shape == (288, 3) and w.shape == (3, 3)
    eng = Engine(rebomos_bulk(**f64),
                 REBOMoS.from_file(REBO_FILE, ["M", "S"], **f64),
                 [FixNVE()], units.METAL)
    eng.device_rebuild = False
    pe, virial = eng.evaluate()
    assert abs(float(e) - float(pe)) <= 1e-10 * abs(float(pe))
    np.testing.assert_allclose(f.numpy(), eng.state.f.numpy(), atol=1e-9)
    np.testing.assert_allclose(w.numpy(), virial.numpy(), rtol=1e-9,
                               atol=1e-9)


def test_dryrun_multichip_four_shards():
    from lammps_plugins_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(4, device="cpu")
