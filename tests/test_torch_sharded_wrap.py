"""A row that the sharded engine's global wrap rounds onto a periodic face
in float32 keeps lists built where the engine keeps it.

In a 177-A periodic y (config 5's box) a row 3e-6 A below y = 0 wraps to
the fractional coordinate 1 - 2e-8, which float32 rounds to 1.0: the row
sits on the face y = L.  A second wrap in the slab rebuild would move it
to y = 0 and build its lists there while the engine steps it at y = L, so
that the row and its bonds would have no force until the next rebuild."""

import pytest
import torch
from torch_parity import SYNTH_REBO


def _forces(placement):
    """(row id, engine, its forces, the single Engine's forces) with the
    row moved to y = -3e-6 A and resettled."""
    from lammps_plugins_tpu_torch import ShardedEngine
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk_commensurate
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    cpu = dict(dtype=torch.float32, device="cpu")
    st = rebomos_bulk_commensurate(16, 64, 1, **cpu)
    g = torch.Generator().manual_seed(5)
    st = st.replace(x=st.x + 0.05 * torch.randn(st.x.shape, generator=g))
    i = int(torch.argmin(st.x[:, 1]))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"],
                             **cpu)
    se = ShardedEngine(st, pair, [FixNVE()], units.METAL,
                       devices=["cpu"] * 4, skin=1.0, placement=placement)
    se._setup_forces()
    ss = se.shards
    x = ss.x.clone()
    x[ss.tag == i, 1] = -3e-6
    se.shards = ss.replace(x=x)
    se.resettle()
    se._f_valid = False
    se._setup_forces()
    moved = se.to_state()
    eng = Engine(moved, pair, [FixNVE()], units.METAL, skin=1.0)
    eng.fused_loop = False
    eng._setup_forces()
    return i, se, moved.f, eng.state.f


@pytest.mark.parametrize("placement", ["stacked", "per_device"])
def test_a_row_rounded_onto_a_periodic_face_keeps_its_lists(placement):
    i, se, fs, fe = _forces(placement)
    row = torch.nonzero(se.shards.tag == i).flatten()
    y_frac = float(se.shards.x[row, 1] / se.box.h_np()[1, 1])
    assert y_frac == 1.0                   # the wrap rounded it onto y = L
    assert float(fe[i].norm()) > 0.1
    assert float((fs - fe).norm(dim=1).max()) < 1e-3
