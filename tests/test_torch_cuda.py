"""The CUDA kernels of lammps_plugins_tpu_torch against their plain-PyTorch
twins, on the card.

Every test needs an NVIDIA GPU (marker `cuda`) and skips without one.
This file imports no JAX, so on a GPU machine without it run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Inputs come from the port's own rebuild of the jiggled 72-atom scene
(numpy seed), made on the CPU in float32 and moved to the card.  Bars are
the JAX suite's: REBO 5e-4 x scale, mirror 1e-5 x scale, LJ 2e-4 x scale
and energy 2e-5 relative, select-k exact.  The REBO kernel is checked with
the synthetic parameters and with degree-6 g and gamma polynomials.  An
Engine on the card, built with default arguments, launches all four
kernels and refuses the host build and the autograd force fallback.
"""

import numpy as np
import pytest
import torch

from lammps_plugins_tpu.core import units
from lammps_plugins_tpu_torch.api.scenes import (rebomos_bulk,
                                                 rebomos_bulk_commensurate)
from lammps_plugins_tpu_torch.fixes.nve import FixNVE
from lammps_plugins_tpu_torch.neighbor.build import build_neighbor_data
from lammps_plugins_tpu_torch.ops import lj_cells, mirror, rebo, select_k
from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
from lammps_plugins_tpu_torch.run.simulation import Engine
from torch_parity import SYNTH_REBO, cuda, sextic_tables  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def small():
    """(pair, state, nbr) of the jiggled 72-atom scene, f32, CPU."""
    st = rebomos_bulk_commensurate(3, 4, 1, dtype=torch.float32)
    rng = np.random.default_rng(4)
    x = st.x.numpy() + rng.uniform(-0.12, 0.12, st.x.shape)
    st = st.replace(x=torch.as_tensor(x, dtype=torch.float32))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32)
    eng = Engine(st, pair, [FixNVE()], units.METAL)
    eng.rebuild_neighbors()
    return pair, eng.state, eng.nbr


def _planes(pair, st, nbr, dev):
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                               nbr.lists["rebo"], st.box.h)
    return [p.to(dev).contiguous() for p in planes]


def _rebo_kernel_vs_twin(planes, consts):
    before = rebo.launches
    gk = rebo.rebo_cotangents(*planes, consts)
    torch.cuda.synchronize()
    assert rebo.launches == before + 1
    gt = rebo.rebo_cotangents_ref(*planes, consts)
    scale = max(float(g.abs().max()) for g in gt)
    assert scale > 1e-3
    for a, b in zip(gk, gt):
        assert float((a - b).abs().max()) <= 5e-4 * scale


def test_rebo_kernel_matches_twin(cuda, small):
    pair, st, nbr = small
    _rebo_kernel_vs_twin(_planes(pair, st, nbr, cuda), pair._rebo_consts)


def test_rebo_kernel_matches_twin_sextic(cuda, small):
    """Every b2..b6 and bg2..bg6 constant slot non-zero."""
    pair, st, nbr = small
    _rebo_kernel_vs_twin(_planes(pair, st, nbr, cuda),
                         rebo.derive_rebo_constants(sextic_tables()))


def test_rebo_kernel_rejects_float64(cuda, small):
    pair, st, nbr = small
    planes = [p.double() for p in _planes(pair, st, nbr, cuda)]
    with pytest.raises(TypeError):
        rebo.rebo_cotangents(*planes, pair._rebo_consts)


def test_mirror_kernel_matches_twin_and_is_deterministic(cuda, small):
    pair, st, nbr = small
    rl = nbr.lists["rebo"]
    g = rebo.rebo_cotangents_ref(*_planes(pair, st, nbr, cuda),
                                 pair._rebo_consts)
    mirT, mirv = rl.mirT.to(cuda), rl.mirvT.float().to(cuda)
    fk = mirror.mirror_combine(*g, mirT, mirv)
    ft = mirror.mirror_combine_ref(*g, mirT, mirv)
    assert float((fk - ft).abs().max()) <= 1e-5 * float(ft.abs().max())
    assert torch.equal(fk, mirror.mirror_combine(*g, mirT, mirv))


def test_lj_kernel_matches_twin(cuda, small):
    pair, st, nbr = small
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h).to(cuda)
    ar = nbr.cells.a_range
    ok = lj_cells.lj_cell_forces(P, pair._lj_consts, ar, with_energy=True)
    ot = lj_cells.lj_cell_forces_ref(P, pair._lj_consts, ar,
                                     with_energy=True)
    scale = float(ot[..., :3, :].abs().max())
    assert scale > 1e-4
    assert float((ok[..., :3, :] - ot[..., :3, :]).abs().max()) \
        <= 2e-4 * scale
    ek, et = (float(o[..., 3, :].double().sum()) for o in (ok, ot))
    assert abs(ek - et) <= 2e-5 * abs(et)


def _keys(dev, N=1000, W=768, seed=3):
    rng = np.random.default_rng(seed)
    keys = np.round(rng.uniform(0.0, 10.0, (N, W)) * 2.0) / 2.0   # ties
    keys[rng.uniform(size=(N, W)) >= 0.05] = np.inf
    keys[0] = np.inf                                   # exhausted row
    ids = rng.integers(0, 2 ** 24, (N, W))
    types = rng.integers(1, 3, (N, W))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (keys, ids, types)]


def test_select_k_kernel_matches_twin_exactly(cuda):
    keys, ids, types = _keys(cuda)
    out_k = select_k.select_k(keys, 16, payloads=(ids, types))
    out_t = select_k.select_k_ref(keys, 16, payloads=(ids, types))
    for a, b in zip(out_k, out_t):
        assert torch.equal(a, b)
    assert (out_k[0][0] == keys.shape[1]).all()


def test_select_k_kernel_rejects_wide_rows(cuda):
    keys = torch.zeros((4, select_k.MAX_W + 128), device=cuda)
    with pytest.raises(ValueError):
        select_k.select_k(keys, 8)


def test_engine_on_card_launches_every_kernel(cuda):
    """A short f32 run of the 288-atom scene on the card, Engine built
    with default arguments, goes through all four kernels and stays within
    1e-2 RMS(F) of the f64 CPU forces."""
    mods = (rebo, mirror, lj_cells, select_k)
    for m in mods:
        m.launches = 0
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device=cuda)
    eng = Engine(rebomos_bulk(dtype=torch.float32, device=cuda), pair,
                 [FixNVE()], units.METAL)
    rows = eng.run(20, thermo_every=10)
    assert all(m.launches > 0 for m in mods)
    assert all(np.isfinite(r["etotal"]) for r in rows)
    ref = Engine(rebomos_bulk(), REBOMoS.from_file(SYNTH_REBO, ["M", "S"]),
                 [FixNVE()], units.METAL)
    ref.run(20)
    f64 = ref.state.f.numpy()
    f32 = eng.state.f.double().cpu().numpy()
    rms = np.sqrt(np.mean(f64 * f64))
    assert np.abs(f32 - f64).max() < 1e-2 * rms


def test_plain_paths_refused_on_card(cuda):
    """A CUDA state never takes the host build or the autograd forces."""
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device=cuda)
    eng = Engine(rebomos_bulk(dtype=torch.float32, device=cuda), pair,
                 [FixNVE()], units.METAL)
    eng.device_rebuild = False
    with pytest.raises(RuntimeError):
        eng.rebuild_neighbors()
    st = eng.state
    xw, _ = st.box.wrap_np(st.x.double().cpu().numpy())
    host = build_neighbor_data(xw, st.type.cpu().numpy(), st.box,
                               pair.neighbor_requests(), skin=eng.skin,
                               dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError):
        pair.forces(st.x, st.type, host, st.box.h)
