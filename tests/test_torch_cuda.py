"""The CUDA kernels of lammps_plugins_tpu_torch against their plain-PyTorch
twins, on the card.

Every test needs an NVIDIA GPU (marker `cuda`) and skips without one.
This file imports no JAX, so on a GPU machine without it run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Inputs come from the port's own rebuild of the jiggled 72-atom scene,
and for the kernels of the other force configurations (Newton-half LJ,
mirror rows, reaction combine) of a jiggled, spatially sorted 2,304-atom
scene with route tables (numpy seeds), made on the CPU in float32 and
moved to the card.  Bars are the JAX suite's: REBO 5e-4 x scale, mirror,
mirror rows and reaction combine 1e-5 x scale, LJ 2e-4 x scale (and the
Newton-half kernel within 3e-4 x scale of the full one) and energy 2e-5
relative, select-k, the fused candidate selection and the pin copy exact.
Select-k also runs on rows with 0, fewer than K, exactly 32, more than 32
and all-tied hits; the candidate selection on the arguments of the 72-atom
and the sorted 2,304-atom CPU rebuilds (the latter also with fine cells
too small, so that they overflow), against its twin on the card and on
the CPU.  The reaction combine reads the rebuild's target-major table.
The REBO kernel is checked with the synthetic parameters and with
degree-6 g and gamma polynomials,
its emit_rows table bit for bit against its planes, and on synthetic
planes at K = 8, 16, 20, 36 and 64 that hold atoms with no live edge,
masked-in slots past rcmax and (K > 32) atoms with more than 32 live
edges: dead slots exactly 0, reruns bit-identical.  The pin copy is exact
on odd element counts and on views that start off a 16-byte boundary.
The LJ sweeps (full and Newton-half) are also held against their twins
on synthetic cell planes: C = 8, 33, 104 and 200 slots a cell (ragged
tiles, cells of up to seven warps' tiles), slots permuted at random
within each cell (culling needs no order), cells so large that whole
tiles and groups are culled, and cells that hold only pads; every case
reruns bit-identically.  An Engine on the card, built with default
arguments, launches the main path's four kernels (the rebuild's fused
candidate selection, not the standalone select-k) and refuses the host
build and the autograd force fallback; one per force configuration
launches that configuration's kernels.  Those runs go through the device
loop's CUDA graphs (the default on the card), whose wrappers' counters
count replays.  The graph loop is held against the eager loop
(fused_loop=False) bit for bit (x, v, f, image, rebuild count) after 200
steps on the sorted 2,304-atom scene at 600 K and on the 97,920-atom bench
scene, also across a plan change that recaptures the graph; one span
replays with PyTorch's sync debug mode set to raise, and each replay adds
one segment's launches to the counters.  The stamps inside the captured
loop time a rebuild within 0.5-1.5x of an eager one's device time, and a
span still copies the control vector to the host once a read.

The AEAM + fix nvt path (tests/data/AlSi.synthetic.aeam): the candidate
selection exact against its twin at K = 144, 224 and 256 on the arguments
of an Al-Si rebuild (select-k also on rows of up to 300 hits at those K);
the graph loop bit for bit against the eager loop on the jiggled 5 %-Si
nc=6 scene (x, v, f, image, the Nose-Hoover chain and its step count, the
rebuild count), a discarded span that restores the chain, an in-loop
overflow that the Engine recovers from, and a span under the sync debug
mode.

Config 2 (lj/cut/coul/cut, fix bfield, pair_style none): the 1,024-ion
charged melt deck's graph loop bit for bit against its eager loop over 300
steps (x, v, f, image, fix bfield's extras, the rebuild count), with the
deck's 200 T field and with a time-varying Bz, a Bx and a region; D' and
kernel I the only kernels; forces that rerun bit-identically.  The
candidate selection exact against its twin on free ions whose rows have
no hit (all of them, or all but those of 64 close pairs).  The cyclotron
oracle in f32 (512 free ions, Bz 1000 T, one period of 2,000 steps).  The f32
lj/cut and lj/cut/coul/cut forces on the card within 1e-2 RMS(F) of the
f64 CPU path.  Kernel I (lj/cut and lj/cut/coul/cut forces from each
atom's own list row) against its twin and the edge sweep plus mirror
combine on lj_melt(12), the charged melt, a 21-type mixture and the
wide-cut melt (K past 352), reruns bit-identical, and the same bits on a
list padded with masked slots (another K); its refusals (float64,
an int32 idx, tables past shared memory); in.lj's graph loop equal to its
eager loop bit for bit, one kernel I launch a step.

The input-script slice: REBOMoS energy_peratom and virial_peratom on the
card (kernels A, B and C, no float atomics) within 1e-4 and 5e-4 of their
scale of the f64 CPU twin on the sorted 2,304-atom scene's lists, reruns
bit-identical; a deck with compute pe/atom and stress/atom dumped through
the graph loop writes the same bytes twice; fix langevin's graph loop
equals its eager loop bit for bit and its noise on the card the CPU draw;
a ramped fix nvt over two runs (the window re-anchored by each) captures
anew and equals the eager loop bit for bit.

The thermo row without autograd: REBOMoS.energy_virial on the card
launches A and C once each under no_grad and reaches no twin and no
torch.autograd.grad (lj="full" and "half"), within 2e-5 (pe) and 5e-4 x
max|W| of the f64 CPU autograd; energy_force_virial adds only the
combine; host-built lists raise; the sharded thermo and potential_energy
launch A and C once a shard.  Kernel C's virial rows (with_virial) within
2e-4 of their scale of the twin on every LJ sweep case, reruns
bit-identical, the forces and energy row with the flag on equal to those
without it.

The sharded engine with its shards stacked on the card (864 atoms in four
x-slabs, 1,296 in a 2x2 grid): the captured iteration (every shard's
resettle under the conditional node, then the segment) equals the eager
host loop bit for bit over 60 steps with resettles; A, B, C and D' on
shard 0's own block (pad rows parked outside the slab box, halo rows, a
box non-periodic in x) against their twins, D' exact with the pad rows
skipped.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_plugins_tpu_torch.api.scenes import (rebomos_bulk,
                                                 rebomos_bulk_commensurate)
from lammps_plugins_tpu_torch.core import units
from lammps_plugins_tpu_torch.fixes.nve import FixNVE
from lammps_plugins_tpu_torch.neighbor.build import build_neighbor_data
from lammps_plugins_tpu_torch.ops import (lj_cells, lj_half, ljcut, mirror,
                                          mirror_rows, pin, react, rebo,
                                          select_candidates, select_k)
from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
from lammps_plugins_tpu_torch.run.simulation import Engine
from torch_parity import (SYNTH_REBO, cuda, ljcut_scene,  # noqa: F401
                          permute_cell_slots, rebuild_with_spy,
                          sextic_tables, synthetic_lj_planes,
                          synthetic_rebo_planes)

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.fixture(scope="module")
def small():
    """(pair, state, nbr) of the jiggled 72-atom scene, f32, CPU."""
    _need_cuda()
    st = rebomos_bulk_commensurate(3, 4, 1, dtype=torch.float32,
                                   device="cpu")
    rng = np.random.default_rng(4)
    x = st.x.numpy() + rng.uniform(-0.12, 0.12, st.x.shape)
    st = st.replace(x=torch.as_tensor(x, dtype=torch.float32))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device="cpu")
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


@pytest.mark.parametrize("sextic", [False, True])
def test_rebo_emit_rows_are_its_planes(cuda, small, sextic):
    """The [K, Np, 4] rows hold the planes of the same launch bit for bit,
    component 3 zero, and the planes equal a launch without rows."""
    pair, st, nbr = small
    consts = (rebo.derive_rebo_constants(sextic_tables()) if sextic
              else pair._rebo_consts)
    planes = _planes(pair, st, nbr, cuda)
    gx, gy, gz, g4 = rebo.rebo_cotangents(*planes, consts, emit_rows=True)
    torch.cuda.synchronize()
    for a, g in enumerate((gx, gy, gz)):
        assert torch.equal(g4[..., a], g)
    assert not g4[..., 3].any()
    for a, b in zip((gx, gy, gz), rebo.rebo_cotangents(*planes, consts)):
        assert torch.equal(a, b)


KS = [8, 16, 20, 36, 64]


@pytest.mark.parametrize("K", KS)
def test_rebo_kernel_matches_twin_at_k(cuda, K):
    """Synthetic planes at K: the kernel within 5e-4 x scale of its twin,
    exactly 0 on every masked or past-rcmax slot, and (K > 32) atoms with
    more than 32 live edges take the kernel's recompute branch."""
    planes, dead = synthetic_rebo_planes(K, 8 * 37 + 3, seed=K)
    planes = [p.to(cuda) for p in planes]
    consts = rebo.derive_rebo_constants(sextic_tables())
    before = rebo.launches
    gk = rebo.rebo_cotangents(*planes, consts)
    torch.cuda.synchronize()
    assert rebo.launches == before + 1
    gt = rebo.rebo_cotangents_ref(*planes, consts)
    scale = max(float(g.abs().max()) for g in gt)
    assert scale > 1e-3
    for a, b in zip(gk, gt):
        assert float((a - b).abs().max()) <= 5e-4 * scale
    dead = dead.to(cuda)
    for a in gk:
        assert not bool(a[dead].any())
    live = (~dead).sum(dim=0)
    assert int((live == 0).sum()) > 0
    if K > 32:
        assert int((live > 32).sum()) >= 8


@pytest.mark.parametrize("K", KS)
def test_rebo_kernel_reruns_and_rows_are_bit_identical_at_k(cuda, K):
    planes, _ = synthetic_rebo_planes(K, 8 * 37 + 3, seed=K + 1)
    planes = [p.to(cuda) for p in planes]
    consts = rebo.derive_rebo_constants(sextic_tables())
    first = rebo.rebo_cotangents(*planes, consts)
    *g3, g4 = rebo.rebo_cotangents(*planes, consts, emit_rows=True)
    again = rebo.rebo_cotangents(*planes, consts)
    torch.cuda.synchronize()
    for a, b, c in zip(first, g3, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a in range(3):
        assert torch.equal(g4[..., a], g3[a])
    assert not g4[..., 3].any()


@pytest.mark.parametrize("K", [96, 128, 256, 2688])
def test_rebo_kernel_matches_twin_past_k64(cuda, K):
    """Past the old K = 64 (eight atoms a block up to K = 256, fewer
    above, and at K = 2688 the planes staged in 32-slot-multiple groups):
    within 5e-4 x scale of the twin, dead slots exactly 0, reruns and the
    emit_rows table bit-identical, and float64 still refused."""
    wide = K > 256
    if wide:
        assert rebo.rebo_plan(K)[1] < K
    planes, dead = synthetic_rebo_planes(K, 16 if wide else 8 * 37 + 3,
                                         seed=K, dense=2 if wide else 8)
    planes = [p.to(cuda) for p in planes]
    consts = rebo.derive_rebo_constants(sextic_tables())
    before = rebo.launches
    gk = rebo.rebo_cotangents(*planes, consts)
    *g3, g4 = rebo.rebo_cotangents(*planes, consts, emit_rows=True)
    torch.cuda.synchronize()
    assert rebo.launches == before + 2
    gt = rebo.rebo_cotangents_ref(*planes, consts)
    scale = max(float(g.abs().max()) for g in gt)
    assert scale > 1e-3
    dead = dead.to(cuda)
    for a, b, c in zip(gk, gt, g3):
        assert float((a - b).abs().max()) <= 5e-4 * scale
        assert torch.equal(a, c) and not bool(a[dead].any())
    for a in range(3):
        assert torch.equal(g4[..., a], g3[a])
    assert int(((~dead).sum(dim=0) > 32).sum()) >= 2
    with pytest.raises(TypeError):
        rebo.rebo_cotangents(*[p.double() for p in planes], consts)


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


def _lj_sweeps_match_twins(P, consts, a_range):
    """C (with its energy row) and E on the card against their twins and
    each other; reruns bit-identical.  Returns (C out, E out)."""
    before = (lj_cells.launches, lj_half.launches)
    ok = lj_cells.lj_cell_forces(P, consts, a_range, with_energy=True)
    hk = lj_half.lj_cell_forces_half(P, consts, a_range)
    torch.cuda.synchronize()
    assert (lj_cells.launches, lj_half.launches) == (before[0] + 1,
                                                     before[1] + 1)
    ot = lj_cells.lj_cell_forces_ref(P, consts, a_range, with_energy=True)
    scale = float(ot[..., :3, :].abs().max())
    assert scale > 1e-4
    assert float((ok[..., :3, :] - ot[..., :3, :]).abs().max()) \
        <= 2e-4 * scale
    assert not ok[..., 4:, :].any()
    ek, et = (float(o[..., 3, :].double().sum()) for o in (ok, ot))
    assert abs(ek - et) <= 2e-5 * abs(et)
    fk = lj_cells.lj_cell_forces(P, consts, a_range)
    assert float((fk[..., :3, :] - ot[..., :3, :]).abs().max()) \
        <= 2e-4 * scale
    assert not fk[..., 3:, :].any()
    ht = lj_half.lj_cell_forces_half_ref(P, consts, a_range)
    assert float((hk - ht).abs().max()) <= 2e-4 * scale
    assert float((hk - ok[..., 0:3, :].permute(0, 1, 2, 4, 3)).abs().max()) \
        <= 3e-4 * scale
    assert torch.equal(ok, lj_cells.lj_cell_forces(P, consts, a_range,
                                                   with_energy=True))
    assert torch.equal(fk, lj_cells.lj_cell_forces(P, consts, a_range))
    assert torch.equal(hk, lj_half.lj_cell_forces_half(P, consts, a_range))
    _lj_virial_rows_match_twin(P, consts, a_range, ok, fk)
    return ok, hk


def _lj_virial_rows_match_twin(P, consts, a_range, ok, fk):
    """C with with_virial: the six rows against the twin's at 2e-4 x their
    scale per slot, reruns bit-identical, and the forces and energy row
    with the flag on equal to those with it off, bit for bit."""
    before = lj_cells.launches
    ov, vk = lj_cells.lj_cell_forces(P, consts, a_range, with_energy=True,
                                     with_virial=True)
    fv, vk2 = lj_cells.lj_cell_forces(P, consts, a_range, with_virial=True)
    torch.cuda.synchronize()
    assert lj_cells.launches == before + 2
    _, vt = lj_cells.lj_cell_forces_ref(P, consts, a_range,
                                        with_virial=True)
    assert vk.shape == vt.shape == ok.shape[:3] + (6, ok.shape[-1])
    vscale = float(vt.abs().max())
    assert vscale > 1e-4
    assert float((vk - vt).abs().max()) <= 2e-4 * vscale
    assert torch.equal(ov, ok) and torch.equal(fv, fk)
    assert torch.equal(vk, vk2)
    again = lj_cells.lj_cell_forces(P, consts, a_range, with_energy=True,
                                    with_virial=True)
    assert torch.equal(again[0], ov) and torch.equal(again[1], vk)


@pytest.mark.parametrize("C", [8, 33, 104, 200])
def test_lj_sweeps_on_ragged_tiles(cuda, C):
    P, consts, ar = synthetic_lj_planes(C=C, seed=C)
    _lj_sweeps_match_twins(P.to(cuda), consts, ar)


def test_lj_sweeps_on_permuted_slots(cuda):
    """Atoms and pads interleaved at random within every cell: the same
    forces, slot for slot, as the sorted cells."""
    P, consts, ar = synthetic_lj_planes(C=104, occ=90, seed=5)
    Pp, perm = permute_cell_slots(P, seed=5)
    ok, hk = _lj_sweeps_match_twins(P.to(cuda), consts, ar)
    okp, hkp = _lj_sweeps_match_twins(Pp.to(cuda), consts, ar)
    (x0, x1), (y0, y1), (z0, z1) = ar
    pa = perm[x0:x1, y0:y1, z0:z1].to(cuda)
    scale = float(ok[..., :3, :].abs().max())
    back = torch.gather(ok, -1, pa[..., None, :].expand(ok.shape))
    assert float((okp[..., :3, :] - back[..., :3, :]).abs().max()) \
        <= 2e-4 * scale
    back = torch.gather(hk, -2, pa[..., None].expand(hk.shape))
    assert float((hkp - back).abs().max()) <= 3e-4 * scale


def test_lj_sweeps_with_culled_tiles(cuda):
    """Cells of 24 A, over twice the largest LJ cutoff: most (A tile,
    B group) pairs are culled, and the forces still match."""
    P, consts, ar = synthetic_lj_planes(C=104, occ=104, cell=24.0, seed=7)
    tested, live = lj_cells.candidate_pairs(P, consts, ar)
    assert tested < 0.5 * live
    tested_h, live_h, _ = lj_half.candidate_pairs_half(P, consts, ar)
    assert tested_h < 0.5 * live_h
    _lj_sweeps_match_twins(P.to(cuda), consts, ar)


def test_lj_sweeps_on_pad_only_cells(cuda):
    """Cells with no atom, inside the A range and in the halo ring: their
    slots get exactly zero, and their neighbours match the twins."""
    empty = [(2, 2, 2), (1, 3, 2), (3, 1, 1), (0, 2, 2), (4, 4, 4),
             (2, 0, 3)]
    P, consts, ar = synthetic_lj_planes(C=104, occ=80, empty=empty, seed=9)
    ok, hk = _lj_sweeps_match_twins(P.to(cuda), consts, ar)
    for c in [(2, 2, 2), (1, 3, 2), (3, 1, 1)]:
        a = tuple(i - 1 for i in c)
        assert not ok[a].any() and not hk[a].any()


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


@pytest.mark.parametrize("hits,K,W", [
    (0, 16, 512), (5, 16, 512), (32, 16, 512), (33, 16, 512),
    (200, 16, 512), (32, 40, 512), (100, 40, 1024), (300, 128, 384),
    ("tied", 16, 512), ("tied", 40, 128), ("tied", 20, 1024),
    (115, 144, 1024), (144, 144, 512), (200, 224, 1024), (256, 256, 512),
    (257, 144, 512), (300, 256, 1024), ("tied", 144, 1024),
    (0, 320, 2048), (300, 320, 1024), (320, 320, 2048), (512, 320, 2048),
    (600, 320, 2048), (1024, 1024, 4096), (1100, 1024, 4096),
    (3000, 1024, 4096), ("tied", 512, 2048), ("tied_full", 320, 2048),
    ("tied_full", 1024, 4096)])
def test_select_k_kernel_by_hits_per_row(cuda, hits, K, W):
    """Rows with 0, fewer than K, exactly 32, more than 32, exactly K, more
    than K and all-tied finite keys (the lanes' bitonic sort up to 32
    hits, the buffer's up to its next power of two >= max(K, 64), the
    radix select past it), K above 32, 128 and 256 too: positions and
    payloads exact, reruns identical."""
    N = 67
    rng = np.random.default_rng(W + K)
    keys = np.full((N, W), np.inf, np.float32)
    for r in range(N):
        n = (min(W, rng.integers(1, 90)) if hits == "tied"
             else rng.integers(K, W) if hits == "tied_full" else hits)
        cols = rng.choice(W, size=n, replace=False)
        keys[r, cols] = (1.5 if hits in ("tied", "tied_full")
                         else np.round(rng.uniform(0.0, 4.0, n) * 4.0) / 4.0)
    ids = rng.integers(0, 2 ** 24, (N, W)).astype(np.float32)
    typ = rng.integers(1, 3, (N, W)).astype(np.float32)
    keys, ids, typ = (torch.as_tensor(a, device=cuda)
                      for a in (keys, ids, typ))
    before = select_k.launches
    out_k = select_k.select_k(keys, K, payloads=(ids, typ))
    torch.cuda.synchronize()
    assert select_k.launches == before + 1
    out_t = select_k.select_k_ref(keys, K, payloads=(ids, typ))
    again = select_k.select_k(keys, K, payloads=(ids, typ))
    for a, b, c in zip(out_k, out_t, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("W,K", [(2048, 16), (2048, 320), (4096, 64),
                                 (4096, 1024)])
def test_select_k_kernel_on_wide_rows(cuda, W, K):
    """Rows past the old W = 1024, read in 1,024-column chunks (~5 % of
    the keys finite: rows of more hits than the buffer holds at K = 16
    and 64 take the radix select): positions and payloads exact, reruns
    identical."""
    keys, ids, types = _keys(cuda, N=300, W=W, seed=W + K)
    out_k = select_k.select_k(keys, K, payloads=(ids, types))
    out_t = select_k.select_k_ref(keys, K, payloads=(ids, types))
    again = select_k.select_k(keys, K, payloads=(ids, types))
    for a, b, c in zip(out_k, out_t, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    hits = (keys < float("inf")).sum(dim=1)
    assert int((hits > select_k.hit_capacity(K)).sum()) > 0 or K > 64


def _candidate_call(scene, cand_capacity=None):
    """The arguments and CPU (twin) result of the select_candidates call of
    a float32 CPU rebuild: the jiggled 72-atom scene, the jiggled, sorted
    2,304-atom one, or that one on its perfect lattice (lattice2k: exact
    ties of rsq); cand_capacity cuts the fine cells (overflow)."""
    sort = scene != "small"
    nxyz = (12, 16, 2) if sort else (3, 4, 1)
    st = rebomos_bulk_commensurate(*nxyz, dtype=torch.float32, device="cpu",
                                   sort=sort)
    if scene != "lattice2k":
        rng = np.random.default_rng(6 if sort else 4)
        x = st.x.numpy() + rng.uniform(-0.1, 0.1, st.x.shape)
        st = st.replace(x=torch.as_tensor(x, dtype=torch.float32))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device="cpu")
    eng = Engine(st, pair, [FixNVE()], units.METAL)
    eng.rebuild_neighbors()
    plan = eng._plan
    if cand_capacity:
        plan = dataclasses.replace(plan, cand_capacity=cand_capacity)
    st = eng.state
    (_, _, _, flags), calls = rebuild_with_spy(
        plan, st.x, st.image, st.type, *eng._box_dev,
        pair.neighbor_requests())
    assert bool(flags["candcell_overflow"]) == bool(cand_capacity)
    return calls[0]


@pytest.mark.parametrize("scene,cap", [("small", None), ("sorted2k", None),
                                       ("sorted2k", 4), ("lattice2k", None)])
def test_select_candidates_kernel_matches_twin_exactly(cuda, scene, cap):
    """D' on the card: idx, jtype, mask and kmax equal to its twin's on the
    card and on the CPU, element for element; reruns identical."""
    args, out_cpu = _candidate_call(scene, cap)
    dargs = [a.to(cuda) if hasattr(a, "to") else a for a in args]
    before = select_candidates.launches
    out_k = select_candidates.select_candidates(*dargs)
    torch.cuda.synchronize()
    assert select_candidates.launches == before + 1
    out_t = select_candidates.select_candidates_ref(*dargs)
    again = select_candidates.select_candidates(*dargs)
    for a, b, c, d in zip(out_k, out_t, out_cpu, again):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c) \
            and torch.equal(a, d)
    assert int(out_k[3]) > 0


@pytest.fixture(scope="module")
def sorted2k():
    """(pair, state, nbr) of the jiggled, spatially sorted 2,304-atom scene
    with route tables, f32, CPU."""
    _need_cuda()
    st = rebomos_bulk_commensurate(12, 16, 2, dtype=torch.float32,
                                   device="cpu", sort=True)
    rng = np.random.default_rng(6)
    x = st.x.numpy() + rng.uniform(-0.08, 0.08, st.x.shape)
    st = st.replace(x=torch.as_tensor(x, dtype=torch.float32))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device="cpu", combine="react",
                             react_gate=False)
    eng = Engine(st, pair, [FixNVE()], units.METAL)
    eng.rebuild_neighbors()
    assert eng.nbr.lists["rebo"].route is not None
    return pair, eng.state, eng.nbr


def _planes_2k(sorted2k, dev):
    pair, st, nbr = sorted2k
    g = rebo.rebo_cotangents_ref(*_planes(pair, st, nbr, dev),
                                 pair._rebo_consts)
    return [t.contiguous() for t in g]


def test_mirror_rows_kernel_matches_twin(cuda, sorted2k):
    _, _, nbr = sorted2k
    rl = nbr.lists["rebo"]
    gx, gy, gz = _planes_2k(sorted2k, cuda)
    K, Np = gx.shape
    g4 = torch.stack([gx, gy, gz, torch.zeros_like(gx)], dim=-1)
    gmir4 = g4.reshape(K * Np, 4)[rl.mirT.to(cuda).reshape(-1).long()] \
        .reshape(K, Np, 4).contiguous()
    mv = rl.mirvT.float().to(cuda)
    before = mirror_rows.launches
    fk = mirror_rows.mirror_combine_rows(gx, gy, gz, gmir4, mv)
    torch.cuda.synchronize()
    assert mirror_rows.launches == before + 1
    ft = mirror_rows.mirror_combine_rows_ref(gx, gy, gz, gmir4, mv)
    assert float((fk - ft).abs().max()) <= 1e-5 * float(ft.abs().max())
    assert torch.equal(fk, mirror_rows.mirror_combine_rows(gx, gy, gz,
                                                           gmir4, mv))


def test_react_kernel_matches_twin_and_is_deterministic(cuda, sorted2k):
    _, _, nbr = sorted2k
    rl = nbr.lists["rebo"]
    g = _planes_2k(sorted2k, cuda)
    rb, rt, tg = (t.to(cuda) for t in (rl.rblocks, rl.route, rl.rtgt))
    before = react.launches
    fk = react.react_combine(*g, tg)
    torch.cuda.synchronize()
    assert react.launches == before + 1
    ft = react.react_combine_target_ref(*g, tg)
    scale = float(ft.abs().max())
    assert scale > 1e-3
    assert float((fk - ft).abs().max()) <= 1e-5 * scale
    assert torch.equal(fk, react.react_combine(*g, tg))
    # the same forces as the route tables' twin and the mirror gather
    fr = react.react_combine_ref(*g, rb, rt)
    assert float((fk - fr).abs().max()) <= 1e-5 * scale
    fm = mirror.mirror_combine(*g, rl.mirT.to(cuda), rl.mirvT.float().to(cuda))
    assert float((fk - fm).abs().max()) <= 1e-5 * scale


def test_lj_half_kernel_matches_twin_and_full_kernel(cuda, sorted2k):
    pair, st, nbr = sorted2k
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h).to(cuda)
    ar, lc = nbr.cells.a_range, pair._lj_consts
    before = lj_half.launches
    fk = lj_half.lj_cell_forces_half(P, lc, ar)
    torch.cuda.synchronize()
    assert lj_half.launches == before + 1
    ft = lj_half.lj_cell_forces_half_ref(P, lc, ar)
    scale = float(ft.abs().max())
    assert scale > 1e-4
    assert float((fk - ft).abs().max()) <= 2e-4 * scale
    full = lj_cells.lj_cell_forces(P, lc, ar)[..., 0:3, :] \
        .permute(0, 1, 2, 4, 3)
    assert float((fk - full).abs().max()) <= 3e-4 * scale
    assert torch.equal(fk, lj_half.lj_cell_forces_half(P, lc, ar))


@pytest.mark.parametrize("shape", [(3 * 16 * 2304 // 128, 128),
                                   (16, 3 * 2304), (2304, 64), (7, 13)])
def test_pin_copy_is_exact(cuda, shape):
    """The [R, 128], [K, 3 Np] and [Np, Wr] shapes, and one with a tail
    that is not a multiple of 4."""
    a = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    a = a.to(cuda)
    before = pin.launches
    out = pin.pin_copy(a)
    torch.cuda.synchronize()
    assert pin.launches == before + 1
    assert out.data_ptr() != a.data_ptr() and torch.equal(out, a)


@pytest.mark.parametrize("shape,offset", [
    ((1, 1), 0), ((3, 5), 0), ((1000, 37), 0), ((7, 13), 1), ((7, 13), 2),
    ((7, 13), 3), ((16, 3 * 2304), 1), ((2304, 64), 3)])
def test_pin_copy_is_exact_on_odd_counts_and_offset_views(cuda, shape,
                                                          offset):
    """An offset view starts `offset` floats past a 16-byte boundary."""
    n = shape[0] * shape[1]
    base = torch.randn(n + 8, generator=torch.Generator().manual_seed(5))
    a = base.to(cuda)[offset:offset + n].view(shape)
    assert a.is_contiguous() and (a.data_ptr() % 16 == 4 * offset)
    before = pin.launches
    out = pin.pin_copy(a)
    torch.cuda.synchronize()
    assert pin.launches == before + 1
    assert torch.equal(out, a)


def test_pin_rows_keep_the_jax_shapes(cuda, small):
    pair, st, nbr = small
    g = rebo.rebo_cotangents_ref(*_planes(pair, st, nbr, cuda),
                                 pair._rebo_consts)
    stacked = torch.stack(g, dim=-1)
    K, Np, _ = stacked.shape
    for fn in (pin.pin_rows3, pin.pin_rows3_v2):
        out = fn(stacked)
        assert out.shape == (K * Np, 3)
        assert torch.equal(out, stacked.reshape(K * Np, 3))


def test_new_wrappers_reject_float64(cuda, sorted2k):
    pair, st, nbr = sorted2k
    rl = nbr.lists["rebo"]
    g = [t.double() for t in _planes_2k(sorted2k, cuda)]
    K, Np = g[0].shape
    mv = rl.mirvT.double().to(cuda)
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells,
                          st.box.h).double().to(cuda)
    calls = [
        lambda: pin.pin_copy(g[0]),
        lambda: mirror_rows.mirror_combine_rows(
            *g, torch.zeros((K, Np, 4), dtype=torch.float64, device=cuda),
            mv),
        lambda: lj_half.lj_cell_forces_half(P, pair._lj_consts,
                                            nbr.cells.a_range),
        lambda: react.react_combine(*g, rl.rtgt.to(cuda)),
        lambda: rebo.rebo_cotangents(
            *[p.double() for p in _planes(pair, st, nbr, cuda)],
            pair._rebo_consts, emit_rows=True)]
    for call in calls:
        with pytest.raises(TypeError):
            call()


@pytest.mark.parametrize("config,mods", [
    (dict(lj="half", combine="rows"), ("lj_half", "mirror_rows")),
    (dict(combine="react", react_gate=False), ("react",)),
    (dict(combine="pin"), ("pin",)),
    (dict(combine="pin2"), ("pin",))])
def test_configuration_on_card_launches_its_kernels(cuda, config, mods):
    """20 steps of the sorted 2,304-atom scene on the card: the
    configuration's kernels launch and its step-0 forces are within
    3e-4 x scale of the default configuration's."""
    import lammps_plugins_tpu_torch.ops as ops_pkg
    modules = [getattr(ops_pkg, m) for m in mods] + [rebo,
                                                     select_candidates]
    for m in modules:
        m.launches = 0
    st = rebomos_bulk_commensurate(12, 16, 2, dtype=torch.float32,
                                   device=cuda, sort=True)
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device=cuda, **config)
    eng = Engine(st, pair, [FixNVE()], units.METAL)
    eng.rebuild_neighbors()
    s = eng.state
    default = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                                device=cuda)
    f_cfg = pair.forces(s.x, s.type, eng.nbr, s.box.h)
    f_def = default.forces(s.x, s.type, eng.nbr, s.box.h)
    scale = float(f_def.abs().max())
    assert float((f_cfg - f_def).abs().max()) <= 3e-4 * scale
    rows = eng.run(20, thermo_every=10)
    assert eng._loop is not None and eng._loop.exec is not None
    assert all(np.isfinite(r["etotal"]) for r in rows)
    assert all(m.launches > 0 for m in modules)


def test_engine_on_card_launches_every_kernel(cuda):
    """A short f32 run of the 288-atom scene on the card, Engine built
    with default arguments, goes through the graph loop and all four
    kernels of the main path (REBO, mirror combine, LJ sweep, the rebuild's
    fused candidate selection; counted at each graph replay) and no
    standalone select_k, and stays within 1e-2 RMS(F) of the f64 CPU
    forces."""
    mods = (rebo, mirror, lj_cells, select_candidates)
    select_k.launches = 0
    for m in mods:
        m.launches = 0
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device=cuda)
    eng = Engine(rebomos_bulk(dtype=torch.float32, device=cuda), pair,
                 [FixNVE()], units.METAL)
    rows = eng.run(20, thermo_every=10)
    assert eng._loop is not None and eng._loop.exec is not None
    assert rebo.launches >= 20             # one per step, counted at replay
    assert all(m.launches > 0 for m in mods)
    assert select_k.launches == 0
    assert all(np.isfinite(r["etotal"]) for r in rows)
    f64 = dict(dtype=torch.float64, device="cpu")
    ref = Engine(rebomos_bulk(**f64),
                 REBOMoS.from_file(SYNTH_REBO, ["M", "S"], **f64),
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


def _hot_engine(dev, scene, fused):
    """f32 Engine on the card: the sorted 2,304-atom scene at 600 K with
    skin 0.4 (a rebuild every few segments), or chip_smoke's 97,920-atom
    bench scene at 300 K with skin 0.8; fused None (graph) or False."""
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    if scene == "sorted2k":
        st = rebomos_bulk_commensurate(12, 16, 2, dtype=torch.float32,
                                       device=dev, sort=True)
        temp, skin = 600.0, 0.4
    else:
        st = rebomos_bulk_commensurate(34, 48, 10, dtype=torch.float32,
                                       device=dev)
        temp, skin = 300.0, 0.8
    st = velocity_create(st, units.METAL, temp, 12345)
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device=dev)
    eng = Engine(st, pair, [FixNVE()], units.METAL, skin=skin)
    eng.fused_loop = fused
    return eng


def _assert_same_state(a, b):
    assert a.state.step == b.state.step
    assert a.rebuilds == b.rebuilds
    for f in ("x", "v", "f", "image"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


@pytest.mark.parametrize("scene", ["sorted2k", "bench"])
def test_graph_loop_matches_eager_loop(cuda, scene):
    """200 steps through at least three in-run rebuilds: the graph loop's
    x, v, f and image equal the eager loop's bit for bit."""
    graph, eager = (_hot_engine(cuda, scene, f) for f in (None, False))
    graph.run(200)
    eager.run(200)
    assert graph._loop is not None and graph._loop.exec is not None
    assert eager._loop is None
    assert graph.rebuilds >= 4
    _assert_same_state(graph, eager)


def test_graph_recaptures_after_plan_change(cuda):
    """A plan change between runs discards the captured graph; the new
    capture continues the eager loop's trajectory bit for bit."""
    import dataclasses
    graph, eager = (_hot_engine(cuda, "sorted2k", f) for f in (None, False))
    for eng in (graph, eager):
        eng.run(50)
    old = graph._loop
    for eng in (graph, eager):
        p = eng._plan
        eng._plan = dataclasses.replace(
            p, cand_capacity=p.cand_capacity + 8,
            ghost_capacity=p.ghost_capacity + 64)
        eng.rebuild_neighbors()
        eng.run(100)
    assert graph._loop is not old and graph._loop.plan == graph._plan
    assert old.exec is None                       # released
    _assert_same_state(graph, eager)


def test_graph_span_replays_without_host_sync(cuda):
    """One span of 16 iterations, its first with a rebuild, replayed with
    PyTorch's sync debug mode set to raise: only the control vector's copy
    (read) waits for the card.  Each replay adds one segment's launches."""
    eng = _hot_engine(cuda, "sorted2k", None)
    eng.run(20)
    loop = eng._device_loop()
    torch.cuda.synchronize()
    before = (rebo.launches, select_candidates.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.state = loop.start(eng.state, eng.nbr, True, eng._seg_dprev)
        loop.replay(16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res = loop.read()
    assert res.n_rb >= 1 and res.done >= 10
    assert rebo.launches == before[0] + 16 * eng.check_every
    assert select_candidates.launches == before[1] + res.n_rb


def test_graph_loop_times_its_rebuilds_on_the_device(cuda):
    """The stamps inside the conditional node's body read, a rebuild taken,
    within 0.5-1.5x of an eager rebuild's device time (bench scene); the
    steps' force calls are booked as Pair.forces, inside Pair."""
    import statistics
    from lammps_plugins_tpu_torch.run.device_loop import device_seconds
    eng = _hot_engine(cuda, "bench", None)
    eng.run(50)
    spans = []
    after = eng._after_span

    def record(res):
        spans.append(res)
        after(res)

    eng._after_span = record
    acc0 = dict(eng.timers.acc)
    eng.run(400)
    n_rb = sum(r.n_rb for r in spans)
    assert n_rb >= 4
    st = eng.state
    eager = statistics.median(device_seconds(
        lambda: eng.rebuild_lists(eng._plan, st.x, st.image, st.type,
                                  eng.pair.neighbor_requests()), cuda)
        for _ in range(5))
    per_rebuild = sum(r.rebuild_s for r in spans) / n_rb
    assert 0.5 * eager <= per_rebuild <= 1.5 * eager, (per_rebuild, eager)
    d = {k: v - acc0.get(k, 0.0) for k, v in eng.timers.acc.items()}
    assert d["Neigh"] >= sum(r.rebuild_s for r in spans)
    assert 0.0 < d["Pair.forces"] <= d["Pair"]


def test_graph_span_reads_its_spans_in_the_one_copy(cuda):
    """The rebuild and force seconds ride in the control vector: a span of
    the graph loop copies to the host once a read, as without them."""
    from torch.profiler import ProfilerActivity, profile
    from lammps_plugins_tpu_torch.run.device_loop import GraphIteration
    eng = _hot_engine(cuda, "sorted2k", None)
    eng.run(20)
    reads = []
    real = GraphIteration.read

    def spy(loop):
        reads.append(real(loop))
        return reads[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(GraphIteration, "read", spy)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with eng.timers.section("Pair"):
                eng._run_span_device(16 * eng.check_every)
            torch.cuda.synchronize()
    finally:
        mp.undo()
    copies = [e for e in prof.events() if e.name.startswith("Memcpy DtoH")]
    assert reads and reads[-1].n_rb >= 1 and reads[-1].forces_s > 0.0
    assert len(copies) == len(reads)


# -- AEAM + fix nvt ---------------------------------------------------------

def _aeam_call(K, overflow=False):
    """The arguments of the select_candidates call of a float32 CPU
    rebuild of the jiggled nc=5 Al-Si scene (skin 1.2) with K slots (with
    overflow: K below the rows' hits)."""
    from lammps_plugins_tpu_torch.api.scenes import alsi_sample
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    from lammps_plugins_tpu_torch.potentials.aeam import AEAM
    from torch_parity import SYNTH_AEAM
    cpu = dict(dtype=torch.float32, device="cpu")
    st = alsi_sample(nc=5, si_fraction=0.05, **cpu)
    rng = np.random.default_rng(8)
    st = st.replace(x=st.x + torch.as_tensor(
        rng.uniform(-0.15, 0.15, st.x.shape), dtype=torch.float32))
    pair = AEAM.from_file(SYNTH_AEAM, ["Al", "Si"], **cpu)
    eng = Engine(st, pair, [FixNVT(863.0, 863.0, 0.1)], units.METAL,
                 skin=1.2)
    eng.rebuild_neighbors()
    plan = dataclasses.replace(eng._plan, k_caps=(("main", K),))
    st = eng.state
    (_, _, _, flags), calls = rebuild_with_spy(
        plan, st.x, st.image, st.type, *eng._box_dev,
        pair.neighbor_requests())
    assert bool(flags["k_overflow:main"]) == overflow
    return calls[0]


def _candidates_exact(args, out_cpu, dev):
    """D' on the card on `args`: idx, jtype, mask and kmax equal to its
    twin's on the card and on the CPU (out_cpu), reruns identical; returns
    the kernel's outputs."""
    dargs = [a.to(dev) if hasattr(a, "to") else a for a in args]
    before = select_candidates.launches
    out_k = select_candidates.select_candidates(*dargs)
    torch.cuda.synchronize()
    assert select_candidates.launches == before + 1
    out_t = select_candidates.select_candidates_ref(*dargs)
    again = select_candidates.select_candidates(*dargs)
    for a, b, c, d in zip(out_k, out_t, out_cpu, again):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c) \
            and torch.equal(a, d)
    return out_k


@pytest.mark.parametrize("K", [64, 100])
def test_select_candidates_kernel_on_overflowing_rows(cuda, K):
    """D' with K below the Al-Si rows' ~115-135 hits: rows past the hit
    buffer (64 at K = 64, 128 at K = 100) take the radix select; the
    K nearest, ties to the lowest column, exact against the twin."""
    out_k = _candidates_exact(*_aeam_call(K, overflow=True), cuda)
    assert int(out_k[3]) > K


@pytest.mark.parametrize("cps", [(True, 8), (True, 2), (False, 1)])
@pytest.mark.parametrize("K", [144, 512])
def test_select_candidates_kernel_in_staged_slices(cuda, monkeypatch, cps,
                                                   K):
    """D' with the plan forced to one way of staging (bricks of 8 or 2
    cells staged, cells read in place): exact against the twin."""
    staged, bx = cps
    monkeypatch.setattr(select_candidates, "MODES", ((staged, (bx,)),))
    args, out_cpu = _aeam_call(K)
    plan = select_candidates.candidates_plan(K, args[1].shape[1],
                                             args[4].shape[0])
    assert (plan.staged, plan.bx) == (staged, bx)
    _candidates_exact(args, out_cpu, cuda)


def _lj_wide_call(n=8, cut=7.0, K=None):
    """The select_candidates call of a float32 CPU rebuild of lj_melt(n)
    with lj/cut `cut` (skin 0.3): ~1,400 neighbours a row and ~500-slot
    fine cells, whose 27 do not fit a block's shared memory at once."""
    from lammps_plugins_tpu_torch.api.scenes import lj_melt
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCut
    st = lj_melt(n, dtype=torch.float32, device="cpu").state
    pair = PairLJCut(cut, ntypes=1, dtype=torch.float32, device="cpu")
    pair.set_coeff(1, 1, 1.0, 1.0)
    pair.prepare(st.type.numpy())
    eng = Engine(st, pair, [FixNVE()], units.LJ, skin=0.3)
    eng.rebuild_neighbors()
    plan = eng._plan if K is None else dataclasses.replace(
        eng._plan, k_caps=(("main", K),))
    st = eng.state
    _, calls = rebuild_with_spy(plan, st.x, st.image, st.type,
                                *eng._box_dev, pair.neighbor_requests())
    return calls[0]


@pytest.mark.parametrize("K", [None, 1024])
def test_select_candidates_kernel_on_a_wide_lj_cut(cuda, K):
    """D' on lj_melt(8) with lj/cut 7.0: K past 1,024 (or 1,024 below the
    rows' hits, the radix select on sliced staging), the 27 cells staged
    in x-planes; exact against the twin."""
    args, out_cpu = _lj_wide_call(K=K)
    k, Cf = args[5], args[1].shape[1]
    assert not select_candidates.candidates_plan(k, Cf, 2).staged
    out_k = _candidates_exact(args, out_cpu, cuda)
    assert int(out_k[3]) > 1024


def _mixture_call(ntypes):
    """The select_candidates call of a float32 CPU rebuild of
    torch_parity.mixture_arrays(ntypes) (500 atoms, a cut per type
    pair)."""
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCut
    from torch_parity import mixture_arrays
    cpu = dict(dtype=torch.float32, device="cpu")
    x, types, length, coeffs = mixture_arrays(ntypes)
    pair = PairLJCut(3.0, ntypes=ntypes, **cpu)
    for c in coeffs:
        pair.set_coeff(*c)
    pair.prepare(types)
    st = State.create(x=x, type=types, box=Box.orthogonal([length] * 3,
                                                          **cpu),
                      mass=np.ones(ntypes + 1))
    eng = Engine(st, pair, [FixNVE()], units.LJ, skin=0.3)
    eng.rebuild_neighbors()
    st = eng.state
    _, calls = rebuild_with_spy(eng._plan, st.x, st.image, st.type,
                                *eng._box_dev, pair.neighbor_requests())
    return calls[0]


@pytest.mark.parametrize("ntypes", [21, 64])
def test_select_candidates_kernel_with_many_types(cuda, ntypes):
    """D' past the old 15 types: a [T + 1, T + 1] cut table of per-pair
    cuts in shared memory, exact against the twin."""
    args, out_cpu = _mixture_call(ntypes)
    assert tuple(args[4].shape) == (ntypes + 1, ntypes + 1)
    _candidates_exact(args, out_cpu, cuda)


@pytest.mark.parametrize("K", [144, 224, 256, 512, 1024])
def test_select_candidates_kernel_at_aeam_k(cuda, K):
    """D' past K = 128 (and past the old 256) on an Al-Si rebuild (~115-135
    hits a row): idx, jtype, mask and kmax equal its twin's on the card
    and on the CPU."""
    out_k = _candidates_exact(*_aeam_call(K), cuda)
    assert 32 < int(out_k[3]) <= K


def _graded_call(K, valid_every=0):
    """The select_candidates call of a float32 CPU rebuild (LJ units, two
    types, lj/cut 2.5 with a cut per type pair, skin 0.3) of a periodic
    box 30 sigma wide holding random blocks at densities 8, 1.5, 0.5 and
    0.15 a cubic sigma and six isolated atoms: rows of up to ~700, ~140,
    ~45, ~15 and no hits; K the list's slots; valid_every > 0 makes every
    that-many-th row a pad row (valid False: in no cell)."""
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCut
    cpu = dict(dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(12)
    blocks = (((1.0, 7.0), (1.0, 7.0), (1.0, 7.0), 8.0),
              ((10.0, 16.0), (10.0, 16.0), (10.0, 16.0), 1.5),
              ((20.0, 28.0), (1.0, 9.0), (1.0, 9.0), 0.5),
              ((1.0, 13.0), (16.0, 28.0), (16.0, 28.0), 0.15))
    x = [np.array([[20.0, 20.0, 20.0], [26.0, 20.0, 20.0],
                   [20.0, 26.0, 20.0], [20.0, 20.0, 26.0],
                   [26.0, 26.0, 26.0], [26.0, 26.0, 20.0]])]
    for bx, by, bz, rho in blocks:
        lo = np.array([bx[0], by[0], bz[0]])
        hi = np.array([bx[1], by[1], bz[1]])
        m = int(rho * np.prod(hi - lo))
        x.append(rng.uniform(lo, hi, (m, 3)))
    x = np.concatenate(x)
    types = rng.integers(1, 3, len(x))
    pair = PairLJCut(2.5, ntypes=2, **cpu)
    pair.set_coeff(1, 1, 1.0, 1.0, 2.5)
    pair.set_coeff(1, 2, 1.0, 1.0, 2.2)
    pair.set_coeff(2, 2, 1.0, 1.0, 2.0)
    pair.prepare(types)
    st = State.create(x=x, type=types, box=Box.orthogonal([30.0] * 3, **cpu),
                      mass=np.ones(3))
    eng = Engine(st, pair, [FixNVE()], units.LJ, skin=0.3)
    eng.rebuild_neighbors()
    plan = dataclasses.replace(eng._plan, k_caps=(("main", K),))
    st = eng.state
    valid = None
    if valid_every:
        valid = torch.arange(st.natoms) % valid_every != 1
    _, calls = rebuild_with_spy(plan, st.x, st.image, st.type,
                                *eng._box_dev, pair.neighbor_requests(),
                                valid=valid)
    return calls[0]


@pytest.mark.parametrize("K", [16, 144, 384, 1904])
def test_select_candidates_kernel_by_hits_per_row(cuda, K):
    """D' on rows of every kind at once: no hit (isolated atoms, and pad
    rows in no cell), 1-32 hits (the bitonic sort over the lanes), 33 to
    the hit buffer's cap (the bucket sort) and past it (the radix select);
    idx, jtype, mask and kmax equal its twin's on the card and on the
    CPU, written over buffers of 0x7f bytes (every element is written),
    reruns identical."""
    args, out_cpu = _graded_call(K, valid_every=9)
    big = 27 * args[1].shape[1]
    hits = select_candidates.select_candidates_ref(
        *args[:5], big)[2].sum(dim=1)
    cap = select_k.hit_capacity(K)
    pads = args[2][:, 0] < 0
    assert int(pads.sum()) > 0 and int((hits[~pads] == 0).sum()) > 0
    assert int(((hits >= 1) & (hits <= 32)).sum()) > 0
    assert int(((hits > 32) & (hits <= cap)).sum()) > 0
    assert int((hits > cap).sum()) > 0 or int(hits.max()) <= cap
    dargs = [a.to(cuda) if hasattr(a, "to") else a for a in args]
    n = args[2].shape[0]
    out = [torch.empty((n, K), dtype=dt, device=cuda)
           for dt in (torch.int64, torch.int64, torch.bool)]
    for o in out:
        o.view(torch.uint8).fill_(0x7F)
    out_k = select_candidates.select_candidates(*dargs, out=out)
    torch.cuda.synchronize()
    assert all(a.data_ptr() == o.data_ptr() for a, o in zip(out_k, out))
    out_t = select_candidates.select_candidates_ref(*dargs)
    again = select_candidates.select_candidates(*dargs)
    for a, b, c, d in zip(out_k, out_t, out_cpu, again):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c) \
            and torch.equal(a, d)
    assert int(out_k[3]) == int(hits.max())
    assert not out_k[2][pads.to(cuda)].any()


@pytest.mark.parametrize("mode", [(True, 4), (True, 2), (True, 8),
                                  (False, 1)])
def test_select_candidates_kernel_on_ragged_bricks(cuda, monkeypatch, mode):
    """D' with each brick (x-columns of bx cells) on the Al-Si rebuild,
    whose fine grid is 5 cells long in x, not a whole number of bricks
    (the ragged edge's bricks hold cells past the grid, which stay empty):
    exact against the twin."""
    staged, bx = mode
    monkeypatch.setattr(select_candidates, "MODES", ((staged, (bx,)),))
    args, out_cpu = _aeam_call(144)
    assert args[3][0] % bx or bx == 1
    plan = select_candidates.candidates_plan(144, args[1].shape[1],
                                             args[4].shape[0])
    assert (plan.staged, plan.bx) == mode
    _candidates_exact(args, out_cpu, cuda)


def _aeam_engine(dev, fused, si=0.05, skin=0.6):
    """f32 Engine on the card: alsi_sample(nc=6) with `si` Si, jiggled,
    NVT 863 K from velocity_create(seed 4928459), check every 12 steps;
    fused None (graph) or False (eager)."""
    from lammps_plugins_tpu_torch.api.scenes import alsi_sample
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.aeam import AEAM
    from torch_parity import SYNTH_AEAM
    st = alsi_sample(nc=6, si_fraction=si, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(5)
    st = st.replace(x=st.x + torch.as_tensor(
        rng.uniform(-0.05, 0.05, st.x.shape), dtype=torch.float32,
        device=dev))
    st = velocity_create(st, units.METAL, 863.0, 4928459)
    pair = AEAM.from_file(SYNTH_AEAM, ["Al", "Si"], dtype=torch.float32,
                          device=dev)
    eng = Engine(st, pair, [FixNVT(863.0, 863.0, 0.1)], units.METAL,
                 skin=skin, check_every=12)
    eng.fused_loop = fused
    return eng


def _assert_same_chain(a, b):
    ca, cb = a.state.extras["nvt:nvt"], b.state.extras["nvt:nvt"]
    for k in ("eta", "eta_dot", "step"):
        assert torch.equal(ca[k], cb[k]), k


def test_aeam_graph_loop_matches_eager_loop(cuda):
    """192 NVT steps with in-run rebuilds: the graph loop's x, v, f, image,
    chain state and rebuild count equal the eager loop's bit for bit, and
    D' launched."""
    select_candidates.launches = 0
    graph, eager = (_aeam_engine(cuda, f) for f in (None, False))
    graph.run(192)
    eager.run(192)
    assert graph._loop is not None and graph._loop.exec is not None
    assert graph.rebuilds >= 3 and select_candidates.launches > 0
    _assert_same_state(graph, eager)
    _assert_same_chain(graph, eager)
    assert int(graph.state.extras["nvt:nvt"]["step"]) == 192


def test_aeam_discarded_span_restores_the_chain(cuda):
    """restore() after replayed iterations puts x, v and the chain (and
    its step count) back to what start() loaded."""
    eng = _aeam_engine(cuda, None)
    eng.run(24)
    loop = eng._device_loop()
    before = {k: v.clone() for k, v in eng.state.extras["nvt:nvt"].items()}
    v0 = eng.state.v.clone()
    st = loop.start(eng.state, eng.nbr, True, eng._seg_dprev)
    loop.replay(3)
    done = loop.read().done                # a tripped segment is not kept
    assert done >= 12
    assert int(st.extras["nvt:nvt"]["step"]) == int(before["step"]) + done
    loop.restore()
    for k, v in before.items():
        assert torch.equal(st.extras["nvt:nvt"][k], v), k
    assert torch.equal(st.v, v0)


def test_aeam_in_loop_overflow_recovers(cuda):
    """A fine-cell capacity too small for the in-loop rebuild: the span is
    discarded (chain included), the plan re-sized, and the run ends at its
    step count with the chain's own count beside it, close to the eager
    loop's run (the re-sized plans differ, so the sums may round
    differently)."""
    graph, eager = (_aeam_engine(cuda, f) for f in (None, False))
    eager.run(48)
    graph.rebuild_neighbors()
    graph._plan = dataclasses.replace(graph._plan, cand_capacity=2)
    graph._pending_rebuild = True
    graph.run(48)
    assert graph._plan.cand_capacity > 2
    assert graph.state.step == 48
    assert int(graph.state.extras["nvt:nvt"]["step"]) == 48
    vg, ve = graph.state.v.double(), eager.state.v.double()
    assert float((vg - ve).abs().max()) <= 1e-4 * float(ve.abs().max())


def test_aeam_graph_span_replays_without_host_sync(cuda):
    """One span of 16 iterations under NVT, its first with a rebuild,
    replayed with the sync debug mode set to raise."""
    eng = _aeam_engine(cuda, None)
    eng.run(24)
    loop = eng._device_loop()
    torch.cuda.synchronize()
    before = select_candidates.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.state = loop.start(eng.state, eng.nbr, True, eng._seg_dprev)
        loop.replay(16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    res = loop.read()
    assert res.n_rb >= 1 and res.done >= 12
    assert select_candidates.launches == before + res.n_rb


# -- config 2: lj/cut/coul/cut, fix bfield, pair_style none -----------------

def _melt_engine(dev, fused, varying=False):
    """f32 Engine of the charged melt deck at n = 8 (1,024 ions, 200 T) on
    the card; varying: fix bfield with a time-varying Bz, a Bx and a
    region instead; fused None (graph) or False (eager)."""
    from lammps_plugins_tpu_torch.api.scenes import charged_melt
    from lammps_plugins_tpu_torch.core.region import Block
    from lammps_plugins_tpu_torch.fixes.bfield import FixBfield
    deck = charged_melt(8, dtype=torch.float32, device=dev)
    if varying:
        deck.fixes[0] = FixBfield(
            0.5, 0.0, lambda t: 200.0 + 50.0 * torch.cos(300.0 * t),
            region=Block(lo=(-1e30, 10.0, -1e30), hi=(20.0, 1e30, 1e30)))
    eng = deck.engine()
    eng.fused_loop = fused
    return eng


@pytest.mark.parametrize("varying", [False, True])
def test_charged_melt_graph_loop_matches_eager_loop(cuda, varying):
    """300 steps of the charged melt through in-run rebuilds: the graph
    loop's x, v, f, image, fix bfield's extras (v0, B, fsum and, for a
    time-varying field, its step count) and rebuild count equal the eager
    loop's bit for bit; D' is the only kernel that launches; the forces
    rerun bit-identically (no float atomics)."""
    from lammps_plugins_tpu_torch.run.device_loop import (extras_items,
                                                          kernel_modules)
    for m in kernel_modules():
        m.launches = 0
    graph, eager = (_melt_engine(cuda, f, varying) for f in (None, False))
    graph.run(300)
    assert {m.__name__.split(".")[-1]: m.launches for m in kernel_modules()
            if m.launches} == {"select_candidates": select_candidates.launches,
                               "ljcut": ljcut.launches}
    assert select_candidates.launches > 0 and ljcut.launches >= 300
    eager.run(300)
    assert graph._loop is not None and graph._loop.exec is not None
    assert graph.rebuilds >= 2
    _assert_same_state(graph, eager)
    ge, ee = (dict(extras_items(e.state.extras)) for e in (graph, eager))
    assert list(ge) == list(ee) and len(ge) == (4 if varying else 3)
    for p, t in ge.items():
        assert torch.equal(t, ee[p]), p
    st, nbr = graph.state, graph.nbr
    assert nbr.lists["main"].mirror is not None
    f1 = graph.pair.forces(st.x, st.type, nbr, st.box.h)
    f2 = graph.pair.forces(st.x, st.type, nbr, st.box.h)
    assert torch.equal(f1, f2) and torch.isfinite(f1).all()


def _sparse_call(partners):
    """The arguments and CPU (twin) result of the select_candidates call of
    a float32 CPU rebuild of 512 free ions 10 A apart (pair_style none,
    cutoff 1 A), with a partner ion 0.9 A off each of the first `partners`
    ions: every other row of the lists has no hit."""
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.bfield import FixBfield
    from lammps_plugins_tpu_torch.potentials.none import PairNone
    n, a = 8, 10.0
    g = (np.arange(n) + 0.5) * a
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    x = np.concatenate([x, x[:partners] + np.array([0.9, 0.0, 0.0])])
    box = Box.orthogonal([n * a] * 3, dtype=torch.float32, device="cpu")
    st = State.create(x=x, type=np.ones(len(x), np.int64), box=box,
                      mass=np.array([0.0, 1.0]), v=np.zeros_like(x),
                      q=np.ones(len(x)))
    eng = Engine(st, PairNone(1.0), [FixBfield(0.0, 0.0, 1000.0), FixNVE()],
                 units.METAL)
    eng.rebuild_neighbors()
    st = eng.state
    _, calls = rebuild_with_spy(eng._plan, st.x, st.image, st.type,
                                *eng._box_dev, eng.pair.neighbor_requests())
    return calls[0]


@pytest.mark.parametrize("partners", [0, 64])
def test_select_candidates_kernel_on_rows_without_hits(cuda, partners):
    """D' on free ions (the cyclotron oracle's lists): rows without a hit
    (all of them, or all but the 128 of the close pairs) give mask False,
    idx and jtype equal to its twin's on the card and on the CPU; kmax is
    0 or 1; reruns identical."""
    args, out_cpu = _sparse_call(partners)
    dargs = [a.to(cuda) if hasattr(a, "to") else a for a in args]
    before = select_candidates.launches
    out_k = select_candidates.select_candidates(*dargs)
    torch.cuda.synchronize()
    assert select_candidates.launches == before + 1
    out_t = select_candidates.select_candidates_ref(*dargs)
    again = select_candidates.select_candidates(*dargs)
    for a, b, c, d in zip(out_k, out_t, out_cpu, again):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c) \
            and torch.equal(a, d)
    hits = out_k[2].sum(dim=1)
    assert int((hits == 0).sum()) == 512 + partners - 2 * partners
    assert int(out_k[3]) == (1 if partners else 0)


def test_cyclotron_oracle_in_float32(cuda):
    """tests/test_fixes.py's oracle on the card in f32 with parameters f32
    resolves: 512 free ions (m = 1, q = 1) 10 A apart at v0 = 0.5 A/ps in
    seeded xy directions, Bz = 1000 T (radius 5.18 A, period 65.1 ps), dt =
    period / 2000, pair_style none (most rows of the lists have no hit).
    After one period every ion is back within the JAX test's bars."""
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.bfield import FixBfield
    from lammps_plugins_tpu_torch.potentials.none import PairNone
    u, n, a, bz, v0 = units.METAL, 8, 10.0, 1000.0, 0.5
    g = (np.arange(n) + 0.5) * a
    x0 = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    phi = np.random.default_rng(6).uniform(0.0, 2 * np.pi, len(x0))
    vel0 = v0 * np.stack([np.cos(phi), np.sin(phi), np.zeros_like(phi)], 1)
    box = Box.orthogonal([n * a] * 3, dtype=torch.float32, device=cuda)
    st = State.create(x=x0, type=np.ones(len(x0), np.int64), box=box,
                      mass=np.array([0.0, 1.0]), v=vel0, q=np.ones(len(x0)))
    period = 2 * np.pi / (u.qBm2f * bz)
    eng = Engine(st, PairNone(1.0), [FixBfield(0.0, 0.0, bz), FixNVE()], u,
                 dt=period / 2000)
    eng.run(2000)
    assert eng._loop is not None and eng._loop.exec is not None
    assert eng.rebuilds > 10
    assert int((~eng.nbr.lists["main"].mask.any(dim=1)).sum()) > 0
    s = eng.state
    x = s.box.unmap(s.x, s.image).double().cpu().numpy()
    v = s.v.double().cpu().numpy()
    assert np.linalg.norm(x - x0, axis=1).max() < 5e-3 * v0 * period
    assert np.abs(v - vel0).max() < 5e-3 * v0
    assert np.abs(np.linalg.norm(v, axis=1) - v0).max() < 1e-3 * v0


@pytest.mark.parametrize("deck", ["charged_melt", "lj_melt"])
def test_ljcut_f32_forces_on_card_match_f64(cuda, deck):
    """The f32 lj/cut(/coul/cut) forces on the card (its own device
    rebuild, the mirror combine) within 1e-2 RMS(F) of the f64 CPU path on
    the jiggled n = 4 deck (the f64 scene's types and charges)."""
    from lammps_plugins_tpu_torch.api import scenes
    make = getattr(scenes, deck)
    base = make(4, dtype=torch.float64, device="cpu").state
    pos = base.x.numpy() + np.random.default_rng(2).uniform(
        -0.05, 0.05, base.x.shape)
    out = []
    for dtype, dev in ((torch.float64, "cpu"), (torch.float32, cuda)):
        d = make(4, dtype=dtype, device=dev)
        d.state = d.state.replace(
            x=torch.as_tensor(pos, dtype=dtype, device=dev),
            type=base.type.to(dev), q=base.q.to(device=dev, dtype=dtype))
        eng = d.engine()
        eng.rebuild_neighbors()
        st = eng.state
        out.append(eng.pair.forces(st.x, st.type, eng.nbr,
                                   st.box.h).double().cpu().numpy())
    f64, f32 = out
    assert np.abs(f32 - f64).max() < 1e-2 * np.sqrt(np.mean(f64 * f64))


# -- kernel I: lj/cut(/coul/cut) forces from each atom's own row -----------

#: kernel I's scenes on the card: (kind of torch_parity.ljcut_scene, n)
LJCUT_SCENES = {"lj_melt": ("lj", 12), "charged_melt": ("charged", 8),
                "mixture21": ("mixture", 10), "wide_melt": ("wide", 8)}


def _ljcut_on_card(dev, name):
    """(pair, x, types, nbr, h) of LJCUT_SCENES[name] in float32 on the
    card, on its own device rebuild's lists."""
    kind, n = LJCUT_SCENES[name]
    eng = ljcut_scene(kind, n, dtype=torch.float32, device=dev)
    eng.rebuild_neighbors()
    st = eng.state
    return eng.pair, st.x, st.type, eng.nbr, st.box.h


@pytest.mark.parametrize("name", sorted(LJCUT_SCENES))
def test_ljcut_kernel_matches_twin_and_mirror_combine(cuda, name):
    """Kernel I (one launch a call) against its twin and against the
    [N, K] edge sweep plus mirror combine, in float32 on the same lists.
    Bar 1e-5 x rms|F| against the twin everywhere and against the mirror
    combine on rows without a ghost neighbour: both see the same floats
    for every slot and differ only in the order of the sums.  Rows with a
    ghost neighbour get 1e-4 x rms|F| against the mirror combine: there
    the mirror edge's d is computed from the other atom's rounded f32
    ghost image and is not exactly -d, so the two paths differ by the f32
    rounding of the image's coordinates (up to ~2.4e-5 x rms|F| on
    lj_melt(12) on the CPU, as far as either path lies from float64).  Two
    calls agree bit for bit."""
    pair, x, types, nbr, h = _ljcut_on_card(cuda, name)
    nlist = nbr.lists["main"]
    if name == "wide_melt":
        assert nlist.capacity >= 352
    before = ljcut.launches
    f = pair.forces(x, types, nbr, h)
    torch.cuda.synchronize()
    assert ljcut.launches == before + 1
    args, kw = pair.kernel_inputs(x, types, nbr, h)
    assert ("q" in kw) == (name in ("charged_melt", "wide_melt"))
    f_twin = ljcut.ljcut_forces_ref(*args, **kw)
    f_mirror = pair.mirror_forces(x, types, nbr, h)
    rms = float(f_mirror.double().pow(2).sum(1).mean().sqrt())
    assert rms > 1e-2
    gap = lambda a: (f - a).double().abs().max(dim=1).values  # noqa: E731
    ghost = ((nlist.idx >= x.shape[0]) & nlist.mask).any(dim=1)
    assert float(gap(f_twin).max()) <= 1e-5 * rms
    assert float(gap(f_mirror)[~ghost].max()) <= 1e-5 * rms
    assert float(gap(f_mirror).max()) <= 1e-4 * rms
    assert torch.equal(f, pair.forces(x, types, nbr, h))


@pytest.mark.parametrize("name", ["lj_melt", "charged_melt"])
def test_ljcut_kernel_is_blind_to_the_list_capacity(cuda, name):
    """The same rows in a list of 8, 40 or 200 more masked slots give the
    same forces bit for bit: a re-sized list (another K) does not move
    the sums, so the graph and eager loops agree though they may re-size
    at different steps."""
    import torch.nn.functional as F
    pair, x, types, nbr, h = _ljcut_on_card(cuda, name)
    args, kw = pair.kernel_inputs(x, types, nbr, h)
    f = ljcut.ljcut_forces(*args, **kw)
    for extra in (8, 40, 200):
        wide = list(args)
        wide[5], wide[6] = (F.pad(a, (0, extra)) for a in args[5:7])
        assert torch.equal(f, ljcut.ljcut_forces(*wide, **kw)), extra


def test_ljcut_kernel_refuses_what_it_cannot_take(cuda):
    """On the card the wrapper raises for float64, for an idx of another
    dtype and for a table past shared memory; it never takes the twin."""
    pair, x, types, nbr, h = _ljcut_on_card(cuda, "lj_melt")
    args, kw = pair.kernel_inputs(x, types, nbr, h)
    before = ljcut.launches
    with pytest.raises(TypeError, match="float32"):
        ljcut.ljcut_forces(*[a.double() if a.is_floating_point() else a
                             for a in args])
    with pytest.raises(TypeError, match="idx"):
        ljcut.ljcut_forces(*args[:5], args[5].int(), *args[6:])
    big = torch.zeros(200 * 200, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ljcut.ljcut_forces(*args[:7], big, big, big)
    assert ljcut.launches == before


def test_ljcut_graph_loop_matches_eager_loop(cuda):
    """lj_melt(12) (6,912 atoms, jiggled) for 200 steps through in-run
    rebuilds: the graph loop equals the eager loop bit for bit (x, v, f,
    image, rebuild count), kernel I and D' the only kernels; then one span
    of 16 iterations replayed: kernel I's counter grows by one a step (a
    force call a step), D''s by one a rebuild."""
    from lammps_plugins_tpu_torch.run.device_loop import kernel_modules
    graph, eager = (ljcut_scene("lj", 12, dtype=torch.float32, device=cuda)
                    for _ in range(2))
    eager.fused_loop = False
    for m in kernel_modules():
        m.launches = 0
    graph.run(200)
    assert {m.__name__.split(".")[-1] for m in kernel_modules()
            if m.launches} == {"select_candidates", "ljcut"}
    eager.run(200)
    assert graph._loop is not None and graph._loop.exec is not None
    assert graph.rebuilds >= 2
    _assert_same_state(graph, eager)
    loop = graph._device_loop()
    torch.cuda.synchronize()
    before = (ljcut.launches, select_candidates.launches)
    graph.state = loop.start(graph.state, graph.nbr, True,
                             graph._seg_dprev)
    loop.replay(16)
    res = loop.read()
    assert res.done >= 1
    assert ljcut.launches == before[0] + 16 * graph.check_every
    assert select_candidates.launches == before[1] + res.n_rb


# -- per-atom tallies, dumps and the input-script path on the card ---------

def _to_cpu64(obj):
    """A copy of a (nested) neighbor structure with every tensor on the
    CPU, floating ones in float64."""
    if torch.is_tensor(obj):
        t = obj.cpu()
        return t.double() if t.is_floating_point() else t
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to_cpu64(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _to_cpu64(v) for k, v in obj.items()}
    return obj


def test_peratom_on_card_matches_cpu_twin(cuda):
    """energy_peratom and virial_peratom of REBOMoS on the card (kernels
    A, B and C, the torch LJ virial sweep; no float atomics) on the
    jiggled, sorted 2,304-atom scene against the float64 CPU twin on the
    same lists: energy within 1e-4 and virial within 5e-4 of their scale,
    Σ eatom within 1e-5 of the f64 energy, reruns bit-identical."""
    from lammps_plugins_tpu_torch.ops import lj_cells as lj
    st = rebomos_bulk_commensurate(12, 16, 2, dtype=torch.float32,
                                   device=cuda, sort=True)
    rng = np.random.default_rng(6)
    x = st.x.cpu().numpy() + rng.uniform(-0.08, 0.08, st.x.shape)
    st = st.replace(x=torch.as_tensor(x, dtype=torch.float32, device=cuda))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device=cuda)
    eng = Engine(st, pair, [FixNVE()], units.METAL)
    eng.rebuild_neighbors()
    s, nbr = eng.state, eng.nbr
    before = (rebo.launches, mirror.launches, lj.launches)
    e = pair.energy_peratom(s.x, s.type, nbr, s.box.h)
    v = pair.virial_peratom(s.x, s.type, nbr, s.box.h)
    torch.cuda.synchronize()
    assert rebo.launches > before[0] and mirror.launches >= before[1] + 3 \
        and lj.launches > before[2]
    assert torch.equal(e, pair.energy_peratom(s.x, s.type, nbr, s.box.h))
    assert torch.equal(v, pair.virial_peratom(s.x, s.type, nbr, s.box.h))
    pair64 = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float64,
                               device="cpu")
    s64 = dataclasses.replace(
        s, x=s.x.cpu().double(), type=s.type.cpu(),
        box=s.box.to("cpu", torch.float64))
    nbr64 = _to_cpu64(nbr)
    e64 = pair64.energy_peratom(s64.x, s64.type, nbr64, s64.box.h).numpy()
    v64 = pair64.virial_peratom(s64.x, s64.type, nbr64, s64.box.h).numpy()
    pe64 = float(pair64.energy(s64.x, None, s64.type, nbr64, s64.box.h))
    e32, v32 = e.double().cpu().numpy(), v.double().cpu().numpy()
    assert np.abs(e32 - e64).max() <= 1e-4 * np.abs(e64).max()
    assert np.abs(v32 - v64).max() <= 5e-4 * np.abs(v64).max()
    assert abs(e32.sum() - pe64) <= 1e-5 * abs(pe64)


def _thermo_engine(dev):
    """The jiggled, sorted 2,304-atom scene on the card after a device
    rebuild (float32)."""
    st = rebomos_bulk_commensurate(12, 16, 2, dtype=torch.float32,
                                   device=dev, sort=True)
    rng = np.random.default_rng(6)
    x = st.x.cpu().numpy() + rng.uniform(-0.08, 0.08, st.x.shape)
    st = st.replace(x=torch.as_tensor(x, dtype=torch.float32, device=dev))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device=dev)
    eng = Engine(st, pair, [FixNVE()], units.METAL)
    eng.rebuild_neighbors()
    return eng


def _refuse_plain_paths(monkeypatch):
    """Every twin and autograd entry that a kernel path must not reach
    raises; returns a list that records torch.is_grad_enabled() at each
    launch of A and C."""
    from lammps_plugins_tpu_torch.potentials import rebomos as rb

    def refuse(*_, **__):
        raise AssertionError("a plain path ran on the card")

    for mod, name in ((rebo, "rebo_cotangents_ref"),
                      (lj_cells, "lj_cell_forces_ref"),
                      (lj_cells, "pair_terms"), (torch.autograd, "grad")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(REBOMoS, "_lj_energy_cells", refuse)
    grad_on = []
    for name in ("rebo_cotangents", "lj_cell_forces"):
        real = getattr(rb, name)

        def spy(*a, _real=real, **k):
            grad_on.append(torch.is_grad_enabled())
            return _real(*a, **k)
        monkeypatch.setattr(rb, name, spy)
    return grad_on


@pytest.mark.parametrize("lj", ["full", "half"])
def test_thermo_row_on_card_launches_a_and_c(cuda, monkeypatch, lj):
    """REBOMoS.energy_virial on a CUDA state: one launch each of A and C
    (no E, no B), under no_grad, no twin and no autograd; (E, W) against
    the float64 CPU autograd on the same lists: pe 2e-5 relative, W 5e-4
    x max|W|.  energy_force_virial adds only the combine (B) and, with
    lj="half", kernel E; stress/atom's LJ tier is C's virial rows."""
    from lammps_plugins_tpu_torch.potentials.base import PairStyle
    eng = _thermo_engine(cuda)
    s, nbr = eng.state, eng.nbr
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device=cuda, lj=lj)
    pair64 = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float64,
                               device="cpu")
    s64 = dataclasses.replace(s, x=s.x.cpu().double(), type=s.type.cpu(),
                              box=s.box.to("cpu", torch.float64))
    e64, w64 = PairStyle.energy_virial(pair64, s64.x, s64.type,
                                       _to_cpu64(nbr), s64.box.h)
    grad_on = _refuse_plain_paths(monkeypatch)
    mods = (rebo, lj_cells, mirror, lj_half)
    before = [m.launches for m in mods]
    e, w = pair.energy_virial(s.x, s.type, nbr, s.box.h)
    torch.cuda.synchronize()
    assert [m.launches - b for m, b in zip(mods, before)] == [1, 1, 0, 0]
    assert grad_on == [False, False] and not e.requires_grad
    w64 = w64.numpy()
    assert abs(float(e) - float(e64)) <= 2e-5 * abs(float(e64))
    assert np.abs(w.double().cpu().numpy() - w64).max() \
        <= 5e-4 * np.abs(w64).max()
    e2, w2 = pair.energy_virial(s.x, s.type, nbr, s.box.h)
    assert torch.equal(e, e2) and torch.equal(w, w2)
    before = [m.launches for m in mods]
    ef, f, wf = pair.energy_force_virial(s.x, s.type, nbr, s.box.h)
    torch.cuda.synchronize()
    assert [m.launches - b for m, b in zip(mods, before)] == \
        [1, 1, 1, int(lj == "half")]
    assert torch.equal(ef, e) and torch.equal(wf, w)
    assert torch.equal(f, pair.forces(s.x, s.type, nbr, s.box.h))
    before = lj_cells.launches
    v = pair.virial_peratom(s.x, s.type, nbr, s.box.h)
    torch.cuda.synchronize()
    assert lj_cells.launches == before + 1
    assert np.abs(v.double().sum(0).cpu().numpy()
                  - w64[[0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]]).max() \
        <= 5e-4 * np.abs(w64).max()


def test_thermo_row_on_host_built_lists_is_refused(cuda):
    """energy_virial, energy_force_virial and energy_value raise on a
    CUDA state with host-built lists (no cells, no mirror tables)."""
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device=cuda)
    st = rebomos_bulk(dtype=torch.float32, device=cuda)
    xw, _ = st.box.wrap_np(st.x.double().cpu().numpy())
    host = build_neighbor_data(xw, st.type.cpu().numpy(), st.box,
                               pair.neighbor_requests(), skin=1.0,
                               dtype=torch.float32, device=cuda)
    for call in (pair.energy_virial, pair.energy_force_virial,
                 pair.energy_value):
        with pytest.raises(RuntimeError):
            call(st.x, st.type, host, st.box.h)


def test_sharded_thermo_on_card_launches_a_and_c(cuda, monkeypatch):
    """ShardedEngine.thermo and potential_energy: A and C once a shard, no
    twin, no autograd; the row against the single Engine's (pe 2e-5
    relative, pressure 5e-4 of the pressure tensor's scale)."""
    se = _sharded(cuda, None, jiggle=0.05)
    single = Engine(se.to_state(), REBOMoS.from_file(
        SYNTH_REBO, ["M", "S"], dtype=torch.float32, device=cuda),
        [FixNVE()], units.METAL, skin=se.skin)
    single.rebuild_neighbors()
    ref = single._thermo(single.state)
    grad_on = _refuse_plain_paths(monkeypatch)
    before = (rebo.launches, lj_cells.launches)
    row = se.thermo()
    pe = se.potential_energy()
    torch.cuda.synchronize()
    n = se.n_devices
    assert (rebo.launches - before[0], lj_cells.launches - before[1]) == \
        (2 * n, 2 * n)
    assert not any(grad_on)
    assert abs(row["pe"] - ref["pe"]) <= 2e-5 * abs(ref["pe"])
    assert abs(pe - row["pe"]) <= 1e-6 * abs(row["pe"])
    scale = max(abs(ref[k]) for k in ("pxx", "pyy", "pzz", "pxy", "pxz",
                                      "pyz"))
    for k in ("press", "pxx", "pyy", "pzz", "pxy", "pxz", "pyz"):
        assert abs(row[k] - ref[k]) <= 5e-4 * scale, k


def _card_script(text, fused=None):
    """The port's Script on the card (float32) after `text`, its Engine
    made (`run 0`) and set to the graph loop (fused None) or the eager
    loop (False)."""
    from lammps_plugins_tpu_torch.api.script import Script
    s = Script(log=lambda _: None)
    s.run_text(text + "\nrun 0\n")
    s.engine.fused_loop = fused
    return s


def test_dump_reruns_are_byte_identical_on_card(cuda, tmp_path):
    """A deck with compute pe/atom and stress/atom dumped every 10 steps
    through the graph loop writes the same bytes twice."""
    from test_torch_script import REBO_DECK
    deck = REBO_DECK.replace("run             20", "").replace(
        "thermo          10", "velocity all create 300.0 4928459\n"
        "compute pe all pe/atom\ncompute s all stress/atom NULL\n"
        "dump 1 all custom 10 {d} id type x y z c_pe c_s[1] c_s[2] c_s[3] "
        "c_s[4] c_s[5] c_s[6]\nthermo 10")
    paths = []
    for k in range(2):
        path = str(tmp_path / f"{k}.dump")
        s = _card_script(deck.format(d=path))
        s.command("run 40")
        assert s.engine._loop is not None and s.engine._loop.exec is not None
        paths.append(path)
    text = open(paths[0], "rb").read()
    assert text == open(paths[1], "rb").read()
    assert text.count(b"ITEM: TIMESTEP") == 6       # 0 (run 0), 0..40


def test_langevin_graph_equals_eager_on_card(cuda):
    """fix langevin + fix nve, 100 steps of the n = 6 LJ melt through the
    graph loop and the eager loop: the same bits (x, v, f, image, the
    fix's step count); the noise drawn on the card at three steps equals
    the CPU draw bit for bit."""
    from test_torch_script import LJ_SETUP
    deck = LJ_SETUP.replace("0 4 0 4 0 4", "0 6 0 6 0 6") + \
        "velocity all create 1.44 87287\nfix 1 all langevin 1.44 1.8 0.1 " \
        "48279\nfix 2 all nve\n"
    runs = [_card_script(deck, fused) for fused in (None, False)]
    for s in runs:
        s.command("run 100")
    g, e = (s.engine for s in runs)
    assert g._loop is not None and g._loop.exec is not None
    assert e._loop is None
    _assert_same_state(g, e)
    key = "langevin:1"
    assert torch.equal(g.state.extras[key]["step"],
                       e.state.extras[key]["step"])
    fix = runs[0].fixes[0]
    for step in (0, 57, 100):
        st = dataclasses.replace(g.state, extras={key: {"step": torch.tensor(
            step, device=cuda)}})
        on_card = fix.noise(st).cpu()
        cpu = dataclasses.replace(st, x=st.x.cpu(), v=st.v.cpu(),
                                  extras={key: {"step": torch.tensor(step)}})
        assert torch.equal(on_card, fix.noise(cpu))


def test_ramped_nvt_two_runs_graph_equals_eager_on_card(cuda):
    """Two runs of a ramped fix nvt (the window re-anchored by each run):
    the graph loop captures anew for the second window and stays equal to
    the eager loop bit for bit (the stale-window fault replayed the first
    run's targets)."""
    from test_torch_script import SAMPLE_DECK
    deck = SAMPLE_DECK.replace("863.0 863.0 0.1", "863.0 1000.0 0.1") \
        .replace("run             24", "neigh_modify every 6") \
        .replace("thermo          6", "thermo 12")
    runs = [_card_script(deck, fused) for fused in (None, False)]
    keys = []
    for s in runs:
        s.command("run 24")
        keys.append(s.engine._loop_key)
        s.command("run 24")
        assert (s.fixes[0].begin_step, s.fixes[0].end_step) == (24, 48)
    g, e = (s.engine for s in runs)
    assert keys[0] is not None and keys[0] != g._loop_key
    _assert_same_state(g, e)
    for k in ("eta", "eta_dot", "step"):
        assert torch.equal(g.state.extras["nvt:1"][k],
                           e.state.extras["nvt:1"][k]), k


# -- the sharded engine (parallel/sharded_engine.py), shards on one card --

def _sharded(dev, fused, jiggle=0.0, grid=(4, 1), temp=600.0,
             placement=None, devices=None):
    """rebomos_bulk(12, 8, 1) (864 atoms, four 14.4 A x-slabs beside an
    11.0 A halo margin at skin 0.5; (12, 12, 1) for a 2x2 grid), f32 on
    `dev`, its shards stacked there (or on `devices` in `placement`)."""
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.parallel import ShardedEngine
    st = rebomos_bulk(12, 8 if grid[1] == 1 else 12, 1, tilt_xy=0.0,
                      dtype=torch.float32, device="cpu")
    if jiggle:
        rng = np.random.default_rng(4)
        st = st.replace(x=st.x + torch.as_tensor(
            rng.uniform(-jiggle, jiggle, tuple(st.x.shape)),
            dtype=torch.float32))
    st = velocity_create(st, units.METAL, temp, 3)
    st = dataclasses.replace(
        st, x=st.x.to(dev), v=st.v.to(dev), f=st.f.to(dev),
        type=st.type.to(dev), q=st.q.to(dev), image=st.image.to(dev),
        mass=st.mass.to(dev), box=st.box.to(dev))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=torch.float32,
                             device=dev)
    se = ShardedEngine(st, pair, [FixNVE()], units.METAL,
                       devices=devices or [dev] * (grid[0] * grid[1]),
                       grid=grid, skin=0.5, placement=placement)
    se.fused_loop = fused
    return se


@pytest.mark.parametrize("grid", [(4, 1), (2, 2)], ids=["slabs", "2x2"])
def test_sharded_graph_loop_matches_eager_loop(cuda, grid):
    """60 steps through resettles: the sharded iteration as one captured
    graph (every shard's resettle under the conditional node) equals the
    eager host loop bit for bit, rows, layout and halo tables included."""
    graph, eager = (_sharded(cuda, f, grid=grid) for f in (None, False))
    graph.run(60)
    eager.run(60)
    assert graph._loop is not None and graph._loop.exec is not None
    assert eager._loop is None
    assert graph.resettles >= 3 and graph.resettles == eager.resettles
    for f in ("x", "v", "f", "image", "type", "q", "tag", "valid"):
        assert torch.equal(getattr(graph.shards, f),
                           getattr(eager.shards, f)), f
    for f in ("t_loc", "valid_loc", "exp_r", "exp_l", "exp_u", "exp_d"):
        assert torch.equal(getattr(graph.halo, f), getattr(eager.halo, f)), f


@pytest.mark.parametrize("grid", [(4, 1), (2, 2)], ids=["slabs", "2x2"])
def test_per_device_graph_matches_eager_and_stacked(cuda, grid):
    """The per-device placement on the card (a stream a shard): 60 steps
    through resettles, its segments and its resettles as captured pieces,
    equal bit for bit to its eager run and to the stacked layout's; A, B,
    C and D' launched by every shard."""
    stacked = _sharded(cuda, None, grid=grid)
    graph, eager = (_sharded(cuda, f, grid=grid, placement="per_device")
                    for f in (None, False))
    graph.reset_shard_launches()
    for e in (stacked, graph, eager):
        e.run(60)
    assert graph._prog is not None and eager._prog is None
    assert graph._rs_prog is not None and eager._rs_prog is None
    assert graph.captures >= 2 and eager.captures == 0
    assert graph.resettles >= 3
    assert graph.resettles == eager.resettles == stacked.resettles
    for other in (eager, stacked):
        for f in ("x", "v", "f", "image", "type", "q", "tag", "valid"):
            assert torch.equal(getattr(graph.shards, f),
                               getattr(other.shards, f)), f
        for f in ("t_loc", "valid_loc", "exp_r", "exp_l", "exp_u", "exp_d"):
            assert torch.equal(getattr(graph.halo, f),
                               getattr(other.halo, f)), f
    for c in graph.shard_launches():
        assert all(c[m] > 0 for m in ("rebo", "mirror", "lj_cells",
                                      "select_candidates")), c
    graph.close()


def test_per_device_card_and_cpu_shards(cuda):
    """Two x-slabs, one on the card and one on the CPU (its kernels'
    twins): every cross-shard move a copy between the devices; step-0 pe
    and forces against the stacked layout on the card (2e-5, 3e-4 x
    scale), then 20 eager steps, finite."""
    ref = _sharded(cuda, None, grid=(2, 1), jiggle=0.05)
    mixed = _sharded(cuda, None, grid=(2, 1), jiggle=0.05,
                     devices=[cuda, torch.device("cpu")])
    pe_r, pe_m = ref.potential_energy(), mixed.potential_energy()
    assert abs(pe_m - pe_r) <= 2e-5 * abs(pe_r)
    ref._setup_forces()
    mixed._setup_forces()
    f_r, f_m = ref.to_state().f, mixed.to_state().f.to(cuda)
    assert float((f_m - f_r).abs().max()) <= 3e-4 * float(f_r.abs().max())
    mixed.run(20)
    assert bool(torch.isfinite(mixed.to_state().x).all())


def test_sharded_kernels_match_twins_on_a_shard_block(cuda):
    """A, B, C and D' on shard 0's own block (pad rows parked outside the
    slab box, halo rows, the slab box non-periodic in x) against their
    twins at the JAX suite's bars, D' exact."""
    se = _sharded(cuda, None, jiggle=0.1)
    se._setup_forces()
    pair = se._pair_local(se.halo, 0)
    x = se._halo_blocks(se.shards.x, se.halo)[0]
    t = se.halo.t_loc[0]
    nbr = se.nbrs[0]
    h = se._h_slab
    rl = nbr.lists["rebo"]
    planes = pair._rebo_planes(x, pair.el_of_type[t], nbr.ghosts, rl, h)
    _rebo_kernel_vs_twin(planes, pair._rebo_consts)
    gk = rebo.rebo_cotangents(*planes, pair._rebo_consts)
    mv = rl.mirvT.float()
    fk = mirror.mirror_combine(*gk, rl.mirT, mv)
    ft = mirror.mirror_combine_ref(*gk, rl.mirT, mv)
    assert float((fk - ft).abs().max()) <= 1e-5 * float(ft.abs().max())
    P = pair._cell_planes(x, nbr.ghosts, nbr.cells, h)
    ar = nbr.cells.a_range
    ok = lj_cells.lj_cell_forces(P, pair._lj_consts, ar, with_energy=True)
    ot = lj_cells.lj_cell_forces_ref(P, pair._lj_consts, ar,
                                     with_energy=True)
    scale = float(ot[..., :3, :].abs().max())
    assert float((ok[..., :3, :] - ot[..., :3, :]).abs().max()) \
        <= 2e-4 * scale
    e_k, e_t = float(ok[..., 3, :].double().sum()), \
        float(ot[..., 3, :].double().sum())
    assert abs(e_k - e_t) <= 2e-5 * abs(e_t)
    _, calls = rebuild_with_spy(
        se._plan, x, torch.zeros_like(x, dtype=torch.int32), t, h,
        se._hinv_slab, se._lo_shards[0], pair.neighbor_requests(),
        valid=se.halo.valid_loc[0])
    args = calls[0][0]
    assert int((args[2] < 0).any(dim=1).sum()) > 0     # pad rows skipped
    ck = select_candidates.select_candidates(*args)
    ct = select_candidates.select_candidates_ref(*args)
    for a, b in zip(ck, ct):
        assert torch.equal(a, b)
