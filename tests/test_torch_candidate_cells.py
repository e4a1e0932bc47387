"""What kernel D' (ops/select_candidates.py) reads in place of the sort and
the cell table of the one-block-a-cell design, checked on the CPU.

The kernel takes the owned atoms of each fine cell, and the cell's
candidates, from the binning's own sort (CellRuns, made by
neighbor/device_build.py::_bin_dense): each cell's run of rows below n
are its owned atoms, the rows past the last run are in no cell, and the
first Cf rows of a run (past Cf the run's last row in the last slot) are
the cell table's row.  Here that reading equals the sort-based runs the
earlier design made (kept below as `_sorted_runs`) and the table the twin
reads, on the bench scene, on a table capped to 4 slots a cell (which
drops atoms) and with pad rows (valid=); the launch plan fits shared
memory across K, type counts and cell capacities; and the kernel's cell
test (cell_tested) never skips a cell that holds a hit of the twin's
window.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_plugins_tpu_torch.api.scenes import (lj_melt,
                                                 rebomos_bulk_commensurate)
from lammps_plugins_tpu_torch.core import units
from lammps_plugins_tpu_torch.fixes.nve import FixNVE
from lammps_plugins_tpu_torch.neighbor import device_build as pdb
from lammps_plugins_tpu_torch.ops import select_candidates as sc
from lammps_plugins_tpu_torch.ops.select_k import SMEM_LIMIT
from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
from lammps_plugins_tpu_torch.run.simulation import Engine
from torch_parity import SYNTH_REBO, rebuild_with_spy

F32 = dict(dtype=torch.float32, device="cpu")


def _sorted_runs(c3f, fdims):
    """The earlier design's runs: the owned rows sorted by fine cell once
    more (rows with a negative cell past the last run) and each cell's
    first position."""
    d0, d1, d2 = fdims
    cid = (c3f[:, 0] * d1 + c3f[:, 1]) * d2 + c3f[:, 2]
    cid = torch.where(torch.all(c3f >= 0, -1), cid,
                      torch.full_like(cid, d0 * d1 * d2))
    scid, order = torch.sort(cid)
    starts = torch.searchsorted(scid, torch.arange(d0 * d1 * d2 + 1))
    return order, starts


def _cell_of_position(starts, m):
    """[m] the cell of each position of a sort whose runs start at
    `starts` (ncf for the positions past the last run)."""
    return torch.searchsorted(starts, torch.arange(m), right=True) - 1


def _stub_calls(monkeypatch):
    """Replace device_build.select_candidates by a recorder that returns
    empty lists (the selection itself is not under test here)."""
    calls = []

    def stub(xt_pad, dense_f, c3f, fdims, cut, k, runs=None):
        calls.append((xt_pad, dense_f, c3f, fdims, cut, k, runs))
        n = c3f.shape[0]
        z = torch.zeros((n, k), dtype=torch.int64)
        return (z, z.clone(), torch.zeros((n, k), dtype=torch.bool),
                torch.zeros((), dtype=torch.int64))

    monkeypatch.setattr(pdb, "select_candidates", stub)
    return calls


@pytest.fixture(scope="module")
def bench():
    """The 97,920-atom bench scene (f32, skin 0.8) and its Engine, whose
    plan the cases below rebuild with."""
    st = rebomos_bulk_commensurate(34, 48, 10, **F32)
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], **F32)
    return Engine(st, pair, [FixNVE()], units.METAL, skin=0.8)


@pytest.mark.parametrize("case", ["bench", "capped", "pads"])
def test_cell_runs_equal_the_sorted_runs(bench, monkeypatch, case):
    """The owned atoms by cell as the kernel takes them from the binning's
    runs equal the runs of the earlier sort, cell for cell (and the rows
    in no cell, past the last run); the first Cf rows of each run (the
    run's last row in the last slot past Cf) are the cell table's row."""
    calls = _stub_calls(monkeypatch)
    eng = bench
    eng.rebuild_neighbors()
    plan, st = eng._plan, eng.state
    valid = None
    if case == "capped":
        plan = dataclasses.replace(plan, cand_capacity=4)
    if case == "pads":
        valid = torch.arange(st.natoms) % 11 != 3
    calls.clear()
    (_, _, _, flags), _ = rebuild_with_spy(
        plan, st.x, st.image, st.type, *eng._box_dev,
        eng.pair.neighbor_requests(), valid=valid)
    assert bool(flags["candcell_overflow"]) == (case == "capped")
    xt_pad, dense_f, c3f, fdims, _, _, runs = calls[-1]
    n, m_all, Cf = c3f.shape[0], xt_pad.shape[0] - 1, dense_f.shape[1]
    ncf = int(np.prod(fdims))
    assert runs.order.dtype == runs.starts.dtype == torch.int32
    order, starts = runs.order.long(), runs.starts.long()
    assert torch.equal(torch.sort(order).values, torch.arange(m_all))
    # the kernel's owned atoms: (cell, row) of each position below n
    cell = _cell_of_position(starts, m_all)
    own = order < n
    mine = torch.stack([cell[own], order[own]], 1)
    old_order, old_starts = _sorted_runs(c3f, fdims)
    old_cell = _cell_of_position(old_starts, n)
    theirs = torch.stack([old_cell, old_order], 1)
    key = lambda t: t[torch.argsort(t[:, 0] * (m_all + 1) + t[:, 1])]  # noqa
    assert torch.equal(key(mine), key(theirs))
    if case == "pads":
        tail = order[int(starts[ncf]):]
        assert torch.equal(torch.sort(tail[tail < n]).values,
                           torch.nonzero(~valid).reshape(-1))
    else:
        assert int((order[int(starts[ncf]):] < n).sum()) == 0
    # what the kernel stages of each cell is the table's row
    ends = torch.cat([starts[1:], torch.tensor([m_all])])[:ncf]
    run = ends - starts[:ncf]
    s = torch.arange(Cf)[None, :]
    src = torch.where(s == Cf - 1, ends[:, None] - 1, starts[:ncf, None] + s)
    staged = torch.where(s < run[:, None],
                         order[src.clamp(0, m_all - 1)],
                         torch.full_like(src, m_all))
    assert torch.equal(staged, dense_f[:ncf])
    if case == "capped":
        assert int(run.max()) > Cf


def test_candidates_plan_fits_shared_memory():
    """Across K 1-16,384, 1-238 types (past 64 at small K, as before) and
    8- to 9,000-slot cells the plan
    fits a block's 232,448 bytes, its byte count is the layout's, and at K
    <= 512 (with up to 64 types) at least 16 warps stay resident on an SM;
    past one warp reading its cells in place (K > 16,384, or more than 240
    types) it raises a ValueError naming the limit."""
    for k in (1, 16, 40, 120, 144, 384, 440, 512, 1904, 4096, 16384):
        for nt in (2, 3, 22, 65, 239) if k <= 64 else (2, 3, 22, 65):
            for Cf in (8, 16, 48, 120, 504, 2000, 9000):
                p = sc.candidates_plan(k, Cf, nt)
                assert p.nbytes <= SMEM_LIMIT
                assert p.nbytes == sc.candidates_bytes(
                    p.warps, p.cap, p.bucket, p.bx, p.staged, Cf, nt)
                assert p.cap >= k and p.blocks_per_sm >= 1
                if not p.staged:
                    assert p.bx == 1
                if k <= 512 and nt <= 65:
                    assert p.resident_warps >= 16, (k, nt, Cf, p)
    # small cells, small K: bricks of 4 cells staged, 4-warp blocks
    p = sc.candidates_plan(16, 16, 3)
    assert (p.bx, p.staged, p.bucket, p.warps) == (4, True, True, 4)
    # the bucket sort's second buffer gives way to the bitonic one
    assert not sc.candidates_plan(16384, 16, 3).bucket
    sc.candidates_plan(16, 8, 240)
    for k, nt in ((16385, 3), (16, 241), (16384, 200)):
        with pytest.raises(ValueError, match=str(SMEM_LIMIT)):
            sc.candidates_plan(k, 8, nt)


def _window_hits(args):
    """[n, 27, Cf] bool: the twin's window (id below m_all, not the atom,
    rsq < cut^2 in float32 as the twin rounds it) over each row's 27
    cells and their table slots."""
    xt_pad, dense_f, c3f, fdims, cut = args[:5]
    n, m_all = c3f.shape[0], xt_pad.shape[0] - 1
    cand = dense_f[sc.neighbour_cells(c3f, fdims)]          # [n, 27, Cf]
    xc = xt_pad[cand.clamp(max=m_all)]
    rsq = torch.zeros(cand.shape, dtype=xt_pad.dtype)
    for a in range(3):
        d = xc[..., a] - xt_pad[:n, a][:, None, None]
        rsq = rsq + d * d
    valid = (cand < m_all) & (cand != torch.arange(n)[:, None, None])
    cutv = cut[xt_pad[:n, 3].long()[:, None, None], xc[..., 3].long()]
    return valid & (rsq < cutv * cutv)


def _mixture_engine(ntypes, seed):
    """A jiggled fcc mixture of 500 atoms (LJ units, ntypes types at
    random, a random cut in [1.2, 3.0] per type pair, skin 0.3), or on its
    perfect lattice (seed None: ties of rsq)."""
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCut
    rng = np.random.default_rng(seed or 0)
    n = 5
    a = (4.0 / 0.8442) ** (1.0 / 3.0)
    base = a * np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                         [0, 0.5, 0.5]])
    cells = a * np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                         -1).reshape(-1, 3)
    x = (cells[:, None, :] + base[None]).reshape(-1, 3)
    if seed is not None:
        x = x + rng.uniform(-0.3, 0.3, x.shape)
    types = rng.integers(1, ntypes + 1, len(x))
    pair = PairLJCut(3.0, ntypes=ntypes, **F32)
    for i in range(1, ntypes + 1):
        for j in range(i, ntypes + 1):
            pair.set_coeff(i, j, 1.0, 1.0, rng.uniform(1.2, 3.0))
    pair.prepare(types)
    st = State.create(x=x, type=types, box=Box.orthogonal([n * a] * 3, **F32),
                      mass=np.ones(ntypes + 1))
    return Engine(st, pair, [FixNVE()], units.LJ, skin=0.3)


def _rebo_engine():
    st = rebomos_bulk_commensurate(6, 8, 2, **F32)
    rng = np.random.default_rng(3)
    st = st.replace(x=st.x + torch.as_tensor(
        rng.uniform(-0.2, 0.2, tuple(st.x.shape)), dtype=torch.float32))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], **F32)
    return Engine(st, pair, [FixNVE()], units.METAL, skin=0.8)


@pytest.mark.parametrize("scene", ["mixture", "lattice", "lj_melt",
                                   "rebomos"])
def test_cell_test_never_drops_a_hit(scene):
    """The kernel's cell test (cell_tested, the same float32 arithmetic)
    keeps every neighbour cell that holds a hit of the twin's window, on
    random points with a random cut per type pair, on a perfect lattice
    (ties, atoms on cell faces), on bench/in.lj's lattice and on a jiggled
    REBOMOS bulk; and it does skip cells."""
    eng = {"mixture": lambda: _mixture_engine(3, 5),
           "lattice": lambda: _mixture_engine(2, None),
           "lj_melt": lambda: lj_melt(5, **F32).engine(),
           "rebomos": _rebo_engine}[scene]()
    eng.rebuild_neighbors()
    st = eng.state
    _, calls = rebuild_with_spy(eng._plan, st.x, st.image, st.type,
                                *eng._box_dev, eng.pair.neighbor_requests())
    for args, _ in calls:
        xt_pad, _, c3f, fdims, cut, _, runs = args
        hits = _window_hits(args)
        tested = sc.cell_tested(xt_pad, c3f, runs, fdims, cut)
        assert hits.any()
        assert not (hits & ~tested[..., None]).any()
        assert (~tested).any()
