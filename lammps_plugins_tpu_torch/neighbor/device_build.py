"""On-device neighbor rebuild with fixed shapes (port of
lammps_plugins_tpu/neighbor/device_build.py, default path).

Wrap, two-stage ghost compaction, the fine-grid cell table and per-tier
K-nearest selection of each owned atom's candidates in its 27 fine cells
(ops/select_candidates.py: CUDA kernel D', keys made and selected in one
pass), the mirror-edge tables with their [K, Np] transposes, the reaction
combine's route tables and their target-major form (ops/react.py), and the
fractional coarse cell grid for the LJ tier with the `aslot` inverse
table.  Every array has a shape fixed by the host-side RebuildPlan:
compaction is a masked cumsum into a fixed capacity (no data-dependent
`nonzero` shapes), and running past a capacity sets an overflow flag that
the Engine checks, re-sizes and retries on.

The rebuild reads no value on the host and copies nothing from it: the
plan's geometry reaches the device once per plan, device and dtype
(`rebuild_constants`), so that a CUDA graph can capture the whole rebuild
(run/device_loop.py).  `flags_to_host` is the caller's one copy back.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.box import Box, matvec3
from ..ops import build
from ..ops.react import build_route_tables, route_by_target
from ..ops.select_candidates import CellRuns, select_candidates
from .build import CellData, NeighborData
from .neighbor import Ghosts, NeighborList

#: sub-cells per axis of the LJ cell table's slot order (_bin_dense): runs
#: of 32 slots become compact tiles that the LJ kernels can cull whole
LJ_CELL_SUB = 4


@dataclasses.dataclass(frozen=True)
class RebuildPlan:
    """Static geometry + capacities of one rebuild shape."""

    shifts: Tuple[Tuple[int, int, int], ...]   # candidate image shifts
    margins: Tuple[float, float, float]        # fractional ghost margins
    grid_mn: Tuple[float, float, float]        # Cartesian grid origin
    ghost_capacity: int
    cand_dims: Tuple[int, int, int]            # fine grid ([N, K] tiers)
    cand_size: float
    cand_capacity: int                         # Cf
    k_caps: Tuple[Tuple[str, int], ...]        # per-tier K
    cell_dims: Tuple[int, int, int]            # coarse grid incl. halo ring
    cell_size: float
    cell_capacity: int                         # C
    cell_tiers: Tuple[str, ...]
    list_cut: float
    skin: float
    mirror_tiers: Tuple[str, ...] = ()
    cell_mn: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    a_range: Tuple[Tuple[int, int], ...] = ((0, 0), (0, 0), (0, 0))
    periodic: Tuple[bool, bool, bool] = (True, True, True)
    lo_ref: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    bnd_capacity: int = 0                      # two-stage ghost compaction
    cell_frac: bool = False                    # fractional coarse cells
    # reaction-combine route capacities (ops/react.py): source blocks per
    # output chunk, route depth, routed rows per chunk; 0 = no tables
    react_nw: int = 0
    react_kc: int = 0
    react_qr: int = 0


def make_plan(box: Box, requests: Dict[str, np.ndarray], skin: float,
              ghost_count: int, max_cell_occupancy: int,
              k_counts: Dict[str, int], slack: float = 1.3,
              cell_tiers: Tuple[str, ...] = (),
              cand_occupancy: int | None = None,
              mirror_tiers: Tuple[str, ...] = (),
              k_final: bool = False, frac_cells: bool = True,
              bnd_count: int = 0, react_nw: int = 0, react_kc: int = 0,
              react_qr: int = 0) -> RebuildPlan:
    """Static geometry + padded capacities from measured counts.

    k_final=True takes k_counts as exact K capacities (rounded up to 4)."""
    cuts = {k: np.asarray(v, np.float64) for k, v in requests.items()}
    list_cut = max(float(v.max()) for v in cuts.values()) + skin
    knames = [k for k in cuts if k not in cell_tiers]
    cand_size = (max(float(cuts[k].max()) for k in knames) + skin
                 if knames else list_cut)
    cell_size = (max(float(cuts[k].max()) for k in cell_tiers) + skin
                 if cell_tiers else list_cut)

    widths = box.perpendicular_widths_np()
    gmargin = list_cut + 1e-3
    margins = tuple(float(gmargin / widths[d]) if box.periodic[d] else 0.0
                    for d in range(3))
    nrep = [int(np.ceil(gmargin / widths[d])) if box.periodic[d] else 0
            for d in range(3)]
    shifts = tuple((sx, sy, sz)
                   for sx in range(-nrep[0], nrep[0] + 1)
                   for sy in range(-nrep[1], nrep[1] + 1)
                   for sz in range(-nrep[2], nrep[2] + 1)
                   if (sx, sy, sz) != (0, 0, 0))

    h = box.h_np()
    lo = box.lo_np()
    corners = np.array([lo + np.array([a, b, c]) @ h
                        for a in (-margins[0], 1 + margins[0])
                        for b in (-margins[1], 1 + margins[1])
                        for c in (-margins[2], 1 + margins[2])])
    mn = corners.min(axis=0) - 1e-6
    mx = corners.max(axis=0) + 1e-6
    cand_dims = tuple(int(np.ceil((mx[d] - mn[d]) / cand_size))
                      for d in range(3))
    cell_mn = tuple(float(mn[d] - cell_size) for d in range(3))
    cell_dims = tuple(int(np.ceil((mx[d] - mn[d]) / cell_size)) + 2
                      for d in range(3))
    pcorners = np.array([lo + np.array([a, b, c]) @ h
                         for a in (0.0, 1.0) for b in (0.0, 1.0)
                         for c in (0.0, 1.0)])
    eps = 1e-4 * cell_size + 1e-3
    pmn = pcorners.min(axis=0) - eps
    pmx = pcorners.max(axis=0) + eps
    a_range = []
    for d in range(3):
        a0 = max(int(np.floor((pmn[d] - cell_mn[d]) / cell_size)), 1)
        a1 = min(int(np.floor((pmx[d] - cell_mn[d]) / cell_size)) + 1,
                 cell_dims[d] - 1)
        if not (1 <= a0 < a1 <= cell_dims[d] - 1):
            raise ValueError(f"A-range dim {d}: [{a0},{a1}) outside "
                             f"halo-safe [1,{cell_dims[d] - 1})")
        a_range.append((a0, a1))
    a_range = tuple(a_range)

    # fractional coarse cells: the interior grid tiles the prism exactly
    cell_frac = False
    if frac_cells and cell_tiers and all(box.periodic):
        m_frac = [int(np.floor(widths[d] / gmargin)) for d in range(3)]
        if all(m >= 1 for m in m_frac):
            cell_frac = True
            cell_dims = tuple(m + 2 for m in m_frac)
            a_range = tuple((1, m + 1) for m in m_frac)

    def pad8(v):
        return max(8, int(-(-int(v * slack) // 8) * 8))

    if cand_occupancy is None:
        cand_occupancy = int(max_cell_occupancy
                             * (cand_size / cell_size) ** 3) + 4
    return RebuildPlan(
        shifts=shifts, margins=margins, grid_mn=tuple(mn),
        lo_ref=tuple(float(v) for v in lo),
        ghost_capacity=pad8(max(ghost_count, 8)),
        cand_dims=cand_dims, cand_size=cand_size,
        cand_capacity=pad8(max(cand_occupancy, 2)),
        k_caps=tuple(sorted(
            (k, max(8, -(-int(v) // 4) * 4) if k_final else pad8(v))
            for k, v in k_counts.items() if k not in cell_tiers)),
        cell_dims=cell_dims, cell_size=cell_size,
        cell_capacity=max(8, -(-int(max(max_cell_occupancy, 4) * 1.03 + 2)
                               // 8) * 8),
        cell_tiers=tuple(sorted(cell_tiers)),
        list_cut=list_cut, skin=skin,
        mirror_tiers=tuple(sorted(mirror_tiers)),
        cell_mn=cell_mn, a_range=a_range, cell_frac=cell_frac,
        periodic=tuple(bool(p) for p in box.periodic),
        bnd_capacity=pad8(bnd_count) if bnd_count > 0 else 0,
        react_nw=int(react_nw), react_kc=int(react_kc),
        react_qr=int(react_qr))


def make_plan_from_density(box: Box, requests: Dict[str, np.ndarray],
                           skin: float, natoms: int, slack: float = 1.6,
                           cell_tiers: Tuple[str, ...] = (),
                           mirror_tiers: Tuple[str, ...] = ()
                           ) -> RebuildPlan:
    """Capacities from the mean density (no host neighbor build); the
    rebuild's overflow flags catch underestimates."""
    cuts = {k: np.asarray(v, np.float64) for k, v in requests.items()}
    list_cut = max(float(v.max()) for v in cuts.values()) + skin
    knames = [k for k in cuts if k not in cell_tiers]
    cand_size = (max(float(cuts[k].max()) for k in knames) + skin
                 if knames else list_cut)
    cell_size = (max(float(cuts[k].max()) for k in cell_tiers) + skin
                 if cell_tiers else list_cut)
    vol = abs(np.linalg.det(box.h_np()))
    rho = natoms / vol
    widths = box.perpendicular_widths_np()
    margins = [(list_cut + 1e-3) / widths[d] if box.periodic[d] else 0.0
               for d in range(3)]
    expanded = vol * np.prod([1 + 2 * m for m in margins])
    ghost_count = int(rho * (expanded - vol)) + 64
    cell_vol = cell_size ** 3
    if cell_tiers and all(box.periodic):
        m_frac = [int(np.floor(widths[d] / (list_cut + 1e-3)))
                  for d in range(3)]
        if all(m >= 1 for m in m_frac):
            cell_vol = vol / float(np.prod(m_frac))
    occupancy = int(rho * cell_vol * 1.2) + 8
    cand_occ = int(rho * cand_size ** 3 * 1.2) + 4
    bnd_frac = 1.0 - float(np.prod([max(1.0 - 2.0 * m, 0.0)
                                    for m in margins]))
    bnd_count = int(natoms * bnd_frac * 1.3) + 64
    k_counts = {}
    for name, c in cuts.items():
        t = c.shape[0] - 1 if c.ndim == 2 else 0
        if c.ndim == 2 and t >= 1:
            per_type = [sum((rho / t) * 4.0 / 3.0 * np.pi
                            * (float(c[i, j]) + skin) ** 3
                            for j in range(1, t + 1) if c[i, j] > 0)
                        for i in range(1, t + 1)]
            k_counts[name] = int(max(per_type) * 1.1) + 8
        else:
            k_counts[name] = int(rho * 4.0 / 3.0 * np.pi
                                 * (float(np.max(c)) + skin) ** 3 * 1.1) + 8
    return make_plan(box, requests, skin, ghost_count, occupancy, k_counts,
                     slack=slack, cell_tiers=cell_tiers,
                     cand_occupancy=cand_occ, mirror_tiers=mirror_tiers,
                     bnd_count=bnd_count)


def _compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Positions of the True entries in order, padded with -1 to `size`:
    a fixed-shape nonzero (masked cumsum + scatter into a dump slot)."""
    m = mask.reshape(-1)
    rank = torch.cumsum(m.to(torch.int64), 0) - 1
    tgt = torch.where(m & (rank < size), rank,
                      torch.full_like(rank, size))
    out = torch.full((size + 1,), -1, dtype=torch.int64, device=m.device)
    out.scatter_(0, tgt, torch.arange(m.numel(), device=m.device))
    return out[:size]


def _pad_t(a: torch.Tensor, np_: int, fill) -> torch.Tensor:
    """[N, K] -> [K, Np] with the pad columns set to `fill`."""
    out = torch.full((a.shape[1], np_), fill, dtype=a.dtype, device=a.device)
    out[:, :a.shape[0]] = a.t()
    return out


def _morton(s3, sub: int):
    """Morton (z-order) index of sub-cell coordinates s3 [M, 3] in
    [0, sub), sub a power of two: x's bit above y's above z's."""
    m = torch.zeros_like(s3[:, 0])
    for k in range(sub.bit_length() - 1):
        for d in range(3):
            m = m | (((s3[:, d] >> k) & 1) << (3 * k + 2 - d))
    return m


def _bin_dense(x_all, valid_row, mn, size, dims, capacity, m_all,
               interior_first: int = 0, sub: int = 1):
    """Sorted dense cell table [ncells+2, capacity] (junk row + oob row).

    interior_first > 0 clips the cell of the first that many rows (the
    owned atoms) into [1, dims-2]: rounding at the hi face must never bin
    an owned atom into the halo ring, outside the LJ kernel's A range.
    sub > 1 (a power of two) orders each cell's slots by the Morton index
    of the atom's sub-cell on a sub x sub x sub grid of the cell's own
    frame (stable within a sub-cell), so that a run of consecutive slots
    is spatially compact; sub = 1 keeps the rows in input order.  Either
    way a cell holds the same atoms.  Past the capacity a cell's last slot
    holds its run's last row (one writer a slot; the other rows of the
    overflow go to the junk row).
    Returns (dense, c3, occupancy, overflow, order, starts): order [m_all]
    the rows by cell (the sort), starts [ncells + 1] each cell's first
    position in it (rows with valid_row False sort past starts[ncells])."""
    dev = x_all.device
    ncells = dims[0] * dims[1] * dims[2]
    hi = build.device_constants(tuple(dims), dev, torch.int64) - 1
    u = (x_all - mn) / size
    c3 = torch.floor(u).to(torch.int64)
    c3 = torch.minimum(torch.clamp(c3, min=0), hi)
    if interior_first:
        own = (torch.arange(m_all, device=dev) < interior_first)[:, None]
        c3 = torch.where(own, torch.minimum(torch.clamp(c3, min=1), hi - 1),
                         c3)
    cid = (c3[:, 0] * dims[1] + c3[:, 1]) * dims[2] + c3[:, 2]
    cid = torch.where(valid_row, cid, torch.full_like(cid, ncells))
    if sub > 1:
        s3 = torch.clamp(torch.floor((u - c3) * sub).to(torch.int64), 0,
                         sub - 1)
        nsub = sub ** 3
        key_sorted, order = torch.sort(cid * nsub + _morton(s3, sub),
                                       stable=True)
        cid_sorted = key_sorted // nsub
    else:
        cid_sorted, order = torch.sort(cid, stable=True)
    starts = torch.searchsorted(cid_sorted,
                                torch.arange(ncells + 1, device=dev))
    slot = torch.arange(m_all, device=dev) - starts[cid_sorted]
    occ = torch.max(torch.where(cid_sorted < ncells, slot,
                                torch.zeros_like(slot))) + 1
    # the last row of each run: the next position holds another cell
    last = cid_sorted != torch.cat([cid_sorted[1:],
                                    cid_sorted.new_full((1,), -1)])
    row = torch.where((slot < capacity - 1) | last, cid_sorted,
                      torch.full_like(cid_sorted, ncells))
    slot = torch.clamp(slot, max=capacity - 1)
    dense = torch.full((ncells + 2, capacity), m_all, dtype=torch.int64,
                       device=dev)
    dense[row, slot] = order
    return dense, c3, occ, occ > capacity, order, starts


def _nbr_cell_ids(dims, offs) -> np.ndarray:
    """[ncells, len(offs)] neighbor-cell ids (numpy; static geometry);
    out-of-range neighbors map to the oob row (ncells + 1)."""
    ncells = dims[0] * dims[1] * dims[2]
    ids = np.arange(ncells)
    c3s = np.stack([ids // (dims[1] * dims[2]),
                    (ids // dims[2]) % dims[1], ids % dims[2]], axis=1)
    nb = c3s[:, None, :] + offs[None, :, :]
    ok = np.all((nb >= 0) & (nb < np.array(dims)), axis=-1)
    nbid = (nb[..., 0] * dims[1] + nb[..., 1]) * dims[2] + nb[..., 2]
    return np.where(ok, nbid, ncells + 1).astype(np.int64)


def _inverse_shift_perm(shifts) -> np.ndarray:
    """[S+1]: slot 0 = identity, slot s+1 = shifts[s]; entry = the slot of
    the negated shift."""
    lut = {(0, 0, 0): 0}
    for i, s in enumerate(shifts):
        lut[tuple(s)] = i + 1
    inv = np.zeros(len(shifts) + 1, np.int64)
    for i, s in enumerate(shifts):
        inv[i + 1] = lut[(-s[0], -s[1], -s[2])]
    return inv


def _mirror_table(idx, mask, owner, ghost_valid, sidx_ghost, inv_t, n, K):
    """[N, K] flat slot (row*K + col) of each edge's mirror edge, -1 if
    none.  Edge (i, j): the mirror is the unique edge (owner(j), image of
    i under the negated shift of j), found through the ghost inverse
    table ginv[(owner, shift slot)] -> ghost id, then looked up in the
    lists: the keys row * M + idx of all N*K slots sorted stably, and each
    edge's key (mirror row, target) searched among them, so that the
    lowest slot of the mirror row holding the target wins.  inv_t: the
    device form of _inverse_shift_perm."""
    dev = idx.device
    Mg = owner.shape[0]
    ar_n = torch.arange(n, device=dev)
    o_all = torch.cat([ar_n, owner])
    inv_all = torch.cat([torch.zeros_like(ar_n), inv_t[sidx_ghost]])
    safe = torch.where(mask, idx, torch.zeros_like(idx))
    o = o_all[safe]                                   # mirror rows
    inv_sj = inv_all[safe]                            # inverse shift slot
    ginv = torch.full((n + 1, inv_t.shape[0]), -1, dtype=torch.int64,
                      device=dev)
    ginv[ar_n, 0] = ar_n
    gown = torch.where(ghost_valid, owner, torch.full_like(owner, n))
    ginv[gown, sidx_ghost] = n + torch.arange(Mg, device=dev)
    tgt = torch.gather(ginv[:n], 1, inv_sj)           # [N, K]
    # idx < M (the pad row n + Mg included), so key equality is row and
    # index equality; the stable sort keeps equal keys in slot order
    M = n + Mg + 1
    skeys, slot = torch.sort((ar_n[:, None] * M + idx).reshape(-1),
                             stable=True)
    query = (o * M + tgt).reshape(-1)
    pos = torch.clamp(torch.searchsorted(skeys, query), max=n * K - 1)
    hit = ((skeys[pos] == query) & (tgt.reshape(-1) >= 0)).reshape(n, K)
    colp = slot[pos].reshape(n, K) % K
    return torch.where(mask & hit, o * K + colp, torch.full_like(idx, -1))


_OFFS14 = np.array(
    [(0, 0, 0)] + [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                   for c in (-1, 0, 1) if (a, b, c) > (0, 0, 0)], np.int64)


@functools.lru_cache(maxsize=64)      # a plan's tables on each device
def _constants(plan: RebuildPlan, cuts: tuple, dtype, device) -> dict:
    """The device constants of one plan (see rebuild_constants); cuts:
    ((tier, shape, flat cutoffs), ...) as hashable content."""
    as_t = lambda v: torch.as_tensor(np.asarray(v, np.float64),  # noqa
                                     dtype=dtype, device=device)
    i64 = lambda v: torch.as_tensor(np.asarray(v, np.int64),  # noqa
                                    device=device)
    c = dict(periodic=as_t(np.array(plan.periodic, np.float64)),
             shifts=as_t(np.array(plan.shifts, np.float64).reshape(-1, 3)),
             margins=as_t(plan.margins),
             per=torch.as_tensor([m > 0 for m in plan.margins],
                                 device=device),
             lo_ref=as_t(plan.lo_ref), grid_mn=as_t(plan.grid_mn),
             inv_sidx=i64(_inverse_shift_perm(plan.shifts)), cut={})
    for name, shape, flat in cuts:
        cm = np.asarray(flat, np.float64).reshape(shape)
        cut = torch.zeros(cm.shape, dtype=dtype, device=device)
        cut[1:, 1:] = as_t(cm[1:, 1:])
        c["cut"][name] = cut + plan.skin
    if plan.cell_tiers:
        s_vec = 1.0 / (np.array(plan.cell_dims, np.float64) - 2.0)
        c.update(s_vec=as_t(s_vec), neg_s_vec=as_t(-s_vec),
                 cell_mn=as_t(plan.cell_mn),
                 nbid=i64(_nbr_cell_ids(plan.cell_dims, _OFFS14)))
    return c


def rebuild_constants(plan: RebuildPlan, cut_mats: Dict[str, np.ndarray],
                      dtype, device) -> dict:
    """Every host-side constant of device_rebuild on the device, uploaded
    once per plan, cutoffs, dtype and device (a small cache): image shifts,
    margins, grid origins, the inverse shift table, the per-tier cutoff
    tables (+ skin) and the cell grid's neighbour-cell map (the grids'
    dimensions: ops/build.py::device_constants).  A
    later rebuild with the same plan finds them and copies nothing from
    the host."""
    cuts = tuple((k, np.shape(v), tuple(np.asarray(v, np.float64).ravel()))
                 for k, v in sorted(cut_mats.items()))
    return _constants(plan, cuts, dtype, torch.device(device))


def flags_to_host(flags: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """All rebuild flags and counts in one device-to-host copy."""
    names = sorted(flags)
    vals = torch.stack([flags[k].to(torch.int64).reshape(())
                        for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def device_rebuild(plan: RebuildPlan, x, image, types, h, h_inv, lo,
                   cut_mats: Dict[str, np.ndarray], react: bool = False,
                   valid: torch.Tensor | None = None, wrap: bool = True):
    """(x, image) -> (xw, image', NeighborData, flags) with fixed shapes.

    cut_mats: per-tier [T+1, T+1] cutoff matrices (numpy).  react: measure
    the route geometry of the mirror tiers (count:rnw/rkc/rq) and, when
    the plan carries route capacities, build the route tables and their
    target-major form rtgt (react_overflow flags them too small).
    valid: optional [N] bool (JAX device_build.py:553): rows marked False,
    the pad rows of the sharded engine's blocks, are kept out of the
    boundary set, the ghosts, the candidate cells and the cell table, so
    that no list holds them; they should be parked far outside the box
    along a non-periodic axis, where no centre finds them and their own
    rows stay empty.
    wrap=False takes x as wrapped already (the sharded engine wraps its
    rows in the global cell): xw is x and image is kept, so that the lists
    are built on the positions the caller steps, even where rounding left
    a row on a periodic face (fractional coordinate 1.0 in float32), which
    a second wrap would move by a whole period."""
    dtype, dev = x.dtype, x.device
    n = x.shape[0]
    cst = rebuild_constants(plan, cut_mats, dtype, dev)

    # -- wrap into the primary cell (Domain::pbc) --------------------------
    f = matvec3(x - lo, h_inv)
    if wrap:
        shift = torch.floor(f)
        if not all(plan.periodic):
            shift = shift * cst["periodic"][None, :]
        fw = f - shift
        xw = matvec3(fw, h) + lo
        image = image + shift.to(torch.int32)
    else:
        fw, xw = f, x

    # -- ghost-image compaction, two-stage: boundary atoms, then images ---
    shifts, margins, per = cst["shifts"], cst["margins"], cst["per"]
    Mg, Nb = plan.ghost_capacity, plan.bnd_capacity
    near = (fw <= margins) | (fw >= 1.0 - margins)
    bnd = torch.any(near & per[None, :], dim=1)
    if valid is not None:
        bnd = bnd & valid
    flags = {"count:bnd": bnd.sum()}
    if 0 < Nb < n:
        bsel = _compact(bnd, Nb)
        flags["bnd_overflow"] = bnd.sum() > Nb
        b_safe = torch.clamp(bsel, min=0)
        fi = fw[b_safe][None, :, :] + shifts[:, None, :]    # [S, Nb, 3]
        keep = torch.all((fi >= -margins) & (fi <= 1.0 + margins), dim=-1)
        flat = (keep & (bsel >= 0)[None, :]).reshape(-1)
        sel = _compact(flat, Mg)
        ss = torch.clamp(sel, min=0)
        owner, sslot = b_safe[ss % Nb], ss // Nb
    else:
        fi = fw[None, :, :] + shifts[:, None, :]            # [S, N, 3]
        keep = torch.all((fi >= -margins) & (fi <= 1.0 + margins), dim=-1)
        if valid is not None:
            keep = keep & valid[None, :]
        flat = keep.reshape(-1)
        sel = _compact(flat, Mg)
        ss = torch.clamp(sel, min=0)
        owner, sslot = ss % n, ss // n
    ghost_valid = sel >= 0
    sidx_from_sel = sslot + 1                     # slot 0 = identity shift
    # invalid ghosts are parked far away
    gshift = torch.where(ghost_valid[:, None], shifts[sslot],
                         torch.full_like(shifts[sslot], 1e5))
    flags["ghost_overflow"] = flat.sum() > Mg
    flags["count:ghost"] = flat.sum()

    ghosts = Ghosts(owner=owner, shift=gshift)
    x_all = ghosts.all_positions(xw, h)                     # [n+Mg, 3]
    t_all = ghosts.all_types(types)
    m_all = n + Mg
    valid_row = torch.cat([torch.ones(n, dtype=torch.bool, device=dev)
                           if valid is None else valid, ghost_valid])
    lo_off = lo - cst["lo_ref"]
    mn = cst["grid_mn"] + lo_off
    x_pad = torch.cat([x_all, x.new_full((1, 3), 1e7)], dim=0)
    t_pad = torch.cat([t_all, t_all.new_zeros(1)])

    # -- [N, K] tiers: fine-grid candidates -------------------------------
    lists = {}
    if plan.k_caps:
        Cf = plan.cand_capacity
        dense_f, c3f, occf, ovf, order_f, starts_f = _bin_dense(
            x_all, valid_row, mn, plan.cand_size, plan.cand_dims, Cf, m_all)
        flags["candcell_overflow"] = ovf
        flags["count:candcell"] = occf
        # the binning's sort, which kernel D' reads in place of the table
        runs = CellRuns(order_f.to(torch.int32), starts_f.to(torch.int32),
                        mn, plan.cand_size)
        # (x, y, z, type) of every row and of the pad row, the one table the
        # candidate selection reads positions and types from
        xt_pad = torch.cat([x_pad, t_pad.to(dtype)[:, None]], dim=1)
        sidx_ghost = torch.where(ghost_valid, sidx_from_sel,
                                 torch.zeros_like(sidx_from_sel))
        Np = -(-n // 128) * 128
        # pad rows take no candidates, and no share of a kernel block (they
        # would all sit in the clipped edge cell of their parking place)
        c3_own = c3f[:n] if valid is None else torch.where(
            valid[:, None], c3f[:n], torch.full_like(c3f[:n], -1))
        for name, K in plan.k_caps:
            idx, jtype, mask, kmax = select_candidates(
                xt_pad, dense_f, c3_own, plan.cand_dims, cst["cut"][name],
                K, runs)
            kw = {}
            if name in plan.mirror_tiers:
                mirror = _mirror_table(idx, mask, owner, ghost_valid,
                                       sidx_ghost, cst["inv_sidx"], n, K)
                mir_ok = mask & (mirror >= 0)
                mir_safe = torch.clamp(mirror, min=0)
                mir_flat = torch.where(mir_ok, (mir_safe % K) * Np
                                       + mir_safe // K,
                                       torch.zeros_like(mir_safe))
                kw = dict(mirror=mirror, idxT=_pad_t(idx, Np, 0),
                          maskT=_pad_t(mask, Np, False),
                          jtypeT=_pad_t(jtype, Np, 0),
                          mirT=_pad_t(mir_flat, Np, 0).to(torch.int32),
                          mirvT=_pad_t(mir_ok, Np, False))
                if react:
                    (rblocks, _, route, nw_n, kc_n, rq_n,
                     r_ovf) = build_route_tables(
                        idx, mask, mirror, owner, n, K, plan.react_nw,
                        plan.react_kc, plan.react_qr)
                    flags[f"count:rnw:{name}"] = nw_n
                    flags[f"count:rkc:{name}"] = kc_n
                    flags[f"count:rq:{name}"] = rq_n
                    if plan.react_nw > 0:
                        rtgt, dt_n = route_by_target(rblocks, route, K, Np)
                        flags[f"count:rdt:{name}"] = dt_n
                        flags[f"react_overflow:{name}"] = r_ovf
                        flags[f"react_overflow:target:{name}"] = dt_n > K
                        kw.update(rblocks=rblocks, route=route, rtgt=rtgt)
            lists[name] = NeighborList(idx=idx, mask=mask, jtype=jtype,
                                       **kw)
            flags[f"k_overflow:{name}"] = kmax > K
            flags[f"count:k:{name}"] = kmax

    # -- cell-form tiers: coarse dense table + half-offset neighbor map ----
    cells = None
    if plan.cell_tiers:
        C = plan.cell_capacity
        if plan.cell_frac:
            # bin in wrapped fractional coordinates; owned rows clipped
            # strictly below 1 (f - floor(f) can round to 1.0 in f32)
            fb = torch.clamp(fw, 0.0, 1.0 - 2.0 ** -24)
            f_all = torch.cat([fb, fw[owner] + gshift])
            dense_c, _, occc, ovc, _, _ = _bin_dense(
                f_all, valid_row, cst["neg_s_vec"], cst["s_vec"],
                plan.cell_dims, C, m_all, interior_first=n,
                sub=LJ_CELL_SUB)
        else:
            dense_c, _, occc, ovc, _, _ = _bin_dense(
                x_all, valid_row, cst["cell_mn"] + lo_off, plan.cell_size,
                plan.cell_dims, C, m_all, sub=LJ_CELL_SUB)
        flags["cell_overflow"] = ovc
        flags["count:cell"] = occc
        nbid = cst["nbid"]
        cell_jt = torch.where(dense_c < m_all, t_pad[dense_c],
                              torch.zeros_like(dense_c))
        # inverse table: owned atom -> flat slot of the a_range force grid
        Dx, Dy, Dz = plan.cell_dims
        (ax0, _), (ay0, ay1), (az0, az1) = plan.a_range
        Ay, Az = ay1 - ay0, az1 - az0
        ncell3 = Dx * Dy * Dz
        io = torch.arange(ncell3 * C, device=dev)
        cellid, slot = io // C, io % C
        cx, rem = cellid // (Dy * Dz), cellid % (Dy * Dz)
        cy, cz = rem // Dz, rem % Dz
        aidx = (((cx - ax0) * Ay + (cy - ay0)) * Az + (cz - az0)) * C + slot
        ids = dense_c[:ncell3].reshape(-1)
        tgt = torch.where(ids < n, ids, torch.full_like(ids, n))
        aslot = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        aslot.scatter_(0, tgt, aidx)
        cells = CellData(table=dense_c, jtype=cell_jt, nbr_map=nbid,
                         n_owned=n, dims=plan.cell_dims,
                         a_range=plan.a_range, cell_mn=plan.cell_mn,
                         cell_size=plan.cell_size, aslot=aslot[:n])
    else:
        flags["cell_overflow"] = torch.zeros((), dtype=torch.bool,
                                             device=dev)
        flags["count:cell"] = torch.zeros((), dtype=torch.int64, device=dev)

    nbr = NeighborData(ghosts=ghosts, lists=lists, x_build=xw,
                       skin=plan.skin, cells=cells)
    return xw, image, nbr, flags
