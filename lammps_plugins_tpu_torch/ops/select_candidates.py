"""The device rebuild's candidate selection (kernel D'): CUDA kernel
wrapper and plain-PyTorch twin.

Per owned atom i, its K nearest candidates inside the per-type-pair cutoff
window among the slots of the 27 fine cells around its own, from the
fine-cell table of the rebuild: the [N, K] list (idx, jtype, mask) and
kmax, the most candidates any row had inside the window.  This is the part
of lammps_plugins_tpu/neighbor/device_build.py::device_rebuild that builds
select_k's keys, fused with select_k itself
(lammps_plugins_tpu/ops/select_k_pallas.py::select_k, pallas_call at :99).

Columns of an atom's candidate row are o * Cf + s, o the index of the
neighbour cell's offset in OFFS27 and s the slot in that cell's row of the
table; ties of rsq go to the lowest column.  A candidate is in the window
when its id is below m_all (pads carry id m_all), it is not the atom
itself, and rsq = ((0 + dx^2) + dy^2) + dz^2 < cut * cut, with
dx = x_candidate - x_atom and cut[t_i, t_j] = fl(cm) + skin.

The twin builds the [rows, W] keys and selects with select_k_ref, in
chunks of rows.  The kernel reads the fine-cell binning's own sort
(CellRuns, from neighbor/device_build.py::_bin_dense): the rows in cell
order, each cell's run start, the grid's origin and cell width.  A block
stages a brick of cells with their neighbours in shared memory once (or
reads cells too large to stage in place), skips the cells that lie past
an atom's largest cut, and writes only the [N, K] outputs
(candidates_plan sizes bricks, warps and sort buffers).  Any K, any number
of types and any cell capacity whose shared memory fits a block.  On the
card both give the same lists, element for element.  A row whose cell has
a negative coordinate (a pad row of the sharded engine's blocks: a row the
binning put in no cell) has no candidates: an empty list.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from . import build
from .select_k import HIST_BYTES, SMEM_LIMIT, hit_capacity, select_k_ref

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0
#: bricks a block takes: x-columns of this many fine cells, largest first
BRICKS = (8, 4, 2, 1)
#: (staged, bricks) the plan may take: the brick's cells staged in shared
#: memory, or read in place (bricks of one cell)
MODES = ((True, BRICKS), (False, (1,)))
#: warps a block
CAND_WARPS = (16, 8, 4, 2, 1)
#: one SM of the H100: shared memory (228 KB, of which each block keeps 1
#: KB for itself), threads, registers; the kernel's registers a thread
#: (its launch bounds); resident warps past TARGET_WARPS do not count, and
#: a plan with MIN_WARPS resident warps an SM is enough
SM_SMEM = 233_472
BLOCK_SMEM = 1024
SM_THREADS = 2048
SM_REGS = 65_536
REGS = 64
TARGET_WARPS = 32
MIN_WARPS = 16

#: the 27 neighbour-cell offsets, (a, b, c) lexicographic over {-1, 0, 1}
OFFS27 = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
               for c in (-1, 0, 1))
BIG = float("inf")



def neighbour_cells(c3f, fdims):
    """[n, 27] flat ids of the fine cells around each c3f row; out-of-range
    cells, and every cell of a row with a negative coordinate, map to the
    table's empty pad row (ncf + 1)."""
    dev = c3f.device
    ncf = fdims[0] * fdims[1] * fdims[2]
    offs = build.device_constants(OFFS27, dev, torch.int64)
    nbr3 = c3f[:, None, :] + offs[None, :, :]
    in_rng = torch.all((nbr3 >= 0)
                       & (nbr3 < build.device_constants(tuple(fdims), dev,
                                                        torch.int64)), -1) \
        & torch.all(c3f >= 0, -1)[:, None]
    ncid = (nbr3[..., 0] * fdims[1] + nbr3[..., 1]) * fdims[2] \
        + nbr3[..., 2]
    return torch.where(in_rng, ncid, torch.full_like(ncid, ncf + 1))


class CellRuns(NamedTuple):
    """The fine-cell binning's sort, as the kernel reads it: order [m_all]
    int32, the rows sorted by cell (stable: each run is in row order);
    starts [ncf + 1] int32, each cell's first position (the rows past
    starts[ncf] are in no cell); origin [3] and size, the grid's."""
    order: torch.Tensor
    starts: torch.Tensor
    origin: torch.Tensor
    size: float

    def to(self, device):
        return CellRuns(self.order.to(device), self.starts.to(device),
                        self.origin.to(device), self.size)


def select_candidates_ref(xt_pad, dense_f, c3f, fdims, cut, k, runs=None,
                          select=select_k_ref):
    """Twin: the keys of each chunk of rows [rows, 27 Cf], then `select`
    (select_k_ref; chip_smoke.py passes ops.select_k.select_k, kernel D,
    to time the unfused path on the card); runs, the kernel's input, is
    not read.  Returns (idx, jtype, mask, kmax) as select_candidates."""
    n = c3f.shape[0]
    m_all = xt_pad.shape[0] - 1
    dtype, dev = xt_pad.dtype, xt_pad.device
    if dtype == torch.float32 and m_all >= 2 ** 24:
        # this path only: ids ride the candidate rows and the selection
        # as float32 payloads; the kernel keeps them int32
        raise ValueError(f"{m_all} owned+ghost rows: the twin carries atom "
                         "ids as float32, exact only below 2^24")
    Cf = dense_f.shape[1]
    W = 27 * Cf
    Wp = -(-W // 128) * 128
    ncid = neighbour_cells(c3f, fdims)
    # packed candidate table [ncf+2, 5*Cf]: (x | y | z | type | id) blocks,
    # so each atom's candidates are ONE row gather
    tmp4 = xt_pad[dense_f]                                  # [ncf+2, Cf, 4]
    idf = torch.clamp(dense_f, max=m_all).to(dtype)
    packed5 = torch.cat([tmp4[..., 0], tmp4[..., 1], tmp4[..., 2],
                         tmp4[..., 3], idf], dim=1)
    tcut = cut.to(dtype)
    # chunk over atom blocks: the [chunk, W] working set is ~6 arrays
    CH = n if n <= 131072 else 65536
    parts = []
    for c0 in range(0, n, CH):
        c1 = min(c0 + CH, n)
        g = packed5[ncid[c0:c1]]                            # [ch, 27, 5Cf]
        comp = [g[:, :, a * Cf:(a + 1) * Cf].reshape(c1 - c0, W)
                for a in range(5)]
        cand, cand_t = comp[4], comp[3]
        rsq = torch.zeros_like(cand)
        for a in range(3):
            da = comp[a] - xt_pad[c0:c1, a][:, None]
            rsq = rsq + da * da
        rid = torch.arange(c0, c1, device=dev).to(dtype)
        valid = (cand < m_all) & (cand != rid[:, None])
        ti = xt_pad[c0:c1, 3].long()[:, None]
        cutv = tcut[ti, cand_t.long()]
        m_tier = valid & (rsq < cutv * cutv)
        key = torch.where(m_tier, rsq, torch.full_like(rsq, BIG))
        padw = lambda a_, fill: torch.nn.functional.pad(  # noqa: E731
            a_, (0, Wp - W), value=fill)
        pos, idfk, jtfk = select(
            padw(key, BIG).contiguous(), k,
            payloads=(padw(cand, 0.0).contiguous(),
                      padw(cand_t, 0.0).contiguous()))
        mask = pos < W
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        parts.append((torch.where(mask, idfk.to(torch.int64), zero),
                      torch.where(mask, jtfk.to(torch.int64), zero), mask,
                      m_tier.sum(dim=1).max()))
    idx, jtype, mask = (torch.cat([p[i] for p in parts]) for i in range(3))
    return idx, jtype, mask, torch.stack([p[3] for p in parts]).max()


def cell_tested(xt_pad, c3f, runs, fdims, cut):
    """[n, 27] bool: the kernel's cell test in torch float32, False where
    neighbour cell o (OFFS27 order) of an owned row lies out of reach: the
    squared distance from the atom to the cell's nearest point, taken
    along each axis from the faces of the atom's own cell, is past
    (sqrt(the row's largest cut^2) + slack)^2, slack = 1e-3 size + 2^-16
    (max |origin| + max(fdims) size + size), which covers the rounding of
    the binning's (x - origin) / size.  The kernel skips only cells this
    marks False (the leading and trailing rows and cells of each plane)."""
    f32 = torch.float32
    x = xt_pad[:c3f.shape[0], :3].to(f32)
    ti = xt_pad[:c3f.shape[0], 3].long()
    org = runs.origin.to(device=x.device, dtype=f32)
    size = torch.tensor(runs.size, dtype=f32)
    cut2 = cut.to(f32) * cut.to(f32)
    rmax2 = cut2.max(dim=1).values[ti]
    slack = (torch.tensor(1e-3, dtype=f32) * size
             + (org.abs().max() + float(max(fdims)) * size + size)
             * 2.0 ** -16)
    lim2 = (torch.sqrt(rmax2) + slack) ** 2
    lo_face = org + c3f.clamp(min=0).to(f32) * size
    lo = torch.clamp(x - lo_face, min=0.0) ** 2
    hi = torch.clamp(lo_face + size - x, min=0.0) ** 2
    zero = torch.zeros_like(lo)
    face = torch.stack([lo, zero, hi], dim=-1)          # [n, 3 axes, 3]
    d2 = (face[:, 0, :, None, None] + face[:, 1, None, :, None]
          + face[:, 2, None, None, :]).reshape(-1, 27)
    return d2 <= lim2[:, None]


def candidates_bytes(warps, cap, bucket, bx, staged, Cf, nt):
    """Shared memory of one block (csrc/select_k.cu::cand_layout): the
    staging of the brick's union of (bx + 2) x 3 x 3 cells (x, y, z, type
    and row: 20 bytes a slot), its table, the [nt, nt] squared cuts, each
    warp's buffers (keys and r: 8 bytes an entry, 16 with the bucket
    sort's second pair, and a 256-bin histogram) and the block's kmax."""
    U = (bx + 2) * 9
    S = U * Cf if staged else 0
    meta_ints = (4 * U + bx + 2 + 3) & ~3
    per_warp = cap * (16 if bucket else 8) + HIST_BYTES
    return (S * 16 + ((S * 4 + 15) & ~15) + meta_ints * 4
            + ((nt * nt * 4 + 15) & ~15) + warps * per_warp + 16)


@dataclasses.dataclass(frozen=True)
class CandidatesPlan:
    """A launch of D' (one block a brick): warps a block, each warp's hit
    buffer (cap), the bucket sort or the bitonic one, the brick (bx cells
    along x), staged or read in place, shared bytes a block and blocks
    resident on an SM."""
    warps: int
    cap: int
    bucket: bool
    bx: int
    staged: bool
    nbytes: int
    blocks_per_sm: int

    @property
    def resident_warps(self) -> int:
        return self.warps * self.blocks_per_sm


def candidates_plan(k: int, Cf: int, nt: int) -> CandidatesPlan:
    """The launch of select_candidates at k, Cf slots a cell and an [nt,
    nt] cut table: the bucket sort where one warp's second buffer fits
    (else the bitonic one); among MODES, BRICKS and CAND_WARPS, where
    MIN_WARPS warps an SM stay resident, the staged bricks first, then the
    most resident warps (up to TARGET_WARPS), the fewest warps a block
    (down to 4) and the longest brick; else the most warps a block, then
    the most resident.  A ValueError naming the limit when one warp reading in
    place does not fit.  (The order is what tools/torch_kernel_ab.py
    --explore measured on the H100.)"""
    cap = hit_capacity(k)
    for bucket in (True, False):
        best = None
        for staged, bricks in MODES:
            for bx in bricks:
                if staged and (bx + 2) * 9 * Cf >= 2 ** 31 - 1:
                    continue
                for warps in CAND_WARPS:
                    nbytes = candidates_bytes(warps, cap, bucket, bx,
                                              staged, Cf, nt)
                    if nbytes > SMEM_LIMIT:
                        continue
                    blocks = min(SM_SMEM // (nbytes + BLOCK_SMEM),
                                 SM_THREADS // (32 * warps),
                                 SM_REGS // (REGS * 32 * warps))
                    if blocks < 1:
                        continue
                    res = blocks * warps
                    key = ((True, staged, min(res, TARGET_WARPS),
                            -max(warps, 4), bx)
                           if res >= MIN_WARPS
                           else (False, staged, warps, res, bx))
                    if best is None or key > best[0]:
                        best = (key, CandidatesPlan(warps, cap, bucket, bx,
                                                    staged, nbytes, blocks))
        if best is not None:
            return best[1]
    need = candidates_bytes(1, cap, False, 1, False, Cf, nt)
    raise ValueError(f"select_candidates: k={k} ({cap}-entry hit buffer) "
                     f"and {nt} x {nt} cut table need {need} bytes of shared "
                     f"memory even for one warp reading its cells in place, "
                     f"past the H100's {SMEM_LIMIT}-byte block limit")


def select_candidates(xt_pad, dense_f, c3f, fdims, cut, k, runs=None,
                      out=None):
    """(idx [n, k] int64, jtype [n, k] int64, mask [n, k] bool, kmax).

    xt_pad [m_all + 1, 4]: x, y, z and type of the owned+ghost rows (the
    owned atoms first) and a pad row (x = 1e7, type 0); dense_f
    [ncf + 2, Cf] int64: the fine-cell table (m_all in empty slots; row
    ncf + 1 empty); c3f [n, 3]: the fine cell of each owned atom (a
    negative coordinate: a row without candidates); fdims:
    the fine grid; cut [T + 1, T + 1]: cm + skin per type pair; runs:
    the binning's CellRuns of the same table, which the kernel reads in
    place of the table; out: (idx, jtype, mask) to write into, each
    element of them written.  CPU tensors take the twin; CUDA float32
    tensors the kernel."""
    global launches
    if not build.use_kernel(xt_pad, "select_candidates"):
        res = select_candidates_ref(xt_pad, dense_f, c3f, fdims, cut, k)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return (*out, res[3])
    dev = xt_pad.device
    n = c3f.shape[0]
    m_all = xt_pad.shape[0] - 1
    d0, d1, d2 = (int(d) for d in fdims)
    ncf = d0 * d1 * d2
    Cf = dense_f.shape[1]
    nt = cut.shape[0]
    if k < 1:
        raise ValueError(f"select_candidates: k={k} must be at least 1")
    if nt < 1 or tuple(cut.shape) != (nt, nt):
        raise ValueError(f"select_candidates: cut {tuple(cut.shape)} must "
                         "be square")
    if m_all >= 2 ** 31 - 1 or n == 0 or 27 * Cf >= 2 ** 31 - 1 \
            or ncf >= 2 ** 31 - 1:
        raise ValueError(f"select_candidates: {n} owned of {m_all} rows, "
                         f"{Cf} slots a cell, {ncf} cells: ids, cells and "
                         "columns are int32")
    if runs is None:
        raise ValueError("select_candidates: the kernel reads the fine-cell "
                         "binning's runs (runs=CellRuns)")
    plan = candidates_plan(k, Cf, nt)
    xp = build.check(xt_pad, "xt_pad", (m_all + 1, 4), torch.float32, dev)
    if tuple(dense_f.shape) != (ncf + 2, Cf) or dense_f.device != dev:
        raise ValueError(f"select_candidates: table {tuple(dense_f.shape)} "
                         f"on {dense_f.device}, expected ({ncf + 2}, Cf) on "
                         f"{dev}")
    order = build.check(runs.order, "order", (m_all,), torch.int32, dev)
    starts = build.check(runs.starts, "starts", (ncf + 1,), torch.int32, dev)
    origin = build.check(runs.origin, "origin", (3,), torch.float32, dev)
    cutp = build.check(cut, "cut", (nt, nt), torch.float32, dev)
    # without staging the kernel reads the positions in cell order: one
    # 16-byte element a row
    xs = None if plan.staged else xt_pad.view(torch.complex128).view(
        -1).index_select(0, runs.order)
    if out is None:
        out = (torch.empty((n, k), dtype=torch.int64, device=dev),
               torch.empty((n, k), dtype=torch.int64, device=dev),
               torch.empty((n, k), dtype=torch.bool, device=dev))
    idx, jtype, mask = out
    for name, t, dt in (("idx", idx, torch.int64),
                        ("jtype", jtype, torch.int64),
                        ("mask", mask, torch.bool)):
        build.check(t, name, (n, k), dt, dev)
    kmax = torch.zeros((), dtype=torch.int64, device=dev)
    status = build.lib().lpt_select_candidates(
        xp, None if xs is None else xs.data_ptr(), order, starts, cutp,
        origin, idx.data_ptr(),
        jtype.data_ptr(), mask.data_ptr(), kmax.data_ptr(), float(runs.size),
        nt, d0, d1, d2, Cf, n, m_all, k, plan.warps, plan.cap,
        int(plan.bucket), plan.bx, int(plan.staged), build.stream(dev))
    build.raise_on_error(status, "select_candidates")
    launches += 1
    return idx, jtype, mask, kmax
