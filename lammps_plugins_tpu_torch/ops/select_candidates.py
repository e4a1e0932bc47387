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
chunks of rows; the kernel stages each fine cell's 27 neighbour cells in
shared memory (in slices of 9, 3 or 1 cells when all 27 do not fit beside
the hit buffers and the [T + 1, T + 1] cut table, candidates_plan) and
writes only the [N, K] outputs.  Any K, any number of types and any cell
capacity whose shared memory fits a block.  On the card both give
the same lists, element for element.  A row whose cell has a negative
coordinate (a pad row of the sharded engine's blocks) has no candidates:
an empty list, and no share of a block's work.
"""

from __future__ import annotations

import torch

from . import build
from .select_k import (SMEM_LIMIT, WARPS, buffer_bytes, hit_capacity,
                       select_k_ref)

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0
#: neighbour cells staged at once: all 27, else x-planes, rows, cells
SLICES = (27, 9, 3, 1)

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


def select_candidates_ref(xt_pad, dense_f, c3f, fdims, cut, k,
                          select=select_k_ref):
    """Twin: the keys of each chunk of rows [rows, 27 Cf], then `select`
    (select_k_ref; chip_smoke.py passes ops.select_k.select_k, kernel D,
    to time the unfused path on the card).  Returns (idx, jtype, mask,
    kmax) as select_candidates."""
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


def candidates_plan(k: int, Cf: int, nt: int):
    """(warps, cap, cps, shared bytes) of a select_candidates launch: k's
    hit buffers (select_k.hit_capacity), cps of the 27 neighbour cells'
    Cf slots staged at once (24 bytes a slot: x, y, z, type, id, column)
    and the [nt, nt] cut table in one block's shared memory, preferring
    all 27 cells, then more warps; a ValueError naming the limit when one
    cell and one warp do not fit."""
    cap = hit_capacity(k)
    fixed = 4 * nt * nt
    for cps in SLICES:
        for warps in WARPS:
            nbytes = (24 * cps * Cf + buffer_bytes(warps, cap) + fixed
                      + 8 * warps)
            if nbytes <= SMEM_LIMIT:
                return warps, cap, cps, nbytes
    need = 24 * Cf + buffer_bytes(1, cap) + fixed + 8
    raise ValueError(f"select_candidates: k={k} ({cap}-entry hit buffer), "
                     f"{Cf} slots a cell and {nt} x {nt} cut table need "
                     f"{need} bytes of shared memory even for one cell and "
                     f"one warp, past the H100's {SMEM_LIMIT}-byte block "
                     "limit")


def prepare(dense_f, c3f, fdims, cut):
    """The kernel's int32 inputs: the cell table, the owned atoms ordered
    by fine cell (one block per cell takes its run [starts[c],
    starts[c + 1]) of `order`; rows with a negative cell sort past the
    last run, which no block takes) and the float32 cutoff table."""
    d0, d1, d2 = (int(d) for d in fdims)
    dev, i32 = c3f.device, torch.int32
    # int32 keys: half the radix passes of int64 ones
    cid = ((c3f[:, 0] * d1 + c3f[:, 1]) * d2 + c3f[:, 2]).to(i32)
    cid = torch.where(torch.all(c3f >= 0, -1), cid,
                      torch.full_like(cid, d0 * d1 * d2))
    scid, order = torch.sort(cid)
    starts = torch.searchsorted(scid, torch.arange(d0 * d1 * d2 + 1,
                                                   dtype=i32, device=dev))
    return (dense_f.to(i32).contiguous(), order.to(i32),
            starts.to(i32),
            cut.to(device=dev, dtype=torch.float32).contiguous())


def select_candidates(xt_pad, dense_f, c3f, fdims, cut, k):
    """(idx [n, k] int64, jtype [n, k] int64, mask [n, k] bool, kmax).

    xt_pad [m_all + 1, 4]: x, y, z and type of the owned+ghost rows (the
    owned atoms first) and a pad row (x = 1e7, type 0); dense_f
    [ncf + 2, Cf] int64: the fine-cell table (m_all in empty slots; row
    ncf + 1 empty); c3f [n, 3]: the fine cell of each owned atom (a
    negative coordinate: a row without candidates); fdims:
    the fine grid; cut [T + 1, T + 1]: cm + skin per type pair.  CPU
    tensors take the twin; CUDA float32 tensors the kernel."""
    global launches
    if not build.use_kernel(xt_pad, "select_candidates"):
        return select_candidates_ref(xt_pad, dense_f, c3f, fdims, cut, k)
    dev = xt_pad.device
    n = c3f.shape[0]
    m_all = xt_pad.shape[0] - 1
    d0, d1, d2 = (int(d) for d in fdims)
    Cf = dense_f.shape[1]
    nt = cut.shape[0]
    if k < 1:
        raise ValueError(f"select_candidates: k={k} must be at least 1")
    if nt < 1 or tuple(cut.shape) != (nt, nt):
        raise ValueError(f"select_candidates: cut {tuple(cut.shape)} must "
                         "be square")
    if m_all >= 2 ** 31 - 1 or n == 0 or 27 * Cf >= 2 ** 31 - 1:
        raise ValueError(f"select_candidates: {n} owned of {m_all} rows, "
                         f"{Cf} slots a cell: ids and columns are int32")
    warps, cap, cps, _ = candidates_plan(k, Cf, nt)
    xp = build.check(xt_pad, "xt_pad", (m_all + 1, 4), torch.float32, dev)
    if tuple(dense_f.shape) != (d0 * d1 * d2 + 2, Cf) \
            or dense_f.device != dev:
        raise ValueError(f"select_candidates: table {tuple(dense_f.shape)} "
                         f"on {dense_f.device}, expected "
                         f"({d0 * d1 * d2 + 2}, Cf) on {dev}")
    table, order, starts, cutc = prepare(dense_f, c3f, fdims, cut)
    # zeros: the rows no block takes keep an empty list
    idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    jtype = torch.zeros((n, k), dtype=torch.int64, device=dev)
    mask = torch.zeros((n, k), dtype=torch.bool, device=dev)
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    status = build.lib().lpt_select_candidates(
        xp, table.data_ptr(), order.data_ptr(), starts.data_ptr(),
        cutc.data_ptr(), nt, idx.data_ptr(), jtype.data_ptr(),
        mask.data_ptr(), cnt.data_ptr(), d0, d1, d2, Cf, m_all, k, warps,
        cap, cps, build.stream(dev))
    build.raise_on_error(status, "select_candidates")
    launches += 1
    return idx, jtype, mask, cnt.max().to(torch.int64)
