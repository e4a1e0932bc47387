"""Newton-half switched-LJ cell sweep: CUDA kernel wrapper and plain-PyTorch
twin.

Counterpart of lammps_plugins_tpu/ops/lj_cells_pallas.py::
lj_cell_forces_half.  Same input as ops/lj_cells.py (packed cell planes
P [Dx, Dy, Dz, 8, C] with one empty halo ring), but each unordered pair of
neighbouring cells is evaluated once, over the self cell and the 13
lexicographically positive offsets (HALF_OFFSETS), and its pair terms are
added to the A slot and subtracted from the B slot.  Returns the per-slot
forces [Ax, Ay, Az, C, 3] over the a_range cells, as the JAX function does,
ready for the same `aslot` remap.  No energy row.  The kernel
(csrc/lj_half.cu) culls 16-slot groups of B slots by the rule of
ops/lj_cells.py (candidate_pairs_half counts what it tests).
"""

from __future__ import annotations

import functools
import itertools

import torch

from . import build
from .lj_cells import (LJ_NAMES, group_boxes, live_tiles, near_groups,
                       pair_terms, scratch_floats, tile_planes)

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0

#: the self cell, then every (ox, oy, oz) > (0, 0, 0): with their negations
#: these cover the 27 neighbour cells once (the order of csrc/lj_half.cu)
HALF_OFFSETS = ((0, 0, 0),) + tuple(
    o for o in itertools.product((-1, 0, 1), repeat=3) if o > (0, 0, 0))
_MAX_C = 1024


def lj_cell_forces_half_ref(P, consts, a_range):
    """Twin: the closed form over the 14 unordered offsets.  For offset o
    the A cells span a_range extended by one cell opposite to o, so that
    every pair with a cell in a_range is evaluated once."""
    lo0 = [r[0] for r in a_range]
    hi0 = [r[1] for r in a_range]
    n = [h - lo for lo, h in zip(lo0, hi0)]
    C = P.shape[-1]
    out = P.new_zeros((*n, C, 3))
    for o in HALF_OFFSETS:
        lo = [l0 - max(oi, 0) for l0, oi in zip(lo0, o)]
        hi = [h0 - min(oi, 0) for h0, oi in zip(hi0, o)]
        A = P[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        B = P[lo[0] + o[0]:hi[0] + o[0], lo[1] + o[1]:hi[1] + o[1],
              lo[2] + o[2]:hi[2] + o[2]]
        d, fp, _ = pair_terms(A, B, consts)
        # A slots inside a_range: A = lo + i in [lo0, hi0)
        sa = tuple(slice(l0 - l, l0 - l + m) for l0, l, m in zip(lo0, lo, n))
        out += torch.stack([(fp * d[a]).sum(dim=-1) for a in range(3)],
                           dim=-1)[sa]
        if o != (0, 0, 0):
            # B slots inside a_range: B = lo + i + o in [lo0, hi0)
            sb = tuple(slice(l0 - l - oi, l0 - l - oi + m)
                       for l0, l, oi, m in zip(lo0, lo, o, n))
            out -= torch.stack([(fp * d[a]).sum(dim=-2) for a in range(3)],
                               dim=-1)[sb]
    return out


def _half_blocks(a_range, o, device):
    """The A cells of offset o (a_range extended by one cell opposite to
    o) as slices of the grid, and the bool grid over them of the blocks
    that run: A cell in a_range (A-side sums) or, o not the self cell, B
    cell in a_range (B-side sums)."""
    lo = [r[0] - max(oi, 0) for r, oi in zip(a_range, o)]
    hi = [r[1] - min(oi, 0) for r, oi in zip(a_range, o)]
    g = torch.meshgrid(*[torch.arange(l, h, device=device)
                         for l, h in zip(lo, hi)], indexing="ij")

    def inside(d):
        return functools.reduce(torch.logical_and, [
            (g[k] + d[k] >= a_range[k][0]) & (g[k] + d[k] < a_range[k][1])
            for k in range(3)])

    run = inside((0, 0, 0))
    if o != (0, 0, 0):
        run = run | inside(o)
    return tuple(slice(l, h) for l, h in zip(lo, hi)), run


def candidate_pairs_half(P, consts, a_range):
    """What the kernel tests, by its own rule: (tested, live, blocks) —
    pairs of (A tile, B group) tested over the 14 offsets' blocks that
    run, those whose tile and group both hold a live slot, and the number
    of such blocks (the first design tested C x C slot pairs in each)."""
    lo_b, hi_b = group_boxes(P)
    has = lo_b[..., 0] <= hi_b[..., 0]
    tested = live = blocks = 0
    for o in HALF_OFFSETS:
        A, run = _half_blocks(a_range, o, P.device)
        B = tuple(slice(s.start + d, s.stop + d) for s, d in zip(A, o))
        QA = tile_planes(P[A])
        near = near_groups(QA, lo_b[B], hi_b[B], consts)
        tested += int(near.sum((-2, -1))[run].sum())
        live += int((live_tiles(QA)[..., :, None] & has[B][..., None, :])
                    .sum((-2, -1))[run].sum())
        blocks += int(run.sum())
    return tested, live, blocks


def lj_cell_forces_half(P, consts, a_range):
    """[Ax, Ay, Az, C, 3] per-slot forces from the cell planes.
    CPU tensors take the twin; CUDA float32 tensors the kernel."""
    global launches
    if not build.use_kernel(P, "lj_cell_forces_half"):
        return lj_cell_forces_half_ref(P, consts, a_range)
    Dx, Dy, Dz, R, C = P.shape
    (x0, x1), (y0, y1), (z0, z1) = a_range
    if R != 8 or C > _MAX_C:
        raise ValueError(f"lj_cell_forces_half: planes {tuple(P.shape)} "
                         f"need 8 rows and C <= {_MAX_C}")
    if not (x0 >= 1 and y0 >= 1 and z0 >= 1 and x1 <= Dx - 1
            and y1 <= Dy - 1 and z1 <= Dz - 1):
        raise ValueError(f"lj_cell_forces_half: a_range {a_range} leaves "
                         f"no halo ring in dims {(Dx, Dy, Dz)}")
    dev, f32 = P.device, torch.float32
    p_ptr = build.check(P, "P", P.shape, f32, dev)
    cvec = build.device_constants(
        tuple(v for n in LJ_NAMES for v in consts[n]), dev)
    Ax, Ay, Az = x1 - x0, y1 - y0, z1 - z0
    part = torch.empty((2 * len(HALF_OFFSETS) - 1, Ax * Ay * Az, 3, C),
                       dtype=f32, device=dev)
    out = torch.empty((Ax, Ay, Az, C, 3), dtype=f32, device=dev)
    scratch = torch.empty(scratch_floats(P.shape), dtype=f32, device=dev)
    status = build.lib().lpt_lj_cell_forces_half(
        p_ptr, cvec.data_ptr(), part.data_ptr(), out.data_ptr(), Dy, Dz, C,
        x0, y0, z0, Ax, Ay, Az, build.stream(dev), scratch.data_ptr(), Dx)
    build.raise_on_error(status, "lj_cell_forces_half")
    launches += 1
    return out
