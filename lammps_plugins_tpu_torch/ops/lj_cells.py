"""Switched-LJ cell sweep: CUDA kernel wrapper and plain-PyTorch twin.

Counterpart of lammps_plugins_tpu/ops/lj_cells_pallas.py::lj_cell_forces.
Input: packed cell planes P [Dx, Dy, Dz, 8, C] (rows x, y, z, element
code 0 or 1, owned flag; pad slots parked at 1e7; one empty halo ring).
Output: [Ax, Ay, Az, 8, C] over the a_range cells: rows 0-2 the force on
each A slot from all 27 neighbour cells, row 3 0.5 * owned * sum_b V when
with_energy, other rows 0; with_virial adds a second output [Ax, Ay, Az,
6, C], each A slot's 0.5 * owned * sum_b fp d_a d_b in LAMMPS's vatom
order (xx yy zz xy xz yz, potentials/base.py VIRIAL_PAIRS), whose sum over
the owned atoms is the LJ tier's strain virial.

The kernel (csrc/lj_cells.cu) gives each warp a 32-slot A tile and skips
every 16-slot group of B slots that no slot of the tile can reach
(group_boxes, near_groups: its rule, for counting on the host); the
forces do not depend on the slot order within a cell.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from . import build

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0

LJ_NAMES = ("lj1", "lj2", "lj3", "lj4", "ljminsq", "ljmaxsq", "s95sq",
            "ljmin", "k2", "k3", "c2", "c3")
_MAX_C = 1024
TILE = 32              # slots per tile: one warp's lanes
GROUP = 16             # slots per culling box
PAD = 1e7              # where the planes park pad slots
PAD_MIN = 1e6          # x at or past it marks a pad slot (csrc/lj_common.cuh)


def derive_lj_constants(tables) -> dict:
    """Per-element-pair LJ scalars as bilinear coefficients (numpy copy of
    the JAX package's function): P = pa(ea) + pbc(ea) * eb with
    pa = P00 + ea (P10 - P00), pbc = (P01 - P00) + ea (P11 - P10 - P01 + P00).

    lj1..lj4 are the 12-6 force/energy prefactors, ljminsq/ljmaxsq/s95sq
    the squared regime boundaries, ljmin the ramp origin, k2 = -2 c2 and
    k3 = -3 c3 the ramp force, c2/c3 the ramp energy
    (pair_rebomos.cpp:262-265, 532-543)."""
    t = tables
    vals = {name: np.zeros((2, 2)) for name in LJ_NAMES}
    for ea in range(2):
        for eb in range(2):
            sig = float(t.sigma[ea, eb])
            eps = float(t.epsilon[ea, eb])
            ljmin = float(t.rcLJmin[ea, eb])
            ljmax = float(t.rcLJmax[ea, eb])
            drw = 0.95 * sig - ljmin
            r6c = (1.0 / 0.95) ** 6
            vdw = 4.0 * eps * r6c * (r6c - 1.0)
            dvdw = (-4.0 * eps / (0.95 * sig)) * r6c * (12.0 * r6c - 6.0)
            c2 = ((3.0 / drw) * vdw - dvdw) / drw
            c3 = (vdw / (drw * drw) - c2) / drw
            vals["lj1"][ea, eb] = float(t.lj1[ea, eb])
            vals["lj2"][ea, eb] = float(t.lj2[ea, eb])
            vals["lj3"][ea, eb] = float(t.lj3[ea, eb])
            vals["lj4"][ea, eb] = float(t.lj4[ea, eb])
            vals["ljminsq"][ea, eb] = ljmin * ljmin
            vals["ljmaxsq"][ea, eb] = ljmax * ljmax
            vals["s95sq"][ea, eb] = (0.95 * sig) ** 2
            vals["ljmin"][ea, eb] = ljmin
            vals["k2"][ea, eb] = -2.0 * c2
            vals["k3"][ea, eb] = -3.0 * c3
            vals["c2"][ea, eb] = c2
            vals["c3"][ea, eb] = c3
    return {name: (float(P[0, 0]), float(P[1, 0] - P[0, 0]),
                   float(P[0, 1] - P[0, 0]),
                   float(P[1, 1] - P[1, 0] - P[0, 1] + P[0, 0]))
            for name, P in vals.items()}


def pair_terms(A, B, consts, with_energy=False):
    """Switched-LJ pair blocks of cell planes A and B ([..., 8, C] each):
    A slots on rows, B slots on columns.  Returns (d, fp, v): d the three
    [..., C, C] components of x_a - x_b, fp the force factor
    (F_a += fp * d) and v the pair energy (None unless with_energy), both
    0 outside the LJ window."""
    ax, ay, az, ael = (A[..., r, :, None] for r in range(4))
    ebl = B[..., 3, None, :]

    def cst(name):
        a0, a1, b0, b1 = consts[name]
        return (a0 + ael * a1) + (b0 + ael * b1) * ebl

    d = [a - B[..., r, None, :] for r, a in enumerate((ax, ay, az))]
    rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    inwin = (rsq >= cst("ljminsq")) & (rsq <= cst("ljmaxsq"))
    rs = torch.where(inwin, rsq, torch.ones_like(rsq))
    rinv = torch.rsqrt(rs)
    r = rs * rinv
    r2inv = rinv * rinv
    r6inv = r2inv * r2inv * r2inv
    lj126 = rs >= cst("s95sq")
    drp = r - cst("ljmin")
    fp = torch.where(
        lj126, (cst("lj1") * r6inv - cst("lj2")) * r6inv * r2inv,
        drp * (cst("k3") * drp + cst("k2")) * rinv)
    fp = torch.where(inwin, fp, torch.zeros_like(fp))
    v = None
    if with_energy:
        v = torch.where(
            lj126, (cst("lj3") * r6inv - cst("lj4")) * r6inv,
            drp * drp * (cst("c3") * drp + cst("c2")))
        v = torch.where(inwin, v, torch.zeros_like(v))
    return d, fp, v


def lj_cell_forces_ref(P, consts, a_range, with_energy=False,
                       with_virial=False):
    """Twin: the closed-form sweep over the 27 offsets, one [cells, C, C]
    block per offset."""
    from ..potentials.base import VIRIAL_PAIRS
    (x0, x1), (y0, y1), (z0, z1) = a_range
    A = P[x0:x1, y0:y1, z0:z1]                         # [Ax, Ay, Az, 8, C]
    f = [torch.zeros_like(A[..., 0, :]) for _ in range(3)]
    en = torch.zeros_like(A[..., 0, :])
    vir = [torch.zeros_like(en) for _ in VIRIAL_PAIRS]
    for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
        B = P[x0 + ox:x1 + ox, y0 + oy:y1 + oy, z0 + oz:z1 + oz]
        d, fp, v = pair_terms(A, B, consts, with_energy)
        for a in range(3):
            f[a] = f[a] + (fp * d[a]).sum(dim=-1)
        if with_energy:
            en = en + v.sum(dim=-1)
        if with_virial:
            for c, (a, b) in enumerate(VIRIAL_PAIRS):
                vir[c] = vir[c] + (fp * d[a] * d[b]).sum(dim=-1)
    erow = 0.5 * A[..., 4, :] * en if with_energy else torch.zeros_like(en)
    zero = torch.zeros_like(en)
    out = torch.stack(f + [erow, zero, zero, zero, zero], dim=-2)
    if not with_virial:
        return out
    return out, 0.5 * A[..., 4:5, :] * torch.stack(vir, dim=-2)


def tile_planes(P):
    """Rows x, y, z, element of P padded to whole tiles: [..., 4, T * 32],
    slots past C parked at PAD as the kernels' packing pass does."""
    C = P.shape[-1]
    Q = F.pad(P[..., 0:4, :], (0, -(-C // TILE) * TILE - C))
    Q[..., 0:3, C:] = PAD
    return Q


def group_boxes(P):
    """(lo, hi) [Dx, Dy, Dz, G, 4]: per 16-slot group the minima and maxima
    of x, y, z and the element over its live (non-pad) slots, as the
    kernels' packing pass computes them (+-max float and elements 0 in a
    group without live slots)."""
    q = tile_planes(P)
    q = q.reshape(*q.shape[:-1], -1, GROUP)             # [..., 4, G, 16]
    live = q[..., 0:1, :, :] < PAD_MIN
    big = torch.finfo(P.dtype).max
    lo = torch.where(live, q, big).amin(-1)
    hi = torch.where(live, q, -big).amax(-1)
    empty = ~live.any(-1)
    lo[..., 3:4, :] = torch.where(empty, 0.0, lo[..., 3:4, :])
    hi[..., 3:4, :] = torch.where(empty, 0.0, hi[..., 3:4, :])
    return lo.transpose(-1, -2), hi.transpose(-1, -2)


def near_groups(QA, blo, bhi, consts):
    """The kernels' culling rule: [..., TA, GB] bool, True where some slot
    of A tile a lies within its largest LJ cutoff over B group g's element
    range (raised by 1e-5) of g's box.  QA [..., 4, TA * 32] (tile_planes), blo
    and bhi [..., GB, 4] (group_boxes)."""
    q = QA[..., 0:3, :, None]                           # [..., 3, S, 1]
    lo = blo[..., 0:3].transpose(-1, -2)[..., :, None, :]
    hi = bhi[..., 0:3].transpose(-1, -2)[..., :, None, :]
    g = torch.clamp(torch.maximum(lo - q, q - hi), min=0.0)
    gap2 = (g * g).sum(dim=-3)                          # [..., S, GB]
    a0, a1, b0, b1 = consts["ljmaxsq"]
    ea = QA[..., 3, :, None]
    cut = [(a0 + ea * a1) + (b0 + ea * b1) * e[..., None, :, 3]
           for e in (blo, bhi)]
    near = gap2 <= torch.maximum(*cut) * (1.0 + 1e-5)
    return near.reshape(*near.shape[:-2], -1, TILE,
                        near.shape[-1]).any(dim=-2)


def live_tiles(QA):
    """[..., TA] bool: the tiles of QA (tile_planes) that hold a live slot,
    the ones the kernels give work."""
    return (QA[..., 0, :] < PAD_MIN).reshape(*QA.shape[:-2], -1,
                                             TILE).any(-1)


def candidate_pairs(P, consts, a_range):
    """What the kernel tests, by its own rule: (tested, live) pairs of
    (A tile, B group) over the 27 offsets, `live` those whose tile and
    group both hold a live slot; the window test runs on the 32 x 16 slot
    pairs of each tested one."""
    (x0, x1), (y0, y1), (z0, z1) = a_range
    lo, hi = group_boxes(P)
    has = lo[..., 0] <= hi[..., 0]                      # [Dx, Dy, Dz, G]
    QA = tile_planes(P[x0:x1, y0:y1, z0:z1])
    tile_has = live_tiles(QA)
    tested = live = 0
    for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
        sl = (slice(x0 + ox, x1 + ox), slice(y0 + oy, y1 + oy),
              slice(z0 + oz, z1 + oz))
        tested += int(near_groups(QA, lo[sl], hi[sl], consts).sum())
        live += int((tile_has[..., :, None] & has[sl][..., None, :]).sum())
    return tested, live


def scratch_floats(shape) -> int:
    """Floats of the kernels' packing scratch for planes of `shape`: a
    float4 per slot of whole tiles and two float4 per group (its box)."""
    Dx, Dy, Dz, _, C = shape
    return Dx * Dy * Dz * -(-C // TILE) * (TILE + 2 * TILE // GROUP) * 4


def lj_cell_forces(P, consts, a_range, with_energy=False,
                   with_virial=False):
    """[Ax, Ay, Az, 8, C] forces (and energy row) from the cell planes;
    with_virial, (that, the [Ax, Ay, Az, 6, C] virial rows).
    CPU tensors take the twin; CUDA float32 tensors the kernel."""
    global launches
    if not build.use_kernel(P, "lj_cell_forces"):
        return lj_cell_forces_ref(P, consts, a_range, with_energy,
                                  with_virial)
    Dx, Dy, Dz, R, C = P.shape
    (x0, x1), (y0, y1), (z0, z1) = a_range
    if R != 8 or C > _MAX_C:
        raise ValueError(f"lj_cell_forces: planes {tuple(P.shape)} need "
                         f"8 rows and C <= {_MAX_C}")
    if not (x0 >= 1 and y0 >= 1 and z0 >= 1 and x1 <= Dx - 1
            and y1 <= Dy - 1 and z1 <= Dz - 1):
        raise ValueError(f"lj_cell_forces: a_range {a_range} leaves no "
                         f"halo ring in dims {(Dx, Dy, Dz)}")
    dev, f32 = P.device, torch.float32
    p_ptr = build.check(P, "P", P.shape, f32, dev)
    cvec = build.device_constants(
        tuple(v for n in LJ_NAMES for v in consts[n]), dev)
    Ax, Ay, Az = x1 - x0, y1 - y0, z1 - z0
    out = torch.empty((Ax, Ay, Az, 8, C), dtype=f32, device=dev)
    vir = (torch.empty((Ax, Ay, Az, 6, C), dtype=f32, device=dev)
           if with_virial else None)
    scratch = torch.empty(scratch_floats(P.shape), dtype=f32, device=dev)
    status = build.lib().lpt_lj_cell_forces(
        p_ptr, cvec.data_ptr(), out.data_ptr(), Dy, Dz, C, x0, y0, z0,
        Ax, Ay, Az, int(with_energy), build.stream(dev),
        scratch.data_ptr(), Dx, int(with_virial),
        None if vir is None else vir.data_ptr())
    build.raise_on_error(status, "lj_cell_forces")
    launches += 1
    return (out, vir) if with_virial else out
