"""REBO per-edge cotangents: CUDA kernel wrapper and plain-PyTorch twin.

Counterpart of lammps_plugins_tpu/ops/rebo_pallas.py.  Given the [K, Np]
edge planes of the REBO list (atoms along the last axis), returns
G_e = dE_REBO/dd_e as three [K, Np] planes.  The kernel
(csrc/rebo.cu, one warp per atom over the atom's live edges) derives the
gradient by hand; the twin is autograd of the port's REBO energy
(potentials/rebomos.py::rebo_energy_rows).  With
emit_rows the kernel also writes the interleaved [K, Np, 4] table
(gx, gy, gz, 0) of the `rows` mirror combine, as the JAX kernel's
emit_rows output does.  The kernel takes any K whose shared memory fits
a block (rebo_plan).
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .select_k import SMEM_LIMIT

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0

_PAIR_NAMES = ("rcmin", "inv_drc", "Q", "A", "alpha", "BIJc", "Beta")
#: the constant vector's floats (rebo_constant_vector)
N_CONST = 64
#: a warp's compacted per-slot arrays in csrc/rebo.cu
SLOT_ARRAYS = 13
#: atoms (warps) a block, most first
ATOMS = (8, 4, 2, 1)
#: shared memory of one H100 SM (228 KB), for the occupancy of a plan
SM_SMEM = 233_472


def rebo_bytes(atoms: int, k: int, g: int) -> int:
    """Shared memory of a launch (csrc/rebo.cu::rebo_bytes): the constants,
    the input stage ([5, g] slots an atom; with g < k a [3, k] output stage
    beside it), each warp's compacted arrays for k slots and its n x n g
    and g' tables (n <= 32)."""
    pitch, kc, m = atoms + 1, -(-k // 32) * 32, min(k, 32)
    stage = (5 * g + 3 * k) * pitch if g < k else 5 * k * pitch
    return 4 * (N_CONST + stage + atoms * (SLOT_ARRAYS * kc
                                           + 2 * m * (m + 1)))


def resident_warps(atoms: int, nbytes: int) -> int:
    """Warps of `atoms`-warp blocks of nbytes of shared memory that one SM
    holds (SM_SMEM, 1 KB reserved a block, at most 32 blocks and 64
    warps)."""
    return atoms * min(SM_SMEM // (nbytes + 1024), 32, 64 // atoms)


def rebo_plan(k: int):
    """(atoms a block, slots staged at once, shared bytes) at k: all k
    slots staged, with the atoms a block that keep the most warps on an
    SM (the most atoms among equals); else the planes in groups of a
    multiple of 32 slots; a ValueError naming the limit when one atom with
    a 32-slot group does not fit."""
    fits = [(resident_warps(a, rebo_bytes(a, k, k)), a) for a in ATOMS
            if rebo_bytes(a, k, k) <= SMEM_LIMIT]
    if fits:
        atoms = max(fits)[1]
        return atoms, k, rebo_bytes(atoms, k, k)
    for atoms in ATOMS:
        g = -(-k // 32) * 32
        while g >= 32 and rebo_bytes(atoms, k, g) > SMEM_LIMIT:
            g -= 32
        if g >= 32:
            return atoms, g, rebo_bytes(atoms, k, g)
    raise ValueError(f"rebo_cotangents: K={k} needs "
                     f"{rebo_bytes(1, k, 32)} bytes of shared memory at one "
                     f"atom a block (compacted slots for K edges), past the "
                     f"H100's {SMEM_LIMIT}-byte block limit")


def derive_rebo_constants(tables) -> dict:
    """Static scalars (numpy copy of the JAX package's function).

    'pair:<name>': bilinear 4-tuples over (center el, neighbor el) — rcmin,
    inv_drc = 1/(rcmax-rcmin), Q, A, alpha, BIJc, Beta.
    'ctr:<name>': linear 2-tuples (c0, c1) over the center element — the g
    spline rows b0..b6 / bg0..bg6 and coordination a0..a3.
    """
    t = tables
    out = {}

    def bil(P):
        return (float(P[0, 0]), float(P[1, 0] - P[0, 0]),
                float(P[0, 1] - P[0, 0]),
                float(P[1, 1] - P[1, 0] - P[0, 1] + P[0, 0]))

    drc = np.asarray(t.rcmax, np.float64) - np.asarray(t.rcmin, np.float64)
    for name, P in (("rcmin", t.rcmin), ("inv_drc", 1.0 / drc),
                    ("Q", t.Q), ("A", t.A), ("alpha", t.alpha),
                    ("BIJc", t.BIJc), ("Beta", t.Beta)):
        out["pair:" + name] = bil(np.asarray(P, np.float64))
    b = np.asarray(t.b, np.float64)
    bg = np.asarray(t.bg, np.float64)
    a = np.asarray(t.a, np.float64)
    for i in range(7):
        out[f"ctr:b{i}"] = (float(b[0, i]), float(b[1, i] - b[0, i]))
        out[f"ctr:bg{i}"] = (float(bg[0, i]), float(bg[1, i] - bg[0, i]))
    for i in range(4):
        out[f"ctr:a{i}"] = (float(a[0, i]), float(a[1, i] - a[0, i]))
    return out


def rebo_constant_vector(consts: dict) -> list:
    """The 64 floats csrc/rebo.cu reads: 7 pair rows x 4, then the center
    rows b0..b6, bg0..bg6, a0..a3 x 2."""
    vec = [v for name in _PAIR_NAMES for v in consts["pair:" + name]]
    for name in ([f"b{i}" for i in range(7)] + [f"bg{i}" for i in range(7)]
                 + [f"a{i}" for i in range(4)]):
        vec.extend(consts["ctr:" + name])
    return vec


def rebo_cotangents_ref(dxT, dyT, dzT, jelT, mskT, ei, consts):
    """Twin: autograd of the REBO energy with respect to the displacement
    planes ([K, Np] in, [K, Np] x 3 out; any device and float dtype)."""
    from ..potentials.rebomos import rebo_energy_rows
    with torch.enable_grad():
        d = [t.detach().t().requires_grad_(True) for t in (dxT, dyT, dzT)]
        e = rebo_energy_rows(d[0], d[1], d[2], mskT.t() > 0, ei,
                             jelT.t(), consts)
        g = torch.autograd.grad(e, d)
    return tuple(gi.t().contiguous() for gi in g)


def rebo_cotangents(dxT, dyT, dzT, jelT, mskT, ei, consts,
                    emit_rows=False):
    """G_e planes (gx, gy, gz), each [K, Np], and with emit_rows a fourth
    output, the [K, Np, 4] rows (gx, gy, gz, 0).

    dxT/dyT/dzT: displacement planes; jelT: neighbor element code (0/1)
    as float; mskT: slot mask as float 0/1; ei: [Np] center element code
    as float; consts: derive_rebo_constants(tables).
    CPU tensors take the twin; CUDA float32 tensors the kernel."""
    global launches
    if not build.use_kernel(dxT, "rebo_cotangents"):
        g = rebo_cotangents_ref(dxT, dyT, dzT, jelT, mskT, ei, consts)
        if emit_rows:
            g = g + (torch.stack([*g, torch.zeros_like(g[0])], dim=-1),)
        return g
    K, Np = dxT.shape
    if K < 1:
        raise ValueError(f"rebo_cotangents: K={K} must be at least 1")
    atoms, group, _ = rebo_plan(K)
    dev, f32 = dxT.device, torch.float32
    ptrs = [build.check(t, n, (K, Np), f32, dev) for t, n in
            ((dxT, "dxT"), (dyT, "dyT"), (dzT, "dzT"), (jelT, "jelT"),
             (mskT, "mskT"))]
    ptrs.append(build.check(ei, "ei", (Np,), f32, dev))
    cvec = build.device_constants(tuple(rebo_constant_vector(consts)), dev)
    out = [torch.empty((K, Np), dtype=f32, device=dev) for _ in range(3)]
    rows = (torch.empty((K, Np, 4), dtype=f32, device=dev) if emit_rows
            else None)
    status = build.lib().lpt_rebo_cotangents(
        *ptrs, cvec.data_ptr(), *[o.data_ptr() for o in out],
        None if rows is None else rows.data_ptr(), K, Np, atoms, group,
        build.stream(dev))
    build.raise_on_error(status, "rebo_cotangents")
    launches += 1
    return tuple(out) + ((rows,) if emit_rows else ())
