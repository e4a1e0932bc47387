"""REBOMOS and AEAM scenes (port of lammps_plugins_tpu/api/scenes.py).

Same constructions as the JAX package, so both packages build identical
atom orders, positions and types from the same arguments.  The scenes are
built on the card (float32) unless the caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import Box
from ..core.lattice import Lattice, create_atoms_box
from ..core.state import State
from ..fixes.velocity import set_type_fraction

#: MoS2 2H lattice from USER-REBOMOS/in.rebomos-bulk:3-12.
MOS2_A1 = (3.1903157234, 0.0, 0.0)
MOS2_A2 = (-1.5964590311, 2.7651481541, 0.0)
MOS2_A3 = (0.0, 0.0, 13.9827680588)
MOS2_BASIS = (
    (0.0, 0.0, 3.0 / 4.0),
    (0.0, 0.0, 1.0 / 4.0),
    (2.0 / 3.0, 1.0 / 3.0, 0.862008989),
    (1.0 / 3.0, 2.0 / 3.0, 0.137990996),
    (1.0 / 3.0, 2.0 / 3.0, 0.362008989),
    (2.0 / 3.0, 1.0 / 3.0, 0.637991011),
)
MOS2_BASIS_TYPES = (1, 1, 2, 2, 2, 2)      # Mo Mo S S S S
MOS2_MASSES = (95.95, 32.065)              # in.rebomos-bulk:24-25


def mos2_lattice(origin=(0.1, 0.1, 0.1)) -> Lattice:
    return Lattice.custom(1.0, MOS2_A1, MOS2_A2, MOS2_A3, MOS2_BASIS,
                          origin=origin)


def spatial_sort(pos: np.ndarray, types: np.ndarray, cell: float = 4.8):
    """Order atoms by (z, y, x) spatial cells (stable) — the analogue of
    LAMMPS `atom_modify sort`.  rebomos_bulk_commensurate(sort=True)
    applies it (the JAX package's LPT_SORT_SCENE=1)."""
    mn = pos.min(axis=0)
    c3 = ((pos - mn) / cell).astype(np.int64)
    dims = c3.max(axis=0) + 1
    key = (c3[:, 2] * dims[1] + c3[:, 1]) * dims[0] + c3[:, 0]
    order = np.argsort(key, kind="stable")
    return pos[order], types[order]


def alsi_sample(nc: int = 20, si_fraction: float = 0.0075,
                seed: int = 7683797, a: float = 4.045, dtype=torch.float32,
                device="cuda") -> State:
    """The USER-AEAM/sample.in scene: an nc^3-cell fcc Al box with a
    random Si substitution fraction (sample.in:8-19); nc=20 gives 32,000
    atoms.  The Si sites come from set_type_fraction's coordinate hash, in
    the scene's float type (statistically equivalent to LAMMPS `set
    type/fraction`)."""
    lat = Lattice.fcc(a)
    box = Box.orthogonal([a * nc] * 3, dtype=dtype, device=device)
    pos, types = create_atoms_box(lat, box, [1, 1, 1, 1])
    mass = np.array([0.0, 27.0, 28.0])     # AlSi.aeam per-element masses
    state = State.create(x=pos, type=types, box=box, mass=mass)
    return set_type_fraction(state, 2, si_fraction, seed)


def rebomos_bulk_commensurate(nx: int = 34, ny: int = 48, nz: int = 10,
                              dtype=torch.float32, device="cuda",
                              sort: bool = False) -> State:
    """Defect-free MoS2 bulk whose box vectors are integer combinations of
    the lattice vectors (A = nx a1, B = ny/2 a1 + ny a2, C = nz a3).
    Defaults give the 97,920-atom bench scene.  sort=True orders the atoms
    spatially (spatial_sort), which the combine="react" route tables
    need."""
    if ny % 2:
        raise ValueError("ny must be even (B = ny/2 a1 + ny a2)")
    a1, a2, a3 = (np.asarray(v) for v in (MOS2_A1, MOS2_A2, MOS2_A3))
    A = nx * a1
    B = (ny // 2) * a1 + ny * a2
    C = nz * a3
    box = Box.triclinic(lx=A[0], ly=B[1], lz=C[2], xy=B[0], xz=C[0],
                        yz=C[1], dtype=dtype, device=device)
    basis = np.asarray(MOS2_BASIS)
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    cells = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], 1).astype(float)
    frac = cells[:, None, :] + basis[None, :, :]
    pos = frac.reshape(-1, 3) @ np.stack([a1, a2, a3])
    types = np.tile(np.asarray(MOS2_BASIS_TYPES, np.int32), len(cells))
    h = box.h_np()
    f = pos @ np.linalg.inv(h)
    pos = (f - np.floor(f)) @ h
    if sort:
        pos, types = spatial_sort(pos, types)
    mass = np.array([0.0, *MOS2_MASSES])
    return State.create(x=pos, type=types, box=box, mass=mass)


def rebomos_bulk(nx: int = 4, ny: int = 8, nz: int = 1,
                 tilt_xy: float = -2.0, dtype=torch.float32,
                 device="cuda") -> State:
    """The in.rebomos-bulk scene; defaults give the golden 288-atom cell."""
    lat = mos2_lattice()
    sx, sy, sz = lat.spacings()
    box = Box.triclinic(lx=nx * sx, ly=ny * sy, lz=nz * sz,
                        xy=tilt_xy * sx, dtype=dtype, device=device)
    pos, types = create_atoms_box(lat, box, MOS2_BASIS_TYPES)
    mass = np.array([0.0, *MOS2_MASSES])
    return State.create(x=pos, type=types, box=box, mass=mass)
