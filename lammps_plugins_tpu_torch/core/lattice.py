"""Lattice fills — LAMMPS `lattice custom` / `create_atoms box`.

Port of lammps_plugins_tpu/core/lattice.py, limited to what the REBOMOS
and AEAM scenes use (custom, fcc, bcc, sc).  Host-side numpy; see the JAX module for how `origin` was
pinned against the golden log.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from .box import Box


@dataclasses.dataclass
class Lattice:
    a1: np.ndarray
    a2: np.ndarray
    a3: np.ndarray
    basis: np.ndarray          # [nb, 3] fractional (lattice-vector) coords
    origin: np.ndarray         # [3] fractions of the lattice spacings
    scale: float = 1.0

    @classmethod
    def custom(cls, scale, a1, a2, a3, basis, origin=(0.0, 0.0, 0.0)):
        return cls(a1=np.asarray(a1, float) * scale,
                   a2=np.asarray(a2, float) * scale,
                   a3=np.asarray(a3, float) * scale,
                   basis=np.asarray(basis, float),
                   origin=np.asarray(origin, float), scale=scale)

    @classmethod
    def fcc(cls, a, origin=(0.0, 0.0, 0.0)):
        basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                          [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
        return cls(a1=np.array([a, 0.0, 0.0]), a2=np.array([0.0, a, 0.0]),
                   a3=np.array([0.0, 0.0, a]), basis=basis,
                   origin=np.asarray(origin, float), scale=a)

    @classmethod
    def bcc(cls, a, origin=(0.0, 0.0, 0.0)):
        basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
        return cls(a1=np.array([a, 0.0, 0.0]), a2=np.array([0.0, a, 0.0]),
                   a3=np.array([0.0, 0.0, a]), basis=basis,
                   origin=np.asarray(origin, float), scale=a)

    @classmethod
    def sc(cls, a, origin=(0.0, 0.0, 0.0)):
        return cls(a1=np.array([a, 0.0, 0.0]), a2=np.array([0.0, a, 0.0]),
                   a3=np.array([0.0, 0.0, a]),
                   basis=np.zeros((1, 3)),
                   origin=np.asarray(origin, float), scale=a)

    @property
    def primitive(self) -> np.ndarray:
        return np.stack([self.a1, self.a2, self.a3])

    def spacings(self) -> np.ndarray:
        """LAMMPS xlattice/ylattice/zlattice: bounding spans of the cell."""
        corners = np.array([i * self.a1 + j * self.a2 + k * self.a3
                            for i in (0, 1) for j in (0, 1) for k in (0, 1)])
        return corners.max(axis=0) - corners.min(axis=0)

    def lattice_points(self, cell_range) -> Tuple[np.ndarray, np.ndarray]:
        """All (position, basis index) for unit cells in the given ranges;
        `origin` shifts by fractions of the Cartesian spacings."""
        (ilo, ihi), (jlo, jhi), (klo, khi) = cell_range
        ii, jj, kk = np.meshgrid(np.arange(ilo, ihi + 1),
                                 np.arange(jlo, jhi + 1),
                                 np.arange(klo, khi + 1), indexing="ij")
        cells = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1)
        frac = cells[:, None, :] + self.basis[None, :, :]
        pos = frac.reshape(-1, 3) @ self.primitive
        pos = pos + self.origin * self.spacings()
        bidx = np.tile(np.arange(len(self.basis)), len(cells))
        return pos, bidx


def create_atoms_box(lattice: Lattice, box: Box,
                     basis_types: Sequence[int]) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Fill `box` with every lattice point whose fractional box coordinate
    lies in [0, 1); returns (positions [N, 3], 1-based types [N]) in
    deterministic (z, y, x) order."""
    h = box.h_np()
    lo = box.lo_np()
    corners = box.corners() - lattice.origin * lattice.spacings()
    lat_coords = corners @ np.linalg.inv(lattice.primitive)
    lolat = np.floor(lat_coords.min(axis=0)).astype(int) - 2
    hilat = np.ceil(lat_coords.max(axis=0)).astype(int) + 2
    pos, bidx = lattice.lattice_points(
        [(lolat[0], hilat[0]), (lolat[1], hilat[1]), (lolat[2], hilat[2])])
    frac = (pos - lo) @ np.linalg.inv(h)
    keep = np.all((frac >= 0.0) & (frac < 1.0), axis=1)
    pos, bidx = pos[keep], bidx[keep]
    types = np.asarray(basis_types, dtype=np.int32)[bidx]
    order = np.lexsort((pos[:, 0], pos[:, 1], pos[:, 2]))
    return pos[order], types[order]
