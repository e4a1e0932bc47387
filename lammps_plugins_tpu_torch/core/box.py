"""Triclinic periodic box (port of lammps_plugins_tpu/core/box.py).

The cell matrix is in LAMMPS restricted-triclinic form, rows are the edge
vectors a, b, c, and r = lo + f @ H for fractional f.  Device tensors carry
the working dtype; the float64 masters h64/lo64 feed every host-side
geometry decision (lattice fills, ghost margins, plans), as in the JAX box.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .device import resolve


def matvec3(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row vectors [..., 3] times a 3x3 matrix, written component-wise.

    Same arithmetic order as the JAX package (whose TPU matmuls ran in
    bfloat16), so both packages round identically; on the H100 an f32
    ``@`` would also be exact only with TF32 off."""
    m = m.to(v.dtype)
    return torch.stack(
        [v[..., 0] * m[0, a] + v[..., 1] * m[1, a] + v[..., 2] * m[2, a]
         for a in range(3)], dim=-1)


@dataclasses.dataclass(frozen=True)
class Box:
    """Periodic triclinic box. `h` rows are edge vectors; `lo` the origin."""

    h: torch.Tensor                 # [3, 3] lower-triangular
    lo: torch.Tensor                # [3]
    periodic: Tuple[bool, bool, bool] = (True, True, True)
    h64: "tuple | None" = None      # float64 masters (host geometry)
    lo64: "tuple | None" = None

    @staticmethod
    def _master(arr) -> tuple:
        a = np.asarray(arr, np.float64)
        return tuple(map(tuple, a)) if a.ndim == 2 else tuple(a)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_numpy(cls, h, lo=(0.0, 0.0, 0.0), periodic=(True,) * 3,
                   dtype=torch.float32, device="cuda") -> "Box":
        device = resolve(device)
        h64 = np.asarray(h, np.float64)
        lo64 = np.asarray(lo, np.float64)
        return cls(h=torch.as_tensor(h64, dtype=dtype, device=device),
                   lo=torch.as_tensor(lo64, dtype=dtype, device=device),
                   periodic=tuple(bool(p) for p in periodic),
                   h64=cls._master(h64), lo64=cls._master(lo64))

    @classmethod
    def orthogonal(cls, lengths, lo=(0.0, 0.0, 0.0), periodic=(True,) * 3,
                   dtype=torch.float32, device="cuda") -> "Box":
        """Orthogonal box with edge lengths (lx, ly, lz)."""
        return cls.from_numpy(np.diag(np.asarray(lengths, np.float64)), lo,
                              periodic, dtype, device)

    @classmethod
    def triclinic(cls, lx, ly, lz, xy=0.0, xz=0.0, yz=0.0,
                  lo=(0.0, 0.0, 0.0), periodic=(True,) * 3,
                  dtype=torch.float32, device="cuda") -> "Box":
        """LAMMPS-style box from edge lengths and tilt factors."""
        h64 = np.array([[lx, 0.0, 0.0], [xy, ly, 0.0], [xz, yz, lz]],
                       np.float64)
        return cls.from_numpy(h64, lo, periodic, dtype, device)

    def to(self, device=None, dtype=None) -> "Box":
        """Same geometry with tensors on `device` / in `dtype`."""
        dtype = dtype or self.h.dtype
        return dataclasses.replace(
            self, h=self.h.to(device=device, dtype=dtype),
            lo=self.lo.to(device=device, dtype=dtype))

    def with_geometry(self, h=None, lo=None) -> "Box":
        """A Box with a new cell matrix and/or origin (array-likes), the
        float64 masters rebuilt with the tensors (dataclasses.replace
        would leave h64/lo64 stale)."""
        like = self.h
        new_h = self.h if h is None else torch.as_tensor(
            np.asarray(h, np.float64), dtype=like.dtype, device=like.device)
        new_lo = self.lo if lo is None else torch.as_tensor(
            np.asarray(lo, np.float64), dtype=like.dtype, device=like.device)
        return Box(h=new_h, lo=new_lo, periodic=self.periodic,
                   h64=self._master(h) if h is not None else self.h64,
                   lo64=self._master(lo) if lo is not None else self.lo64)

    # -- geometry ----------------------------------------------------------
    @property
    def lengths(self) -> torch.Tensor:
        """Edge vector lengths |a|, |b|, |c|."""
        return torch.linalg.norm(self.h, dim=1)

    def perpendicular_widths(self) -> torch.Tensor:
        """Distances between opposite box faces (device twin of
        perpendicular_widths_np)."""
        a, b, c = self.h[0], self.h[1], self.h[2]
        vol = self.volume
        return torch.stack([
            vol / torch.linalg.norm(torch.cross(b, c, dim=0)),
            vol / torch.linalg.norm(torch.cross(c, a, dim=0)),
            vol / torch.linalg.norm(torch.cross(a, b, dim=0))])

    def cell_angles_deg(self):
        """(alpha, beta, gamma) in degrees as tensors (device twin of
        cell_angles_deg_np)."""
        a, b, c = self.h[0], self.h[1], self.h[2]
        la, lb, lc = (torch.linalg.norm(v) for v in (a, b, c))
        return (torch.rad2deg(torch.arccos(torch.dot(b, c) / (lb * lc))),
                torch.rad2deg(torch.arccos(torch.dot(a, c) / (la * lc))),
                torch.rad2deg(torch.arccos(torch.dot(a, b) / (la * lb))))

    @property
    def h_inv(self) -> torch.Tensor:
        """Closed-form inverse of the lower-triangular cell matrix."""
        h = self.h
        lx, ly, lz = h[0, 0], h[1, 1], h[2, 2]
        xy, xz, yz = h[1, 0], h[2, 0], h[2, 1]
        zero = torch.zeros_like(lx)
        return torch.stack([
            torch.stack([1.0 / lx, zero, zero]),
            torch.stack([-xy / (lx * ly), 1.0 / ly, zero]),
            torch.stack([(xy * yz - ly * xz) / (lx * ly * lz),
                         -yz / (ly * lz), 1.0 / lz]),
        ])

    @property
    def volume(self) -> torch.Tensor:
        h = self.h
        return torch.abs(h[0, 0] * h[1, 1] * h[2, 2])

    def to_fractional(self, x: torch.Tensor) -> torch.Tensor:
        return matvec3(x - self.lo, self.h_inv)

    def from_fractional(self, f: torch.Tensor) -> torch.Tensor:
        return matvec3(f, self.h) + self.lo

    def wrap(self, x: torch.Tensor, image: torch.Tensor | None = None):
        """Wrap into the primary cell and update integer image counters."""
        f = self.to_fractional(x)
        per = torch.tensor(self.periodic, device=x.device)
        shift = torch.where(per[None, :], torch.floor(f),
                            torch.zeros_like(f))
        xw = self.from_fractional(f - shift)
        ishift = shift.to(torch.int32)
        return xw, (ishift if image is None else image + ishift)

    def unmap(self, x: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        """Continuous coordinates from wrapped x + image counters."""
        return x + matvec3(image.to(x.dtype), self.h)

    # -- host-side helpers (numpy, float64 masters) -----------------------
    def h_np(self) -> np.ndarray:
        if self.h64 is not None:
            return np.array(self.h64, dtype=np.float64)
        return self.h.detach().cpu().double().numpy()

    def lo_np(self) -> np.ndarray:
        if self.lo64 is not None:
            return np.array(self.lo64, dtype=np.float64)
        return self.lo.detach().cpu().double().numpy()

    def perpendicular_widths_np(self) -> np.ndarray:
        h = self.h_np()
        vol = abs(np.linalg.det(h))
        a, b, c = h
        return np.array([vol / np.linalg.norm(np.cross(b, c)),
                         vol / np.linalg.norm(np.cross(c, a)),
                         vol / np.linalg.norm(np.cross(a, b))])

    def wrap_np(self, x: np.ndarray, image: np.ndarray | None = None):
        """Host-side wrap (numpy mirror of wrap())."""
        h = self.h_np()
        lo = self.lo_np()
        f = (np.asarray(x, np.float64) - lo) @ np.linalg.inv(h)
        shift = np.floor(f)
        shift[:, ~np.asarray(self.periodic)] = 0.0
        xw = (f - shift) @ h + lo
        ishift = shift.astype(np.int32)
        if image is None:
            return xw, ishift
        return xw, np.asarray(image) + ishift

    def cell_angles_deg_np(self):
        """(alpha, beta, gamma) in degrees (thermo cellalpha..cellgamma)."""
        h = self.h_np()
        a, b, c = h
        la, lb, lc = (np.linalg.norm(v) for v in h)
        return (float(np.degrees(np.arccos(np.dot(b, c) / (lb * lc)))),
                float(np.degrees(np.arccos(np.dot(a, c) / (la * lc)))),
                float(np.degrees(np.arccos(np.dot(a, b) / (la * lb)))))

    def corners(self) -> np.ndarray:
        """The 8 Cartesian corners of the box (host-side numpy)."""
        h = self.h_np()
        lo = self.lo_np()
        return np.array([lo + i * h[0] + j * h[1] + k * h[2]
                         for i in (0, 1) for j in (0, 1) for k in (0, 1)])
