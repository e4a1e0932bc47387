"""Geometric regions (port of lammps_plugins_tpu/core/region.py): the
LAMMPS `region` command's block, prism and sphere, and `side out` as the
complement.

`inside(x)` returns a bool per atom.  fix bfield filters by region inside
its post_integrate hook (fix_bfield.cpp:370), which the device loop
captures in a CUDA graph; so a region copies nothing from the host once
its bounds are on a device: they go there once per dtype and device
(`_on`, a small cache) and the same tensors serve every later call.  A
caller that captures a step puts them there first (FixBfield.setup).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

BIG = 1.0e30


@functools.lru_cache(maxsize=64)
def _on(values: tuple, dtype, device) -> torch.Tensor:
    """The bound `values` as a tensor of `dtype` on `device`, made once."""
    return torch.as_tensor(np.asarray(values, np.float64), dtype=dtype,
                           device=device)


@dataclasses.dataclass(frozen=True)
class Region:
    name: str = "region"

    def inside(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def complement(self) -> "Region":
        return _Complement(inner=self)


@dataclasses.dataclass(frozen=True)
class _Complement(Region):
    inner: Region = None

    def inside(self, x):
        return ~self.inner.inside(x)


@dataclasses.dataclass(frozen=True)
class Block(Region):
    """region ID block xlo xhi ylo yhi zlo zhi (INF/EDGE -> +-BIG)."""

    lo: tuple = (-BIG, -BIG, -BIG)
    hi: tuple = (BIG, BIG, BIG)

    def inside(self, x):
        lo = _on(tuple(self.lo), x.dtype, x.device)
        hi = _on(tuple(self.hi), x.dtype, x.device)
        return torch.all((x >= lo) & (x <= hi), dim=-1)


@dataclasses.dataclass(frozen=True)
class Prism(Region):
    """region ID prism xlo xhi ylo yhi zlo zhi xy xz yz.

    Containment through the fractional coordinates of the tilted cell
    (LAMMPS RegPrism::inside inverts the edge-vector matrix)."""

    lo: tuple = (0.0, 0.0, 0.0)
    hi: tuple = (1.0, 1.0, 1.0)
    tilt: tuple = (0.0, 0.0, 0.0)      # xy, xz, yz

    def h_matrix(self) -> np.ndarray:
        lx = self.hi[0] - self.lo[0]
        ly = self.hi[1] - self.lo[1]
        lz = self.hi[2] - self.lo[2]
        xy, xz, yz = self.tilt
        return np.array([[lx, 0.0, 0.0], [xy, ly, 0.0], [xz, yz, lz]])

    def inside(self, x):
        m = _prism_inv(tuple(map(tuple, self.h_matrix())), x.dtype, x.device)
        v = x - _on(tuple(self.lo), x.dtype, x.device)
        f = torch.stack([v[..., 0] * m[0, a] + v[..., 1] * m[1, a]
                         + v[..., 2] * m[2, a] for a in range(3)], dim=-1)
        return torch.all((f >= 0.0) & (f <= 1.0), dim=-1)


@dataclasses.dataclass(frozen=True)
class Sphere(Region):
    center: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0

    def inside(self, x):
        c = _on(tuple(self.center), x.dtype, x.device)
        return torch.sum((x - c) ** 2, dim=-1) <= self.radius ** 2


@functools.lru_cache(maxsize=64)
def _prism_inv(h: tuple, dtype, device) -> torch.Tensor:
    """_tri_inv of the prism's edge matrix, in `dtype` on `device`, once."""
    return _tri_inv(_on(h, dtype, device))


def _tri_inv(h):
    """Closed-form inverse of a lower-triangular 3x3 (see Box.h_inv)."""
    lx, ly, lz = h[0, 0], h[1, 1], h[2, 2]
    xy, xz, yz = h[1, 0], h[2, 0], h[2, 1]
    zero = torch.zeros_like(lx)
    return torch.stack([
        torch.stack([1.0 / lx, zero, zero]),
        torch.stack([-xy / (lx * ly), 1.0 / ly, zero]),
        torch.stack([(xy * yz - ly * xz) / (lx * ly * lz),
                     -yz / (ly * lz), 1.0 / lz]),
    ])
