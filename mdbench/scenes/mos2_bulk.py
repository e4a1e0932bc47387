"""MoS2 bulk: the 2H cell of USER-REBOMOS/in.rebomos-bulk tiled in a box
whose edges are integer combinations of the lattice vectors, as the
program's api/scenes.py::rebomos_bulk_commensurate lays it out (the
lattice arithmetic is a copy, so that the benchmark's inputs do not move
when the program changes).  (1302, 64, 16) gives config 5's 7,999,488
atoms."""

from __future__ import annotations

import torch

MOS2_A1 = (3.1903157234, 0.0, 0.0)
MOS2_A2 = (-1.5964590311, 2.7651481541, 0.0)
MOS2_A3 = (0.0, 0.0, 13.9827680588)
#: the 2H cell: two Mo and four S, fractional
BULK_BASIS = ((0.0, 0.0, 3.0 / 4.0), (0.0, 0.0, 1.0 / 4.0),
              (2.0 / 3.0, 1.0 / 3.0, 0.862008989),
              (1.0 / 3.0, 2.0 / 3.0, 0.137990996),
              (1.0 / 3.0, 2.0 / 3.0, 0.362008989),
              (2.0 / 3.0, 1.0 / 3.0, 0.637991011))
BULK_TYPES = (1, 1, 2, 2, 2, 2)


def make(nx: int, ny: int, nz: int, device):
    """nx x ny x nz 2H cells (A = nx a1, B = ny/2 a1 + ny a2, C = nz a3),
    ordered by cell (x slowest) and then by basis atom: (x, types, h) in
    float64, positions wrapped into the box."""
    if ny % 2:
        raise ValueError("ny must be even (B = ny/2 a1 + ny a2)")
    f64 = dict(dtype=torch.float64, device=device)
    lat = torch.tensor([MOS2_A1, MOS2_A2, MOS2_A3], **f64)
    A = nx * lat[0]
    B = (ny // 2) * lat[0] + ny * lat[1]
    C = nz * lat[2]
    h = torch.tensor([[float(A[0]), 0.0, 0.0],
                      [float(B[0]), float(B[1]), 0.0],
                      [float(C[0]), float(C[1]), float(C[2])]], **f64)
    ii, jj, kk = torch.meshgrid(torch.arange(nx, **f64),
                                torch.arange(ny, **f64),
                                torch.arange(nz, **f64), indexing="ij")
    cells = torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], 1)
    frac = cells[:, None, :] + torch.tensor(BULK_BASIS, **f64)[None]
    x = frac.reshape(-1, 3) @ lat
    f = x @ torch.linalg.inv(h)
    x = (f - torch.floor(f)) @ h
    types = torch.tensor(BULK_TYPES, device=device).repeat(len(cells))
    return x, types, h
