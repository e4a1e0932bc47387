"""One MoS2 layer: the 2H cell of USER-REBOMOS/in.rebomos-bulk, its lower
layer's Mo plane and the two S planes around it, as the program's
api/scenes.py::rebomos_monolayer lays it out (the lattice arithmetic is a
copy, so that the benchmark's inputs do not move when the program
changes)."""

from __future__ import annotations

import torch

MOS2_A1 = (3.1903157234, 0.0, 0.0)
MOS2_A2 = (-1.5964590311, 2.7651481541, 0.0)
MOS2_C = 13.9827680588
#: the 2H cell's z = 1/4 Mo plane and the two S planes around it
MONO_BASIS = ((0.0, 0.0, 0.25), (1.0 / 3.0, 2.0 / 3.0, 0.137990996),
              (1.0 / 3.0, 2.0 / 3.0, 0.362008989))
MONO_TYPES = (1, 2, 2)


def make(nx: int, ny: int, vacuum: float, device):
    """One MoS2 layer, nx x ny in-plane cells (A = nx a1, B = ny/2 a1 +
    ny a2), centred in `vacuum` of empty z: (x, types, h) in float64."""
    if ny % 2:
        raise ValueError("ny must be even")
    f64 = dict(dtype=torch.float64, device=device)
    a1 = torch.tensor(MOS2_A1[:2], **f64)
    a2 = torch.tensor(MOS2_A2[:2], **f64)
    basis = torch.tensor(MONO_BASIS, **f64)
    z = basis[:, 2] * MOS2_C
    thick = float(z.max() - z.min())
    z = z - z.min() + 0.5 * vacuum
    A = nx * a1
    B = (ny // 2) * a1 + ny * a2
    h = torch.tensor([[float(A[0]), 0.0, 0.0], [float(B[0]), float(B[1]), 0.0],
                      [0.0, 0.0, thick + vacuum]], **f64)
    ii, jj = torch.meshgrid(torch.arange(nx, **f64), torch.arange(ny, **f64),
                            indexing="ij")
    cells = torch.stack([ii.reshape(-1), jj.reshape(-1)], 1)
    frac2 = cells[:, None, :] + basis[None, :, :2]
    xy = frac2.reshape(-1, 2) @ torch.stack([a1, a2])
    x = torch.cat([xy, z.repeat(len(cells))[:, None]], 1)
    f = x @ torch.linalg.inv(h)
    x = (f - torch.floor(f)) @ h
    types = torch.tensor(MONO_TYPES, device=device).repeat(len(cells))
    return x, types, h
