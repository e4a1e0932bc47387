"""LAMMPS's fcc lattice of bench/in.lj (a copy of the lattice arithmetic,
so that the benchmark's inputs do not move when the program changes)."""

from __future__ import annotations

import torch


def make(n: int, density: float, device):
    """`lattice fcc density` (LJ units) and `region box block 0 n 0 n 0 n`,
    `create_atoms 1 box`, ordered by (z, y, x): (x, types, h)."""
    f64 = dict(dtype=torch.float64, device=device)
    a = (4.0 / density) ** (1.0 / 3.0)
    basis = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                          [0.0, 0.5, 0.5]], **f64)
    r = torch.arange(n, **f64)
    kk, jj, ii = torch.meshgrid(r, r, r, indexing="ij")
    cells = torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], 1)
    x = ((cells[:, None, :] + basis[None]) * a).reshape(-1, 3)
    order = torch.argsort(((x[:, 2] * (2 * n + 1) + x[:, 1]) * (2 * n + 1)
                           + x[:, 0]) / a, stable=True)
    x = x[order]
    types = torch.ones(len(x), dtype=torch.int64, device=device)
    h = torch.eye(3, **f64) * (n * a)
    return x, types, h
