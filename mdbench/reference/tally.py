"""Per-atom tallies under LAMMPS ev_tally's half-half split (compute
pe/atom and stress/atom): a term's energy and virial -(d_a dE/dd_b) go
half to each of the two atoms whose displacement d it reads; and one
card's partial sums of a potential's terms."""

from __future__ import annotations

import torch

from integrate import VIRIAL_PAIRS


def edge_halves(eat, vat, r0, jn, per_edge, d, g):
    """Tally a block of directed edges [B, K] (rows r0.., neighbours jn):
    half of each edge's energy and virial -(d_a g_b) to its centre, half
    to its neighbour.  Masked edges carry zero energy and cotangent."""
    v = torch.stack([-(d[..., a] * g[..., b]) for a, b in VIRIAL_PAIRS], -1)
    rows = slice(r0, r0 + per_edge.shape[0])
    eat[rows] += 0.5 * per_edge.sum(1)
    vat[rows] += 0.5 * v.sum(1)
    eat.index_add_(0, jn.reshape(-1), 0.5 * per_edge.reshape(-1))
    vat.index_add_(0, jn.reshape(-1), 0.5 * v.reshape(-1, 6))


def pair_halves(eat, vat, i, j, e, d, g):
    """Tally unordered pairs: half of each pair's energy and virial
    -(d_a g_b) to each end."""
    v = torch.stack([-(d[:, a] * g[:, b]) for a, b in VIRIAL_PAIRS], -1)
    for ends in (i, j):
        eat.index_add_(0, ends, 0.5 * e)
        vat.index_add_(0, ends, 0.5 * v)


class Sums:
    """One card's partial energy, forces and, with tallies, eatom and
    vatom (float64)."""

    def __init__(self, n: int, device, tallies: bool):
        f64 = dict(dtype=torch.float64, device=device)
        self.f = torch.zeros((n, 3), **f64)
        self.e = torch.zeros((), **f64)
        self.eatom = torch.zeros(n, **f64) if tallies else None
        self.vatom = torch.zeros((n, 6), **f64) if tallies else None

    def pairs(self, i, j, e, v, d, g):
        """Unordered pairs (i, j) with energies v (sum e), displacements
        d and cotangents g = dE/dd."""
        self.f.index_add_(0, i, g)
        self.f.index_add_(0, j, -g)
        self.e += e.detach().double()
        if self.eatom is not None:
            pair_halves(self.eatom, self.vatom, i, j, v.detach().double(),
                        d.detach().double(), g)

    def rows(self, r0, jn, e, per_edge, d, g):
        """Directed edges [B, K] of rows r0.. to neighbours jn."""
        self.f[r0:r0 + jn.shape[0]] += g.sum(1)
        self.f.index_add_(0, jn.reshape(-1), -g.reshape(-1, 3))
        self.e += e.detach().double()
        if self.eatom is not None:
            edge_halves(self.eatom, self.vatom, r0, jn,
                        per_edge.detach().double(), d.detach().double(), g)

    @staticmethod
    def total(cards, sums: list) -> dict:
        """e, f, eatom and vatom summed on the first card in card order."""
        return {key: None if getattr(sums[0], key) is None
                else cards.total([getattr(s, key) for s in sums])
                for key in ("e", "f", "eatom", "vatom")}
