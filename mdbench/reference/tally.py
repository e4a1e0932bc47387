"""Per-atom tallies under LAMMPS ev_tally's half-half split (compute
pe/atom and stress/atom): a term's energy and virial -(d_a dE/dd_b) go
half to each of the two atoms whose displacement d it reads."""

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
