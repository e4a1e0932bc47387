"""Image pairs within a cutoff in a periodic triclinic box, by cell lists.

Plain PyTorch, independent of the program under test.  Atoms are binned
on fractional coordinates into cells whose perpendicular widths are at
least the cutoff, so every pair within the cutoff lies in the same cell
or in one of its 26 neighbours.  The half shell of 13 neighbour offsets
plus the pairs a < b of each cell itself gives every unordered image pair
once, even where a dimension holds only one or two cells (the shifts of
offsets +1 and -1 then differ).
"""

from __future__ import annotations

import itertools

import torch

#: elements of one [cells, C, C] distance block
BLOCK_ELEMS = 2 ** 26

HALF_SHELL = [o for o in itertools.product((-1, 0, 1), repeat=3)
              if (o[2], o[1], o[0]) > (0, 0, 0)]


def perpendicular_widths(h: torch.Tensor) -> torch.Tensor:
    """Distances between opposite faces of the cell whose rows are h."""
    vol = torch.abs(torch.linalg.det(h))
    a, b, c = h[0], h[1], h[2]
    return torch.stack([vol / torch.linalg.norm(torch.cross(b, c, dim=0)),
                        vol / torch.linalg.norm(torch.cross(c, a, dim=0)),
                        vol / torch.linalg.norm(torch.cross(a, b, dim=0))])


def wrap(x: torch.Tensor, h: torch.Tensor):
    """(positions inside the box, fractional coordinates in [0, 1))."""
    f = x @ torch.linalg.inv(h)
    f = f - torch.floor(f)
    f = torch.where(f >= 1.0, torch.zeros_like(f), f)
    return f @ h, f


def image_pairs(x: torch.Tensor, h: torch.Tensor, cutoff: float):
    """Unordered image pairs closer than `cutoff`: (i, j, shift) with
    |x[j] + shift @ h - x[i]| < cutoff, i and j int64 [P], shift int64
    [P, 3].  x is float64 [N, 3] anywhere in space; h the box rows."""
    x = x.to(torch.float64)
    h = h.to(torch.float64)
    dev = x.device
    xw, f = wrap(x, h)
    # the shift of the wrapped copy: x = xw - lift @ h
    lift = torch.round((xw - x) @ torch.linalg.inv(h)).to(torch.int64)
    nc = torch.clamp(torch.floor(perpendicular_widths(h) / cutoff),
                     min=1).to(torch.int64)
    c3 = torch.minimum((f * nc).to(torch.int64), nc - 1)
    flat = (c3[:, 2] * nc[1] + c3[:, 1]) * nc[0] + c3[:, 0]
    ncells = int(nc.prod())
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=ncells)
    C = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(x), device=dev) - starts[flat[order]]
    table = torch.full((ncells, C), -1, dtype=torch.int64, device=dev)
    table[flat[order], slot] = order
    cells = torch.arange(ncells, device=dev)
    cc = torch.stack([cells % nc[0], (cells // nc[0]) % nc[1],
                      cells // (nc[0] * nc[1])], 1)
    xpad = torch.cat([xw, xw.new_zeros((1, 3))])
    cut2 = cutoff * cutoff
    out_i, out_j, out_s = [], [], []
    step = max(1, BLOCK_ELEMS // (C * C))
    upper = torch.triu(torch.ones(C, C, dtype=torch.bool, device=dev), 1)
    for o in [(0, 0, 0)] + HALF_SHELL:
        o_t = torch.tensor(o, dtype=torch.int64, device=dev)
        nb = cc + o_t
        shift = torch.div(nb, nc, rounding_mode="floor")
        nb = nb - shift * nc
        nflat = (nb[:, 2] * nc[1] + nb[:, 1]) * nc[0] + nb[:, 0]
        svec = shift.to(torch.float64) @ h
        for c0 in range(0, ncells, step):
            c1 = min(c0 + step, ncells)
            a = table[c0:c1]
            b = table[nflat[c0:c1]]
            d = (xpad[b][:, None, :, :] + svec[c0:c1, None, None, :]
                 - xpad[a][:, :, None, :])
            r2 = (d * d).sum(-1)
            ok = (a[:, :, None] >= 0) & (b[:, None, :] >= 0) & (r2 < cut2)
            if o == (0, 0, 0):
                ok &= upper
            blk, sa, sb = torch.nonzero(ok, as_tuple=True)
            out_i.append(a[blk, sa])
            out_j.append(b[blk, sb])
            out_s.append(shift[c0 + blk])
    i = torch.cat(out_i)
    j = torch.cat(out_j)
    s = torch.cat(out_s) + lift[j] - lift[i]
    return i, j, s


def directed_lists(i, j, s, n: int):
    """Per-atom lists of the pairs (both directions): (nbr [n, K] atom
    ids, -1 where empty; shift [n, K, 3] of the neighbour's image)."""
    ii = torch.cat([i, j])
    jj = torch.cat([j, i])
    ss = torch.cat([s, -s])
    order = torch.argsort(ii, stable=True)
    ii, jj, ss = ii[order], jj[order], ss[order]
    counts = torch.bincount(ii, minlength=n)
    K = max(1, int(counts.max()) if len(ii) else 1)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(ii), device=ii.device) - starts[ii]
    nbr = torch.full((n, K), -1, dtype=torch.int64, device=ii.device)
    shift = torch.zeros((n, K, 3), dtype=torch.int64, device=ii.device)
    nbr[ii, slot] = jj
    shift[ii, slot] = ss
    return nbr, shift
