"""Plain pair_style lj/cut (one atom type): E = sum over unordered pairs
closer than the cutoff of 4 eps ((sigma/r)^12 - (sigma/r)^6), unshifted,
forces by autograd.  `dtype` is the arithmetic of the potential; the
displacement vectors are formed in float64 and then cast to it."""

from __future__ import annotations

import torch

from neighbors import image_pairs
from tally import pair_halves

PAIR_BLOCK = 2 ** 24


class LJCut:
    def __init__(self, cutoff: float, epsilon: float, sigma: float):
        self.cutoff = float(cutoff)
        self.eps = float(epsilon)
        self.sigma = float(sigma)

    def pairs(self, x, h, types, skin: float = 0.0):
        return image_pairs(x, h, self.cutoff + skin)

    def energy_forces(self, x, h, types, pairs, dtype=torch.float64):
        """(E, F [N, 3] float64) from the listed pairs closer than the
        cutoff at x."""
        out = self.evaluate(x, h, types, pairs, dtype)
        return out["e"], out["f"]

    def evaluate(self, x, h, types, pairs, dtype=torch.float64,
                 tallies: bool = False) -> dict:
        """e, f and, with `tallies`, eatom [N] and vatom [N, 6]: half of
        each pair's energy and virial -(d (x) dE/dd) to each end."""
        i, j, s = pairs
        h = h.to(torch.float64)
        f64 = dict(dtype=torch.float64, device=x.device)
        F = torch.zeros_like(x, dtype=torch.float64)
        E = torch.zeros((), **f64)
        eat = torch.zeros(x.shape[0], **f64) if tallies else None
        vat = torch.zeros((x.shape[0], 6), **f64) if tallies else None
        rc2 = self.cutoff * self.cutoff
        for p0 in range(0, len(i), PAIR_BLOCK):
            p1 = min(p0 + PAIR_BLOCK, len(i))
            ii, jj = i[p0:p1], j[p0:p1]
            d = x[jj] + s[p0:p1].to(torch.float64) @ h - x[ii]
            inside = (d * d).sum(1) < rc2
            ii, jj = ii[inside], jj[inside]
            d = d[inside].to(dtype).detach().requires_grad_(True)
            sr2 = self.sigma * self.sigma / (d * d).sum(1)
            sr6 = sr2 * sr2 * sr2
            v = 4.0 * self.eps * sr6 * (sr6 - 1.0)
            e = v.sum()
            (g,) = torch.autograd.grad(e, d)
            g = g.double()
            F.index_add_(0, ii, g)
            F.index_add_(0, jj, -g)
            E = E + e.detach().double()
            if tallies:
                pair_halves(eat, vat, ii, jj, v.detach().double(),
                             d.detach().double(), g)
        return dict(e=E, f=F, eatom=eat, vatom=vat)

    def counts(self, x, h, types, pairs) -> dict:
        """Unordered pairs inside the force cutoff (not the skin)."""
        i, j, s = pairs
        d = x[j] + s.to(torch.float64) @ h.to(torch.float64) - x[i]
        inside = (d * d).sum(1) < self.cutoff * self.cutoff
        return dict(atoms=x.shape[0], ljcut_pairs=float(inside.sum()))
