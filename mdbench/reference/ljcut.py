"""Plain pair_style lj/cut (one atom type): E = sum over unordered pairs
closer than the cutoff of 4 eps ((sigma/r)^12 - (sigma/r)^6), unshifted,
forces by autograd.  `dtype` is the arithmetic of the potential; the
displacement vectors are formed in float64 and then cast to it.  Each
card of the pair list (neighbors.py) sums its own blocks; the partial
sums are added on the first card in card order."""

from __future__ import annotations

import torch

from neighbors import BLOCK_PAIRS, Cards, build
from tally import Sums


class LJCut:
    def __init__(self, cutoff: float, epsilon: float, sigma: float,
                 devices=None, block: int = BLOCK_PAIRS):
        self.cutoff = float(cutoff)
        self.eps = float(epsilon)
        self.sigma = float(sigma)
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = None if devices is None else list(devices)
        self.block = block

    def pairs(self, x, h, types, skin: float = 0.0):
        return build(x, h, self.cutoff + skin,
                     Cards(self.devices or [x.device], self.block))

    def energy_forces(self, x, h, types, pairs, dtype=torch.float64):
        """(E, F [N, 3] float64) from the listed pairs closer than the
        cutoff at x."""
        out = self.evaluate(x, h, types, pairs, dtype)
        return out["e"], out["f"]

    def evaluate(self, x, h, types, pairs, dtype=torch.float64,
                 tallies: bool = False) -> dict:
        """e, f and, with `tallies`, eatom [N] and vatom [N, 6]: half of
        each pair's energy and virial -(d (x) dE/dd) to each end."""
        rc2 = self.cutoff * self.cutoff

        def part(k, dev):
            acc = Sums(x.shape[0], dev, tallies)
            xk, hk = x.to(dev), h.to(device=dev, dtype=torch.float64)
            for _, i, j, d in pairs.on_card(k, xk, hk):
                inside = (d * d).sum(1) < rc2
                i, j = i[inside], j[inside]
                d = d[inside].to(dtype).detach().requires_grad_(True)
                sr2 = self.sigma * self.sigma / (d * d).sum(1)
                sr6 = sr2 * sr2 * sr2
                v = 4.0 * self.eps * sr6 * (sr6 - 1.0)
                e = v.sum()
                (g,) = torch.autograd.grad(e, d)
                acc.pairs(i, j, e, v, d, g.double())
            return acc

        return Sums.total(pairs.cards, pairs.cards.run(part))

    def counts(self, x, h, types, pairs) -> dict:
        """Unordered pairs inside the force cutoff (not the skin)."""
        rc2 = self.cutoff * self.cutoff

        def part(k, dev):
            xk, hk = x.to(dev), h.to(device=dev, dtype=torch.float64)
            return sum(int(((d * d).sum(1) < rc2).sum())
                       for _, _, _, d in pairs.on_card(k, xk, hk))

        return dict(atoms=x.shape[0],
                    ljcut_pairs=float(sum(pairs.cards.run(part))))
