"""Plain REBOMoS (Liang, Phillpot & Sinnott 2009; Stewart & Spearot 2013):
energy in PyTorch operations, forces by autograd.

Written from pair_rebomos.{h,cpp} of USER-REBOMOS as the program follows
it: E = 1/2 sum over directed REBO edges of w (VR + p_ij VA), with p_ij =
(1 + sum_k w_ik g(cos theta_jik) + P(N_i))^-1/2, plus the three-regime
switched LJ over every unordered pair between rcLJmin and rcLJmax.  It
reads the parameter file itself and imports nothing of the program.
`dtype` is the arithmetic of the potential; the displacement vectors are
always formed in float64 from the positions and then cast to it.

The work goes by blocks over the cards of the pair list (neighbors.py):
each card takes the LJ tier of its own pair blocks and picks their REBO
edges, then a fixed share of the atoms' REBO rows, in blocks of rows x
neighbours^2 of at most `block`; the partial sums are added on the
first card in card order.
"""

from __future__ import annotations

import copy
import math

import torch

from neighbors import BLOCK_PAIRS, Cards, build, directed, shift_table
from tally import Sums

PARAM_ORDER = (
    ["rcmin_MM", "rcmin_MS", "rcmin_SS", "rcmax_MM", "rcmax_MS", "rcmax_SS",
     "Q_MM", "Q_MS", "Q_SS", "alpha_MM", "alpha_MS", "alpha_SS",
     "A_MM", "A_MS", "A_SS", "BIJc_MM", "BIJc_MS", "BIJc_SS",
     "Beta_MM", "Beta_MS", "Beta_SS"]
    + [f"M_b{i}" for i in range(7)] + [f"M_bg{i}" for i in range(7)]
    + [f"S_b{i}" for i in range(7)] + [f"S_bg{i}" for i in range(7)]
    + [f"M_a{i}" for i in range(4)] + [f"S_a{i}" for i in range(4)]
    + ["epsilon_MM", "epsilon_SS", "sigma_MM", "sigma_SS"])

TOL = 1.0e-9          # pair_rebomos.cpp: bonds with w <= TOL are skipped
#: the LJ tier is evaluated, in the potential's dtype, on the pairs whose
#: float64 distance lies within this share of its window; the window
#: itself is decided in that dtype, as over all pairs
LJ_MARGIN = 0.02


def read_params(path: str) -> dict:
    vals = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if line:
                vals.append(float(line.split()[0]))
    if len(vals) < len(PARAM_ORDER):
        raise ValueError(f"{path}: {len(vals)} values, want "
                         f"{len(PARAM_ORDER)}")
    return dict(zip(PARAM_ORDER, vals))


class REBOMoS:
    """Element codes 0 = Mo, 1 = S; `elem` maps 1-based atom types.
    `devices` (one or a list, in card order; by default x's device) are
    the cards its pair lists and sums spread over, `block` the size of
    one block."""

    def __init__(self, path: str, elements, devices=None,
                 block: int = BLOCK_PAIRS):
        p = read_params(path)
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = None if devices is None else list(devices)
        self.block = block
        self.device = torch.device(devices[0] if devices else "cpu")
        self._views = {}
        codes = {"Mo": 0, "M": 0, "S": 1}
        self.elem = torch.tensor([0] + [codes[e] for e in elements],
                                 device=self.device)

        def sym(name):
            mm, ms, ss = (p[f"{name}_{s}"] for s in ("MM", "MS", "SS"))
            return torch.tensor([[mm, ms], [ms, ss]], dtype=torch.float64,
                                device=self.device)

        self.rcmin, self.rcmax = sym("rcmin"), sym("rcmax")
        self.Q, self.alpha, self.A = sym("Q"), sym("alpha"), sym("A")
        self.BIJc, self.Beta = sym("BIJc"), sym("Beta")
        rows = lambda pre, n: torch.tensor(  # noqa: E731
            [[p[f"M_{pre}{i}"] for i in range(n)],
             [p[f"S_{pre}{i}"] for i in range(n)]], dtype=torch.float64,
            device=self.device)
        self.b, self.bg, self.a = rows("b", 7), rows("bg", 7), rows("a", 4)
        smm, sss = p["sigma_MM"], p["sigma_SS"]
        emm, ess = p["epsilon_MM"], p["epsilon_SS"]
        self.sigma = torch.tensor([[smm, (smm + sss) / 2],
                                   [(smm + sss) / 2, sss]],
                                  dtype=torch.float64, device=self.device)
        self.eps = torch.tensor([[emm, math.sqrt(emm * ess)],
                                 [math.sqrt(emm * ess), ess]],
                                dtype=torch.float64, device=self.device)
        self.ljmin = self.rcmin
        self.ljmax = 2.5 * self.sigma
        self.cutoff = float(max(self.ljmax.max(), self.rcmax.max()))

    def _at(self, device) -> "REBOMoS":
        """This potential with its tables on `device`."""
        device = torch.device(device)
        if device not in self._views:
            view = copy.copy(self)
            for key, val in vars(self).items():
                if torch.is_tensor(val):
                    setattr(view, key, val.to(device))
            self._views[device] = view
        return self._views[device]

    # -- neighbours ----------------------------------------------------------
    def pairs(self, x, h, types, skin: float = 0.0):
        """Unordered image pairs within the largest cutoff (+ skin)."""
        return build(x, h, self.cutoff + skin,
                     Cards(self.devices or [x.device], self.block))

    # -- REBO ----------------------------------------------------------------
    def _rebo_rows(self, d, mask, ei, ej, dtype):
        """[B, K] w (VR + p_ij VA) of each directed edge, zero where it is
        not live; d [B, K, 3] in `dtype`."""
        def t(tab):
            return tab[ei[:, None], ej].to(dtype)

        rsq = torch.where(mask, (d * d).sum(-1), torch.ones_like(d[..., 0]))
        r = torch.sqrt(rsq)
        rmin, rmax = t(self.rcmin), t(self.rcmax)
        u = ((r - rmin) / (rmax - rmin)).clamp(0.0, 1.0)
        w = torch.where(mask, 0.5 * (1.0 + torch.cos(math.pi * u)),
                        torch.zeros_like(r))
        ejf = ej.to(dtype)
        nM = (w * (1.0 - ejf)).sum(1)
        nS = (w * ejf).sum(1)
        VR = w * (1.0 + t(self.Q) / r) * t(self.A) * torch.exp(
            -t(self.alpha) * r)
        VA = -w * t(self.BIJc) * torch.exp(-t(self.Beta) * r)
        cos = (d[:, :, None, :] * d[:, None, :, :]).sum(-1) / (
            r[:, :, None] * r[:, None, :])
        # the value clamped to [-1, 1], the derivative of the raw cosine
        cos = cos + (cos.clamp(-1.0, 1.0) - cos).detach()
        b = self.b[ei].to(dtype)[:, None, None, :]
        bg = self.bg[ei].to(dtype)[:, None, None, :]
        gcos = sum(b[..., k] * cos ** k for k in range(7))
        gam = sum(bg[..., k] * cos ** k for k in range(7))
        psi = 0.5 * (1.0 - torch.cos(2.0 * math.pi * (cos - 0.5)))
        g = torch.where(cos >= 0.5, gcos + psi * (gam - gcos), gcos)
        K = mask.shape[1]
        eye = torch.eye(K, dtype=torch.bool, device=mask.device)
        km = mask[:, None, :] & ~eye
        etmp = torch.where(km, w[:, None, :] * g, torch.zeros_like(g)).sum(2)
        a = self.a[ei].to(dtype)
        N = nM + nS
        P = -a[:, 0] * (N - 1.0) - a[:, 1] * torch.exp(-a[:, 2] * N) + a[:, 3]
        pij = torch.rsqrt(1.0 + etmp + P[:, None])
        live = mask & (w > TOL)
        return torch.where(live, VR + pij * VA, torch.zeros_like(VR))

    def _vlj(self, r, ei, ej, dtype):
        t = lambda tab: tab[ei, ej].to(dtype)  # noqa: E731
        sig, eps = t(self.sigma), t(self.eps)
        lo, hi = t(self.ljmin), t(self.ljmax)
        sr6 = (sig / r) ** 6
        v126 = 4.0 * eps * sr6 * (sr6 - 1.0)
        # below 0.95 sigma a cubic ramp from rcLJmin, C1 at 0.95 sigma
        r6c = (1.0 / 0.95) ** 6
        vdw = 4.0 * eps * r6c * (r6c - 1.0)
        dvdw = (-4.0 * eps / (0.95 * sig)) * r6c * (12.0 * r6c - 6.0)
        drw = 0.95 * sig - lo
        c2 = ((3.0 / drw) * vdw - dvdw) / drw
        c3 = (vdw / (drw * drw) - c2) / drw
        dr = r - lo
        ramp = dr * dr * (dr * c3 + c2)
        v = torch.where(r >= 0.95 * sig, v126, ramp)
        return torch.where((r > hi) | (r < lo), torch.zeros_like(r), v)

    def energy_forces(self, x, h, types, pairs, dtype=torch.float64):
        """(E, F [N, 3] float64) at positions x (float64) from the image
        pairs of `pairs` (any superset of those within the cutoffs)."""
        out = self.evaluate(x, h, types, pairs, dtype)
        return out["e"], out["f"]

    def evaluate(self, x, h, types, pairs, dtype=torch.float64,
                 tallies: bool = False) -> dict:
        """e, f and, with `tallies`, the per-atom eatom [N] and vatom [N, 6]
        (float64) under ev_tally's half-half split: each directed REBO
        edge's 1/2 w (VR + p_ij VA) and virial -(d (x) dE/dd) half to its
        centre and half to its neighbour, each LJ pair's V and virial half
        to each end.  eatom sums to e, vatom to the virial W.  On the
        first card."""
        cards = pairs.cards
        n = x.shape[0]
        views = [self._at(d) for d in cards.devices]

        def lj_tier(k, dev):
            """Card k's sums of the LJ tier over its pair blocks, and their
            REBO edges (the pairs inside rcmax) as (i, j, code)."""
            p, acc = views[k], Sums(n, dev, tallies)
            xk, hk = x.to(dev), h.to(device=dev, dtype=torch.float64)
            el = p.elem[types.to(dev)]
            edges = []
            for blk, i, j, d in pairs.on_card(k, xk, hk):
                ei, ej = el[i], el[j]
                r = torch.linalg.norm(d, dim=1)
                keep = r < p.rcmax[ei, ej]
                edges.append(tuple(t[keep] for t in blk))
                near = (r >= (1.0 - LJ_MARGIN) * p.ljmin[ei, ej]) & (
                    r <= (1.0 + LJ_MARGIN) * p.ljmax[ei, ej])
                ii, jj = i[near], j[near]
                dd = d[near].to(dtype).detach().requires_grad_(True)
                rr = torch.sqrt((dd * dd).sum(1))
                v = p._vlj(rr, ei[near], ej[near], dtype)
                e = v.sum()
                (g,) = torch.autograd.grad(e, dd)
                acc.pairs(ii, jj, e, v, dd, g.double())
            return acc, edges

        parts = cards.run(lj_tier)
        sums = [acc for acc, _ in parts]
        edges = [e for _, card in parts for e in card]
        # the REBO edges of every card, in card order, as rows on the first
        dev0 = cards.devices[0]
        nbr, codes = directed(*(torch.cat([e[m].to(dev0) for e in edges])
                                for m in range(3)), n)
        K = nbr.shape[1]
        rows = max(1, cards.block // (K * K))

        def rebo_rows(k, dev):
            """Card k's share of the REBO rows, `rows` at a time."""
            p, acc = views[k], sums[k]
            xk, hk = x.to(dev), h.to(device=dev, dtype=torch.float64)
            el = p.elem[types.to(dev)]
            lift, table = pairs.lift.to(dev), shift_table(dev)
            lo, hi = cards.share(n, k)
            nbr_k, codes_k = nbr[lo:hi].to(dev), codes[lo:hi].to(dev)
            for r0 in range(lo, hi, rows):
                r1 = min(r0 + rows, hi)
                nb = nbr_k[r0 - lo:r1 - lo].long()
                mask = nb >= 0
                jn = torch.where(mask, nb, torch.zeros_like(nb))
                sh = (table[codes_k[r0 - lo:r1 - lo].long()] + lift[jn]
                      - lift[r0:r1, None, :])
                sh = torch.where(mask[..., None], sh, torch.zeros_like(sh))
                dd = (xk[jn] + sh.to(torch.float64) @ hk
                      - xk[r0:r1, None, :])
                dd = dd.to(dtype).detach().requires_grad_(True)
                per_edge = 0.5 * p._rebo_rows(dd, mask, el[r0:r1], el[jn],
                                              dtype)
                e = per_edge.sum()
                (g,) = torch.autograd.grad(e, dd)
                g = torch.where(mask[..., None], g,
                                torch.zeros_like(g)).double()
                acc.rows(r0, jn, e, per_edge, dd, g)

        cards.run(rebo_rows)
        return Sums.total(cards, sums)

    # -- the work the kernels need, from the physics ---------------------------
    def counts(self, x, h, types, pairs) -> dict:
        """Directed REBO edges inside rcmax, unordered pairs of one atom's
        edges, and ordered pairs inside the LJ window [rcLJmin, rcLJmax]."""
        cards = pairs.cards
        n = x.shape[0]
        views = [self._at(d) for d in cards.devices]

        def count(k, dev):
            p = views[k]
            xk, hk = x.to(dev), h.to(device=dev, dtype=torch.float64)
            el = p.elem[types.to(dev)]
            deg = torch.zeros(n, dtype=torch.int64, device=dev)
            win = torch.zeros((), dtype=torch.int64, device=dev)
            for _, i, j, d in pairs.on_card(k, xk, hk):
                r = torch.linalg.norm(d, dim=1)
                ei, ej = el[i], el[j]
                rebo = r < p.rcmax[ei, ej]
                deg += torch.bincount(torch.cat([i[rebo], j[rebo]]),
                                      minlength=n)
                win += ((r >= p.ljmin[ei, ej])
                        & (r <= p.ljmax[ei, ej])).sum()
            return deg, win

        parts = cards.run(count)
        deg = cards.total([p[0] for p in parts]).double()
        win = cards.total([p[1] for p in parts])
        return dict(atoms=n, rebo_edges=float(deg.sum()),
                    rebo_edge_pairs=float((deg * (deg - 1) / 2).sum()),
                    lj_window_pairs=2.0 * float(win))

