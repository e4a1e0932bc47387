"""Image pairs within a cutoff in a periodic triclinic box, by cell lists,
kept and used by blocks.

Plain PyTorch, independent of the program under test.  Atoms are binned
on fractional coordinates into cells whose perpendicular widths are at
least the cutoff, so every pair within the cutoff lies in the same cell
or in one of its 26 neighbours.  The half shell of 13 neighbour offsets
plus the pairs a < b of each cell itself gives every unordered image pair
once, even where a dimension holds only one or two cells (the shifts of
offsets +1 and -1 then differ).

A list keeps 9 bytes a pair, in blocks of at most `Cards.block` pairs on
the card that found them: i and j (int32) and a code of the 27 cell
shifts (uint8).  A pair's image shift is its cell shift plus the
difference of its atoms' `lift`, the shift of each atom's wrapped copy
when the list was built.  No tensor spans the whole list, and a chunk of
the search holds at most `block` candidate pairs.  Each card searches a
fixed share of the cells, and later evaluates the blocks it found.
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

#: pairs of one block, candidate pairs of one search chunk, rows x
#: neighbours^2 of one REBO block
BLOCK_PAIRS = 2 ** 24

HALF_SHELL = [o for o in itertools.product((-1, 0, 1), repeat=3)
              if (o[2], o[1], o[0]) > (0, 0, 0)]
#: a cell shift's code: (sx + 1) + 3 (sy + 1) + 9 (sz + 1); -s has 26 - code
_CODE_WEIGHTS = (1, 3, 9)


def shift_table(device) -> torch.Tensor:
    """[27, 3] int64: the cell shift of each code."""
    c = torch.arange(27, device=device)
    return torch.stack([c % 3, c // 3 % 3, c // 9], 1) - 1


class Cards:
    """The devices a reference spreads its blocks over, in card order,
    and the size of one block."""

    def __init__(self, devices, block: int = BLOCK_PAIRS):
        self.devices = [torch.device(d) for d in devices]
        self.block = int(block)

    def run(self, fn) -> list:
        """[fn(k, device) for each card k], each card's in a thread of its
        own where there are several (so that one card's waits do not
        hold the others); the results in card order."""
        if len(self.devices) == 1:
            return [fn(0, self.devices[0])]
        with ThreadPoolExecutor(len(self.devices)) as ex:
            futures = [ex.submit(fn, k, d)
                       for k, d in enumerate(self.devices)]
            return [f.result() for f in futures]

    def share(self, n: int, k: int):
        """Card k's fixed share [lo, hi) of n items."""
        D = len(self.devices)
        return n * k // D, n * (k + 1) // D

    def total(self, parts):
        """The sum of per-card tensors on the first card, in card order."""
        out = parts[0]
        for p in parts[1:]:
            out = out + p.to(out.device)
        return out


@dataclass
class PairList:
    """Unordered image pairs: per card, blocks (i int32, j int32, code
    uint8); `lift` [N, 3] int64 on the first card."""

    cards: Cards
    blocks: list
    lift: torch.Tensor

    def __len__(self) -> int:
        return sum(len(b[0]) for card in self.blocks for b in card)

    def on_card(self, k: int, x, h):
        """Card k's blocks with their pairs as (block, i, j, d): i and j
        int64, d = x[j] + s @ h - x[i] float64 [b, 3], where x and h are
        on card k."""
        dev = x.device
        lift = self.lift.to(dev)
        table = shift_table(dev)
        for blk in self.blocks[k]:
            i, j = blk[0].long(), blk[1].long()
            s = table[blk[2].long()] + lift[j] - lift[i]
            yield blk, i, j, x[j] + s.to(torch.float64) @ h - x[i]

    def expand(self):
        """(i, j, s): int64 [P], [P], [P, 3] on the first card, every
        card's blocks in order (for small lists and tests)."""
        dev = self.cards.devices[0]
        table = shift_table(dev)
        blks = [[t.to(dev) for t in b] for card in self.blocks
                for b in card]
        if not blks:
            z = torch.zeros(0, dtype=torch.int64, device=dev)
            return z, z, torch.zeros((0, 3), dtype=torch.int64, device=dev)
        i, j, c = (torch.cat([b[n] for b in blks]).long() for n in range(3))
        return i, j, table[c] + self.lift[j] - self.lift[i]


class _Blocks:
    """Pairs written into blocks of `size`, each allocated once."""

    def __init__(self, size: int, device):
        self.size, self.device = size, device
        self.full, self.cur, self.n = [], None, 0

    def add(self, i, j, code):
        at = 0
        while at < len(i):
            if self.cur is None:
                self.cur = tuple(
                    torch.empty(self.size, dtype=t, device=self.device)
                    for t in (torch.int32, torch.int32, torch.uint8))
                self.n = 0
            take = min(len(i) - at, self.size - self.n)
            for dst, src in zip(self.cur, (i, j, code)):
                dst[self.n:self.n + take] = src[at:at + take]
            self.n += take
            at += take
            if self.n == self.size:
                self.full.append(self.cur)
                self.cur = None

    def done(self) -> list:
        if self.cur is not None and self.n:
            self.full.append(tuple(t[:self.n].clone() for t in self.cur))
        self.cur = None
        return self.full


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


def build(x: torch.Tensor, h: torch.Tensor, cutoff: float,
          cards: Cards) -> PairList:
    """Unordered image pairs closer than `cutoff`: |x[j] + s @ h - x[i]|
    < cutoff.  x is float64 [N, 3] anywhere in space; h the box rows."""
    dev0 = cards.devices[0]
    x = x.to(device=dev0, dtype=torch.float64)
    h = h.to(device=dev0, dtype=torch.float64)
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
    slot = torch.arange(len(x), device=dev0) - starts[flat[order]]
    table = torch.full((ncells, C), -1, dtype=torch.int64, device=dev0)
    table[flat[order], slot] = order
    cells = torch.arange(ncells, device=dev0)
    cc = torch.stack([cells % nc[0], (cells // nc[0]) % nc[1],
                      cells // (nc[0] * nc[1])], 1)
    xpad = torch.cat([xw, xw.new_zeros((1, 3))])
    cut2 = cutoff * cutoff
    step = max(1, cards.block // (C * C))

    def search(k, dev):
        lo, hi = cards.share(ncells, k)
        tab, xp, ncd, hd = (t.to(dev) for t in (table, xpad, nc, h))
        ccd = cc[lo:hi].to(dev)
        weights = torch.tensor(_CODE_WEIGHTS, device=dev)
        upper = torch.triu(torch.ones(C, C, dtype=torch.bool, device=dev), 1)
        out = _Blocks(cards.block, dev)
        for o in [(0, 0, 0)] + HALF_SHELL:
            nb = ccd + torch.tensor(o, dtype=torch.int64, device=dev)
            shift = torch.div(nb, ncd, rounding_mode="floor")
            nb = nb - shift * ncd
            nflat = (nb[:, 2] * ncd[1] + nb[:, 1]) * ncd[0] + nb[:, 0]
            svec = shift.to(torch.float64) @ hd
            code = ((shift + 1) * weights).sum(1).to(torch.uint8)
            for c0 in range(0, hi - lo, step):
                c1 = min(c0 + step, hi - lo)
                a = tab[lo + c0:lo + c1]
                b = tab[nflat[c0:c1]]
                d = (xp[b][:, None, :, :] + svec[c0:c1, None, None, :]
                     - xp[a][:, :, None, :])
                r2 = (d * d).sum(-1)
                ok = (a[:, :, None] >= 0) & (b[:, None, :] >= 0) & \
                    (r2 < cut2)
                if o == (0, 0, 0):
                    ok &= upper
                blk, sa, sb = torch.nonzero(ok, as_tuple=True)
                out.add(a[blk, sa], b[blk, sb], code[c0 + blk])
        return out.done()

    return PairList(cards, cards.run(search), lift)


def image_pairs(x: torch.Tensor, h: torch.Tensor, cutoff: float):
    """The pairs of `build` on x's device as (i, j, shift): int64 [P],
    [P] and [P, 3]."""
    return build(x, h, cutoff, Cards([x.device])).expand()


def directed(i, j, code, n: int):
    """Per-atom rows of the pairs (i, j, code) in both directions: (nbr
    [n, K] int32 atom ids, -1 where empty; [n, K] uint8 the cell shift's
    code from the row's atom to its neighbour)."""
    dev = i.device
    ii = torch.cat([i, j]).long()
    jj = torch.cat([j, i])
    cc = torch.cat([code, 26 - code])
    order = torch.argsort(ii, stable=True)
    ii, jj, cc = ii[order], jj[order], cc[order]
    counts = torch.bincount(ii, minlength=n)
    K = max(1, int(counts.max()) if len(ii) else 1)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(ii), device=dev) - starts[ii]
    nbr = torch.full((n, K), -1, dtype=torch.int32, device=dev)
    codes = torch.zeros((n, K), dtype=torch.uint8, device=dev)
    nbr[ii, slot] = jj.to(torch.int32)
    codes[ii, slot] = cc
    return nbr, codes
