"""The plain reference by blocks over cards equals the one-shot reference
it replaced, which is kept here as the oracle: the same pair sets and
counts, and E, F, eatom and vatom within 1e-12 relative, under both list
rules, with blocks forced tiny and over two "cards" of the CPU.  Its
memory grows by under 60 B a pair.  The bulk scene is the program's."""

import json
import os
import subprocess
import sys

import pytest
import torch

import harness as H
import run as R
from integrate import EXACT_SKIN, UNITS, Integrator, MDState
from ljcut import LJCut
from neighbors import HALF_SHELL, perpendicular_widths, wrap
from rebomos import REBOMoS
from tally import edge_halves, pair_halves

PARAMS = os.path.join(H.ROOT, "mdbench", "configs", "MoS.REBO.synthetic")
F64 = dict(dtype=torch.float64, device="cpu")
REL = 1e-12
SEED = 2 ** 31 + 19


# -- the oracle: the one-shot reference, every pair at once --------------------
def oneshot_image_pairs(x, h, cutoff):
    """(i, j, shift) int64 of every unordered image pair closer than
    cutoff, concatenated from the cell search's chunks."""
    x = x.to(torch.float64)
    h = h.to(torch.float64)
    dev = x.device
    xw, f = wrap(x, h)
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
    out_i, out_j, out_s = [], [], []
    step = max(1, 2 ** 26 // (C * C))
    upper = torch.triu(torch.ones(C, C, dtype=torch.bool, device=dev), 1)
    for o in [(0, 0, 0)] + HALF_SHELL:
        nb = cc + torch.tensor(o, dtype=torch.int64, device=dev)
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
            ok = (a[:, :, None] >= 0) & (b[:, None, :] >= 0) & (
                (d * d).sum(-1) < cutoff * cutoff)
            if o == (0, 0, 0):
                ok &= upper
            blk, sa, sb = torch.nonzero(ok, as_tuple=True)
            out_i.append(a[blk, sa])
            out_j.append(b[blk, sb])
            out_s.append(shift[c0 + blk])
    i, j = torch.cat(out_i), torch.cat(out_j)
    return i, j, torch.cat(out_s) + lift[j] - lift[i]


def oneshot_directed_lists(i, j, s, n):
    ii, jj, ss = torch.cat([i, j]), torch.cat([j, i]), torch.cat([s, -s])
    order = torch.argsort(ii, stable=True)
    ii, jj, ss = ii[order], jj[order], ss[order]
    counts = torch.bincount(ii, minlength=n)
    K = max(1, int(counts.max()) if len(ii) else 1)
    slot = torch.arange(len(ii), device=ii.device) - (
        torch.cumsum(counts, 0) - counts)[ii]
    nbr = torch.full((n, K), -1, dtype=torch.int64, device=ii.device)
    shift = torch.zeros((n, K, 3), dtype=torch.int64, device=ii.device)
    nbr[ii, slot] = jj
    shift[ii, slot] = ss
    return nbr, shift


class OneShotREBOMoS(REBOMoS):
    """REBOMoS with every pair's displacement formed at once, the REBO
    rows in blocks of 2^16 and the LJ tier over every listed pair."""

    def pairs(self, x, h, types, skin=0.0):
        return oneshot_image_pairs(x, h, self.cutoff + skin)

    def evaluate(self, x, h, types, pairs, dtype=torch.float64,
                 tallies=False):
        i, j, s = pairs
        n = x.shape[0]
        h = h.to(torch.float64)
        el = self.elem[types]
        f64 = dict(dtype=torch.float64, device=x.device)
        F, E = torch.zeros((n, 3), **f64), torch.zeros((), **f64)
        eat = torch.zeros(n, **f64) if tallies else None
        vat = torch.zeros((n, 6), **f64) if tallies else None
        d = x[j] + s.to(torch.float64) @ h - x[i]
        r = torch.linalg.norm(d, dim=1)
        keep = r < self.rcmax[el[i], el[j]]
        nbr, sh = oneshot_directed_lists(i[keep], j[keep], s[keep], n)
        for r0 in range(0, n, 2 ** 16):
            r1 = min(r0 + 2 ** 16, n)
            nb = nbr[r0:r1]
            mask = nb >= 0
            jn = torch.where(mask, nb, torch.zeros_like(nb))
            dd = (x[jn] + sh[r0:r1].to(torch.float64) @ h
                  - x[r0:r1, None, :])
            dd = dd.to(dtype).detach().requires_grad_(True)
            per_edge = 0.5 * self._rebo_rows(dd, mask, el[r0:r1], el[jn],
                                             dtype)
            e = per_edge.sum()
            (g,) = torch.autograd.grad(e, dd)
            g = torch.where(mask[..., None], g, torch.zeros_like(g)).double()
            F[r0:r1] += g.sum(1)
            F.index_add_(0, jn.reshape(-1), -g.reshape(-1, 3))
            E = E + e.detach().double()
            if tallies:
                edge_halves(eat, vat, r0, jn, per_edge.detach().double(),
                            dd.detach().double(), g)
        for p0 in range(0, len(i), 2 ** 24):
            p1 = min(p0 + 2 ** 24, len(i))
            ii, jj = i[p0:p1], j[p0:p1]
            dd = d[p0:p1].to(dtype).detach().requires_grad_(True)
            v = self._vlj(torch.sqrt((dd * dd).sum(1)), el[ii], el[jj],
                          dtype)
            e = v.sum()
            (g,) = torch.autograd.grad(e, dd)
            g = g.double()
            F.index_add_(0, ii, g)
            F.index_add_(0, jj, -g)
            E = E + e.detach().double()
            if tallies:
                pair_halves(eat, vat, ii, jj, v.detach().double(),
                            dd.detach().double(), g)
        return dict(e=E, f=F, eatom=eat, vatom=vat)

    def counts(self, x, h, types, pairs):
        i, j, s = pairs
        el = self.elem[types]
        d = x[j] + s.to(torch.float64) @ h.to(torch.float64) - x[i]
        r = torch.linalg.norm(d, dim=1)
        ei, ej = el[i], el[j]
        rebo = r < self.rcmax[ei, ej]
        n = torch.bincount(torch.cat([i[rebo], j[rebo]]),
                           minlength=x.shape[0]).double()
        win = (r >= self.ljmin[ei, ej]) & (r <= self.ljmax[ei, ej])
        return dict(atoms=x.shape[0], rebo_edges=float(n.sum()),
                    rebo_edge_pairs=float((n * (n - 1) / 2).sum()),
                    lj_window_pairs=2.0 * float(win.sum()))


class OneShotLJCut(LJCut):
    def pairs(self, x, h, types, skin=0.0):
        return oneshot_image_pairs(x, h, self.cutoff + skin)

    def evaluate(self, x, h, types, pairs, dtype=torch.float64,
                 tallies=False):
        i, j, s = pairs
        h = h.to(torch.float64)
        f64 = dict(dtype=torch.float64, device=x.device)
        F, E = torch.zeros_like(x, dtype=torch.float64), torch.zeros((),
                                                                   **f64)
        eat = torch.zeros(x.shape[0], **f64) if tallies else None
        vat = torch.zeros((x.shape[0], 6), **f64) if tallies else None
        for p0 in range(0, len(i), 2 ** 24):
            p1 = min(p0 + 2 ** 24, len(i))
            ii, jj = i[p0:p1], j[p0:p1]
            d = x[jj] + s[p0:p1].to(torch.float64) @ h - x[ii]
            inside = (d * d).sum(1) < self.cutoff * self.cutoff
            ii, jj = ii[inside], jj[inside]
            d = d[inside].to(dtype).detach().requires_grad_(True)
            sr6 = (self.sigma * self.sigma / (d * d).sum(1)) ** 3
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

    def counts(self, x, h, types, pairs):
        i, j, s = pairs
        d = x[j] + s.to(torch.float64) @ h.to(torch.float64) - x[i]
        inside = (d * d).sum(1) < self.cutoff * self.cutoff
        return dict(atoms=x.shape[0], ljcut_pairs=float(inside.sum()))


# -- scenes --------------------------------------------------------------------
def jiggled(x, amp, seed):
    g = torch.Generator().manual_seed(seed)
    return x + amp * (torch.rand(x.shape, generator=g, **F64) - 0.5)


def triclinic(n, seed):
    """A simple lattice of n^3 atoms in a strongly tilted box, jiggled and
    moved out of the box by whole box vectors."""
    h = torch.tensor([[1.3, 0.0, 0.0], [0.55, 1.2, 0.0], [-0.4, 0.35, 1.25]],
                     **F64) * n
    r = torch.arange(n, **F64)
    f = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3) / n
    x = jiggled(f @ h, 0.2, seed)
    g = torch.Generator().manual_seed(seed + 1)
    lift = torch.randint(-2, 3, x.shape, generator=g).to(torch.float64)
    return x + lift @ h, torch.ones(len(x), dtype=torch.int64), h


SCENES = {
    # (style, scene, skin); the grids in cells of cutoff + skin per side
    "mono": ("rebomos", lambda: H.find("scenes", "mos2_monolayer").make(
        6, 6, 20.0, "cpu"), EXACT_SKIN),              # 1 x 1 x 2
    "bulk1": ("rebomos", lambda: H.find("scenes", "mos2_bulk").make(
        3, 4, 1, "cpu"), EXACT_SKIN),                 # 1 x 1 x 1
    "bulk2": ("rebomos", lambda: H.find("scenes", "mos2_bulk").make(
        8, 10, 2, "cpu"), 0.0),                       # 2 x 2 x 2
    "fcc1": ("lj", lambda: H.find("scenes", "fcc_block").make(
        3, 0.8442, "cpu"), 0.3),                      # 1 x 1 x 1
    "fcc2": ("lj", lambda: H.find("scenes", "fcc_block").make(
        4, 0.8442, "cpu"), 0.3),                      # 2 x 2 x 2
    "tri": ("lj", lambda: triclinic(7, 5), 0.3),      # 2 x 2 x 3
}


def scene(name, seed=11):
    style, make, skin = SCENES[name]
    x, types, h = make()
    if name != "tri":
        x = jiggled(x, 0.3 if style == "rebomos" else 0.15, seed)
    return style, x, types, h, skin


def potentials(style, devices=None, block=2 ** 24):
    if style == "rebomos":
        return (REBOMoS(PARAMS, ["M", "S"], devices, block),
                OneShotREBOMoS(PARAMS, ["M", "S"]))
    return LJCut(2.5, 1.0, 1.0, devices, block), OneShotLJCut(2.5, 1.0, 1.0)


def pair_set(i, j, s):
    return {min((a, b, tuple(c)), (b, a, tuple(-v for v in c)))
            for a, b, c in zip(i.tolist(), j.tolist(), s.tolist())}


def close(got, want, rel=REL):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= rel * scale


CARDS = {"one": ["cpu"], "two": ["cpu", "cpu"]}


# -- the pair list -------------------------------------------------------------
@pytest.mark.parametrize("cards", list(CARDS))
@pytest.mark.parametrize("block", [61, 2 ** 24])
@pytest.mark.parametrize("name", list(SCENES))
def test_pair_lists_equal_the_oneshot_search(name, block, cards):
    style, x, types, h, skin = scene(name)
    pot, oracle = potentials(style, CARDS[cards], block)
    pairs = pot.pairs(x, h, types, skin)
    want = oracle.pairs(x, h, types, skin)
    i, j, s = pairs.expand()
    assert len(pairs) == len(want[0]) == len(i) > 0
    assert pair_set(i, j, s) == pair_set(*want)
    blocks = [b for card in pairs.blocks for b in card]
    assert all(len(b[0]) <= block for b in blocks)
    assert all(b[0].dtype == torch.int32 and b[2].dtype == torch.uint8
               for b in blocks)
    if block < 100:
        assert len(blocks) >= 24
    assert len(pairs.blocks) == len(CARDS[cards])


@pytest.mark.parametrize("cards", list(CARDS))
@pytest.mark.parametrize("block", [61, 2 ** 24])
@pytest.mark.parametrize("name", list(SCENES))
def test_sums_and_counts_equal_the_oneshot_reference(name, block, cards):
    """E, F, eatom and vatom within 1e-12 relative, equal counts."""
    style, x, types, h, skin = scene(name)
    pot, oracle = potentials(style, CARDS[cards], block)
    got = pot.evaluate(x, h, types, pot.pairs(x, h, types, skin),
                       tallies=True)
    pairs = oracle.pairs(x, h, types, skin)
    want = oracle.evaluate(x, h, types, pairs, tallies=True)
    for key in ("e", "f", "eatom", "vatom"):
        assert close(got[key], want[key]), key
    assert float(want["f"].abs().max()) > 1e-3
    assert pot.counts(x, h, types, pot.pairs(x, h, types, skin)) == \
        oracle.counts(x, h, types, pairs)


def test_two_cards_sum_in_card_order_on_the_first():
    """The spread gives the one card's sums, and repeats bit for bit."""
    style, x, types, h, skin = scene("bulk2")
    one = potentials(style, ["cpu"], 97)[0]
    two = potentials(style, ["cpu", "cpu"], 97)[0]
    a = one.evaluate(x, h, types, one.pairs(x, h, types, skin), tallies=True)
    b = [two.evaluate(x, h, types, two.pairs(x, h, types, skin),
                      tallies=True) for _ in range(2)]
    for key in ("e", "f", "eatom", "vatom"):
        assert close(b[0][key], a[key]), key
        assert torch.equal(b[0][key], b[1][key]), key


# -- the list rules ------------------------------------------------------------
@pytest.mark.parametrize("rule", ["exact", "every"])
@pytest.mark.parametrize("style", ["rebomos", "lj"])
def test_list_rules_follow_the_oneshot(style, rule):
    """k steps under each rule from a hot state, which under "exact"
    moves an atom past half the skin: the same rebuilds, and x, v and f
    within 1e-12 relative."""
    if style == "rebomos":
        _, x, types, h, _ = scene("bulk2")
        mass = torch.tensor([0.0, 95.95, 32.065], **F64)
        units, dt, temp, skin, k = UNITS["metal"], 0.001, 6000.0, 0.8, 12
    else:
        _, x, types, h, _ = scene("fcc2")
        mass = torch.tensor([0.0, 1.0], **F64)
        units, dt, temp, skin, k = UNITS["lj"], 0.005, 30.0, 0.3, 20
    v = H.velocities(types, mass, temp, units.boltz, units.mvv2e, 5, "cpu")
    out = []
    for pot in potentials(style, ["cpu", "cpu"],
                          4001 if style == "rebomos" else 53):
        builds = []
        pairs = pot.pairs
        pot.pairs = lambda *a, _p=pairs: builds.append(1) or _p(*a)
        integ = Integrator(pot, h, types, mass, units, dt, skin, rule)
        s, f0 = integ.follow(MDState(x=x, v=v), k)
        out.append((s, f0, len(builds)))
    (got, f0, n_got), (want, f0_want, n_want) = out
    assert n_got == n_want
    assert n_got >= 2 if rule == "exact" else n_got == 1
    assert close(f0, f0_want)
    for key in ("x", "v", "f"):
        assert close(getattr(got, key), getattr(want, key)), key


# -- memory --------------------------------------------------------------------
CHILD = r"""
import json, resource, sys
import torch
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/reference"]
import harness as H
from rebomos import REBOMoS
torch.set_num_threads(4)
x, types, h = H.find("scenes", "mos2_bulk").make(50, 30, 10, "cpu")
g = torch.Generator().manual_seed(3)
x = x + 0.2 * (torch.rand(x.shape, generator=g, dtype=torch.float64) - 0.5)
pot = REBOMoS(sys.argv[2], ["M", "S"], block=2 ** 19)
def resident():
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * resource.getpagesize()
before = resident()
pairs = pot.pairs(x, h, types, 1.0)
e, f = pot.energy_forces(x, h, types, pairs)
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
print(json.dumps(dict(atoms=len(x), pairs=len(pairs), grown=peak - before,
                      e=float(e))))
"""


def test_memory_grows_under_60_bytes_a_pair():
    """Config 5's lattice at 90,000 atoms, the list within cutoff + 1.0
    and one energy_forces, blocks of 2^19 pairs, in a child process: the
    peak resident size over the size before, per pair (the one-shot
    reference grew by ~370 B a pair)."""
    env = dict(os.environ, OMP_NUM_THREADS="4")
    out = subprocess.run([sys.executable, "-c", CHILD,
                          os.path.dirname(os.path.abspath(__file__)),
                          PARAMS], capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["atoms"] == 90000 and got["pairs"] > 1.3e7
    assert got["grown"] / got["pairs"] < 60, got


# -- the bulk scene ------------------------------------------------------------
@pytest.mark.parametrize("n", [(3, 4, 2), (5, 6, 3)])
def test_bulk_scene_is_the_programs(n):
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk_commensurate
    st = rebomos_bulk_commensurate(*n, dtype=torch.float64, device="cpu")
    x, types, h = H.find("scenes", "mos2_bulk").make(*n, "cpu")
    assert torch.equal(x, st.x)
    assert torch.equal(types, st.type.to(types.dtype))
    assert torch.equal(h, torch.tensor(st.box.h64, **F64))


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mono-nvt", "lj-nve", "mono-deck"])
def test_blocked_equals_the_oneshot_on_each_cells_start_state(name, card):
    """The cell at its own size: the program's state after its compared
    first steps, saved; both references in this process on it (the
    cell's list rule and skin, tallies), one after the other."""
    import time
    c = H.cell(H.bench_file(), name)
    cfg = c["cfg"]
    inp = H.inputs(cfg, SEED, card)
    drv = H.find("drivers", c["trf"]["driver"]).Driver(c, inp, card,
                                                        lambda s: None)
    x = drv.start(c["trf"]["check_steps"])["x"]
    drv.close()
    drv = None
    H.free_program()
    skin = EXACT_SKIN if cfg["list_rule"] == "exact" else cfg["skin"]
    pot = H.reference_potential(cfg, [torch.device(card, 0)])
    pc = cfg["pair"]
    oracle = (OneShotREBOMoS(os.path.join(H.ROOT, pc["file"]),
                             pc["elements"], card) if pc["style"] ==
              "rebomos" else OneShotLJCut(pc["cutoff"], pc["epsilon"],
                                          pc["sigma"]))
    h, types = inp["h"], inp["types"]
    res = {}
    for tag, p in (("blocked", pot), ("oneshot", oracle)):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        pairs = p.pairs(x, h, types, skin)
        ev = p.evaluate(x, h, types, pairs, tallies=True)
        counts = p.counts(x, h, types, pairs)
        torch.cuda.synchronize()
        res[tag] = (ev, counts, len(pairs if tag == "blocked" else pairs[0]),
                    time.perf_counter() - t,
                    torch.cuda.max_memory_allocated() / 2 ** 30)
        pairs = None
        H.free_program()
    (got, cg, ng, tg, mg), (want, cw, nw, tw, mw) = res["blocked"], \
        res["oneshot"]
    gaps = {key: float((got[key] - want[key]).abs().max())
            / float(want[key].abs().max()) for key in got}
    print(f"\n{name}: {len(x)} atoms, {ng} pairs; blocked {tg:.3f} s "
          f"{mg:.3f} GiB, one-shot {tw:.3f} s {mw:.3f} GiB; relative "
          f"gaps {json.dumps(gaps)}; counts {json.dumps(cg)}; "
          f"{H.power_limit()}")
    assert ng == nw and cg == cw
    assert all(g <= REL for g in gaps.values()), gaps


def test_a_cell_run_reports_the_references_seconds_and_peak():
    c = H.cell(H.bench_file(), "lj-nve")
    c["cfg"]["scene"].update(n=4)
    c["trf"].update(warmup_steps=20, rate_steps=20, chunk_steps=20)
    lines = []
    out = R.run_cell(c, H.bench_file(), SEED, 0.1, False, "cpu",
                     t_proc=H.now(), log=lines.append)
    assert out["correct"], out["checks"]
    assert any(ln.startswith("# reference: ") and "1 card(s)" in ln
               for ln in lines)
