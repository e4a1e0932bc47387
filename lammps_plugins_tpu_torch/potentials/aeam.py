"""AEAM — angular embedded-atom method for Al-Si (port of
lammps_plugins_tpu/potentials/aeam.py).

Physics from pair_aeam.cpp, as in the JAX package: one differentiable
energy

    E = sum_i F_i( rho_i ^ n_i )  +  1/2 sum_directed_edges phi(r_ij)

with
    rho_i (non-angular) = sum_j f_ij                       (cpp:204-205)
    rho_i (angular)     = sum_{j<k} 2 f_ij f_ik (cos+1/3)^2 (cpp:249)
    n_i = 1 (non-angular) or 0.5 (angular)                  (cpp:274-282)

over the padded "main" list, ghost positions being functions of the owned
ones.  Density legs use cut - 1.5 when both endpoints are angular (CutDec,
cpp:187-192, 218-223); the pair term uses the full cut (cpp:350).  The
JAX module's docstring sets out the reference's force-pass inconsistency
that force_pass_deviation bounds; for a file whose angular-angular density
is zero past cut - 1.5 (the published AlSi.aeam, and the synthetic files
of tests/data) the bound is 0.

Forces (the per-step path) take the JAX package's fast path when the
file's r-grids are symmetric: for non-angular centres the edge cotangent
is radial, so the Newton reaction of edge (j, i) onto i is computed at
edge (i, j) from one 21-wide spline-row gather [f_ij | phi | f_ji] and
F'_j; angular centres (a compacted minority, `prepare`) take exact
autograd cotangents of their embedding energy, under a local
torch.enable_grad() (the Engine's segment runs under no_grad).  Their
reaction onto the neighbours is combined in a fixed order, without float
atomics: a target-major table of the angular entries (`rebuild_tables`,
built with the lists at every rebuild; NeighborData.pair_tables) is
gathered and summed per target.  With no angular atom the angular part
is skipped; with an angular majority, or asymmetric grids without a
mirror table, forces are the autograd gradient of the energy; asymmetric
grids with the mirror table take the edge-cotangent autograd and the
mirror combine.

poly_mode=True replaces the spline-row gather by the piecewise-Chebyshev
refits of potentials/polyfit.py (an argument here; the JAX package reads
LPT_AEAM_POLY).  The JAX module's TPU-specific shapes (select chains in
place of small-table gathers, packed rows) are kept where they decide the
arithmetic, so both packages compute the same values.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..core.device import resolve
from ..neighbor.build import NeighborData
from ..neighbor.neighbor import edge_components, mirror_combine
from ..registry import register_pair_style
from .base import (PairStyle, edge_targets, edge_virial_peratom,
                   target_table)
from .spline import make_spline
from .tables import AEAMTables, read_aeam

MINRHO = 1.0e-13      # pair_aeam.cpp:128
CUTDEC = 1.5          # pair_aeam.cpp:188
#: NeighborData.pair_tables key of the angular reaction table
REACT_KEY = "aeam:react"


def _pair_tables(nel, t):
    """Spline coefficients in float64 numpy: rhor [nel^2, nr+1, 7] with
    its per-table knot counts and inverse spacings, z2r [nz2r, nr+1, 7]
    on the same grids with z2r_map [nel, nel], frho [nel, nrho+1, 7]
    with its knot counts and inverse spacings."""
    nrmax = int(t.nr.max())
    nrhomax = int(t.nrho.max())
    rhor = np.zeros((nel * nel, nrmax + 1, 7))
    rhor_nr = np.zeros(nel * nel, np.int64)
    rhor_rdr = np.zeros(nel * nel)
    for i in range(nel):
        for j in range(nel):
            k = i * nel + j
            rhor[k, :t.nr[i, j] + 1] = make_spline(
                t.rhor[i][j], int(t.nr[i, j]), float(t.dr[i, j]))
            rhor_nr[k] = t.nr[i, j]
            rhor_rdr[k] = 1.0 / t.dr[i, j]
    # z2r (= phi, unscaled: pair_aeam.cpp:369) lower-triangular tables
    z2r = np.zeros((nel * (nel + 1) // 2, nrmax + 1, 7))
    z2r_map = np.zeros((nel, nel), np.int64)
    n = 0
    for i in range(nel):
        for j in range(i + 1):
            z2r[n, :t.nr[i, j] + 1] = make_spline(
                t.z2r[(i, j)], int(t.nr[i, j]), float(t.dr[i, j]))
            z2r_map[i, j] = z2r_map[j, i] = n
            n += 1
    frho = np.zeros((nel, nrhomax + 1, 7))
    frho_n = np.zeros(nel, np.int64)
    frho_rdrho = np.zeros(nel)
    for i in range(nel):
        frho[i, :t.nrho[i] + 1] = make_spline(
            t.frho[i], int(t.nrho[i]), float(t.drho[i]))
        frho_n[i] = t.nrho[i]
        frho_rdrho[i] = 1.0 / t.drho[i]
    return rhor, rhor_nr, rhor_rdr, z2r, z2r_map, frho, frho_n, frho_rdrho


def _ang_density(fw, dx, dy, dz, r, not_diag):
    """sum_{j<k} 2 f f (cos + 1/3)^2 as the ordered sum over j != k, per
    row of [R, K] edge data."""
    dots = (dx[:, :, None] * dx[:, None, :] + dy[:, :, None] * dy[:, None, :]
            + dz[:, :, None] * dz[:, None, :])
    cs = dots / (r[:, :, None] * r[:, None, :])
    ftet = (cs + 1.0 / 3.0) ** 2
    pw = fw[:, :, None] * fw[:, None, :] * torch.where(not_diag, 1.0, 0.0)
    return torch.sum(pw * ftet, dim=(1, 2))


@register_pair_style("aeam")
class AEAM(PairStyle):
    """pair_style aeam — see module docstring."""

    def __init__(self, tables: AEAMTables, typemap, dtype=torch.float32,
                 device="cuda", poly_mode: bool = False):
        """typemap: 1-based atom type -> element index of the file (-1 =
        NULL), index 0 unused."""
        self.tables = tables
        self.typemap_np = np.asarray(typemap, dtype=np.int64)
        self.dtype = dtype
        self.device = resolve(device)
        self.poly_mode = bool(poly_mode)
        t = tables
        nel = t.nelements
        self.nel = nel
        self.nnonangular = t.nnonangular
        (rhor, rhor_nr, rhor_rdr, z2r, z2r_map, frho, frho_n,
         frho_rdrho) = _pair_tables(nel, t)
        as_d = lambda v: torch.as_tensor(  # noqa: E731
            np.asarray(v, np.float64), dtype=dtype, device=self.device)
        as_i = lambda v: torch.as_tensor(  # noqa: E731
            np.asarray(v, np.int64), device=self.device)
        nrmax = int(t.nr.max())
        self.frho_spline = as_d(frho)
        self.frho_n = as_i(frho_n)
        self.frho_rdrho = as_d(frho_rdrho)
        self.typemap = as_i(self.typemap_np)
        # flat [T * (nr + 1), 7] spline rows and the static per-table
        # scalars of the select chains (_sel_tab)
        self.rhor_flat = as_d(rhor.reshape(-1, 7))
        self.rhor_stride = nrmax + 1
        self.rhor_rdr_np = rhor_rdr
        self.rhor_nr_np = rhor_nr
        self.cut_np = np.asarray(t.cut, np.float64)
        self._ang_sel = None
        # fused [rhor | z2r] rows: both tables live on the (i, j) pair's r
        # grid, so one 14-wide row gather serves f_ij and phi_ij
        pairrows = np.zeros((nel * nel, nrmax + 1, 14))
        for i in range(nel):
            for j in range(nel):
                k = i * nel + j
                pairrows[k, :, 0:7] = rhor[k]
                pairrows[k, :, 7:14] = z2r[z2r_map[i, j]]
        self.pair_flat = as_d(pairrows.reshape(-1, 14))
        # 21-wide rows of the fast force path, [rhor_ij | z2r | rhor_ji]:
        # the reverse density spline rides the same gather, possible when
        # the r-grids are per unordered pair (dr[i, j] == dr[j, i])
        self._sym_grids = bool(np.allclose(t.dr, t.dr.T)
                               and np.array_equal(t.nr, t.nr.T))
        if self._sym_grids:
            rows21 = np.zeros((nel * nel, nrmax + 1, 21))
            rows21[:, :, :14] = pairrows
            for i in range(nel):
                for j in range(nel):
                    rows21[i * nel + j, :, 14:21] = rhor[j * nel + i]
            self.pair_flat21 = as_d(rows21.reshape(-1, 21))
        self.poly = None
        # the bilinear combine of _poly_pair_terms is exact only for element
        # codes in {0, 1}, and the refits need per-unordered-pair grids
        if self.poly_mode and (nel > 2 or not self._sym_grids):
            self.poly_mode = False
        if self.poly_mode:
            from .polyfit import fit_aeam_polys
            self.poly = fit_aeam_polys(t, rhor, z2r, z2r_map)

    def prepare(self, types_np: np.ndarray) -> None:
        """The angular-centre index set (static per system).  The angular
        density is O(K^2) per centre but only angular elements need it
        (pair_aeam.cpp:208); compaction pays when they are a minority.
        A sharded view (for_sharded) keeps only the empty set of a system
        without angular atoms, which indexes no row."""
        el = self.typemap_np[np.asarray(types_np)]
        sel = np.nonzero(el >= self.nnonangular)[0]
        keep = (sel.size == 0 if getattr(self, "_no_compact", False)
                else sel.size < 0.5 * len(types_np))
        self._ang_sel = (torch.as_tensor(sel, dtype=torch.int64,
                                         device=self.device)
                         if keep else None)

    def for_sharded(self) -> "AEAM":
        """A view for the sharded engine (JAX aeam.py:199): the angular
        row set indexes the global rows, not a shard's local block, so it
        is dropped; the energy takes the masked full-K^2 angular branch
        and the forces plain autograd, both free of any row set."""
        view = copy.copy(self)
        view._ang_sel = None
        view._no_compact = True
        return view

    @classmethod
    def from_file(cls, path: str, elements, dtype=torch.float32,
                  device="cuda", poly_mode: bool = False):
        """elements: per 1-based atom type, names matching the file's
        element order (pair_aeam.cpp:568-572)."""
        t = read_aeam(path)
        tmap = np.full(len(elements) + 1, -1, dtype=np.int64)
        for i, el in enumerate(elements, start=1):
            if el == "NULL":
                continue
            if el not in t.elements:
                raise ValueError(f"No matching element {el!r} in AEAM file "
                                 f"(has {t.elements})")
            tmap[i] = t.elements.index(el)
        return cls(t, tmap, dtype=dtype, device=device, poly_mode=poly_mode)

    @property
    def masses(self) -> np.ndarray:
        """Per-type masses from the file (pair_aeam.cpp:588 set_mass)."""
        out = [0.0]
        for i in range(1, len(self.typemap_np)):
            el = self.typemap_np[i]
            out.append(float(self.tables.mass[el]) if el >= 0 else 0.0)
        return np.asarray(out)

    def neighbor_requests(self):
        ntypes = len(self.typemap_np) - 1
        cut = np.zeros((ntypes + 1, ntypes + 1))
        for i in range(1, ntypes + 1):
            for j in range(1, ntypes + 1):
                ei, ej = self.typemap_np[i], self.typemap_np[j]
                if ei >= 0 and ej >= 0:
                    cut[i, j] = self.tables.cut[ei, ej]
        return {"main": cut}

    @property
    def mirror_tiers(self):
        """The mirror table only where forces read it: the fast path
        (symmetric grids) never does."""
        return () if self._sym_grids else ("main",)

    # ------------------------------------------------------------------
    def _sel_tab(self, tab, values):
        """Per-edge scalar from static per-table values via a select chain."""
        out = torch.full(tab.shape, float(values[0]), dtype=self.dtype,
                         device=tab.device)
        for t_ in range(1, len(values)):
            out = torch.where(tab == t_, float(values[t_]), out)
        return out

    def _jel(self, nlist, el_all):
        """Per-edge neighbour element from the rebuild-time jtype cache."""
        if nlist.jtype is None:
            return el_all[nlist.idx]
        out = torch.zeros_like(nlist.jtype)
        for t_ in range(1, len(self.typemap_np)):
            out = torch.where(nlist.jtype == t_, int(self.typemap_np[t_]),
                              out)
        return out

    def _knots(self, tab, arg):
        """(row index into the flat tables, p) of the cubic at `arg`, with
        the straight-through clamp p -> min(p, 1)."""
        p_raw = arg * self._sel_tab(tab, self.rhor_rdr_np) + 1.0
        n = self._sel_tab(tab, self.rhor_nr_np).to(torch.int64)
        m = torch.minimum(torch.floor(p_raw).to(torch.int64), n - 1)
        p = p_raw - m
        return tab * self.rhor_stride + m, \
            p + (torch.clamp(p, max=1.0) - p).detach()

    def _rhor(self, ei, ej, r):
        """Density-contribution spline f_ij(r) (value; autograd = f')."""
        tab = (ei * self.nel + ej).expand(r.shape)
        row, p = self._knots(tab, r)
        c = self.rhor_flat[row]
        return ((c[..., 3] * p + c[..., 4]) * p + c[..., 5]) * p + c[..., 6]

    def _cut_ij(self, ei, ej, shape):
        pairtab = (ei * self.nel + ej).expand(shape)
        return self._sel_tab(pairtab, self.cut_np.reshape(-1))

    def _embed(self, ei, p_arg):
        """Embedding F(p) per element (m clamped to [1, n-1], cpp:286)."""
        n = self.frho_n[ei]
        m = torch.minimum(torch.clamp(torch.floor(p_arg).to(torch.int64),
                                      min=1), n - 1)
        p = p_arg - m
        p = p + (torch.clamp(p, max=1.0) - p).detach()
        c = self.frho_spline[ei, m]
        return ((c[..., 3] * p + c[..., 4]) * p + c[..., 5]) * p + c[..., 6]

    def _embed_deriv(self, ei, p_arg):
        """dF/drho from the derivative coefficient rows (cpp:940 fp)."""
        n = self.frho_n[ei]
        m = torch.minimum(torch.clamp(torch.floor(p_arg).to(torch.int64),
                                      min=1), n - 1)
        p = torch.clamp(p_arg - m, max=1.0)
        c = self.frho_spline[ei, m]
        return (c[..., 0] * p + c[..., 1]) * p + c[..., 2]

    def _elements(self, types, ghosts):
        return self.typemap[types], self.typemap[ghosts.all_types(types)]

    # ------------------------------------------------------------------
    def _rho_core(self, dx, dy, dz, rsq, mask, el_own, el_all, main):
        """Density rho_i plus the per-edge quantities of both tallies.  The
        O(K^2) angular density runs over the compacted angular subset when
        prepare() found one (pair_aeam.cpp:208)."""
        r = torch.sqrt(rsq)
        ei = el_own[:, None]
        ej = self._jel(main, el_all)
        ang_i = ei >= self.nnonangular
        ang_j = ej >= self.nnonangular
        cut_ij = self._cut_ij(ei, ej, r.shape)
        # density leg gating: cut - 1.5 when both endpoints are angular
        # (pair_aeam.cpp:187-192, 218-223); r > cut excludes (strict)
        leg_cut = cut_ij - torch.where(ang_i & ang_j, CUTDEC, 0.0)
        in_leg = mask & (r <= leg_cut)
        # one fused 14-wide row gather serves f_ij and phi
        tab = (ei * self.nel + ej).expand(r.shape)
        row, p = self._knots(tab, r)
        c = self.pair_flat[row]                               # [N, K, 14]
        f_ij = ((c[..., 3] * p + c[..., 4]) * p + c[..., 5]) * p + c[..., 6]
        phi = ((c[..., 10] * p + c[..., 11]) * p + c[..., 12]) * p \
            + c[..., 13]
        fw = torch.where(in_leg, f_ij, 0.0)
        rho_lin = torch.sum(fw, dim=1)
        ang_center = el_own >= self.nnonangular
        K = main.capacity
        not_diag = ~torch.eye(K, dtype=torch.bool, device=r.device)[None]
        sel = self._ang_sel
        if sel is not None and sel.shape[0] == 0:
            rho = rho_lin
        elif sel is not None:
            rho = rho_lin.index_copy(0, sel, _ang_density(
                fw[sel], dx[sel], dy[sel], dz[sel], r[sel], not_diag))
        else:
            rho = torch.where(ang_center,
                              _ang_density(fw, dx, dy, dz, r, not_diag),
                              rho_lin)
        return rho, ang_center, r, mask, phi, cut_ij

    def _rho_field(self, x, strain, el_own, el_all, ghosts, main, h):
        dx, dy, dz, rsq, mask = edge_components(x, ghosts, main, h, strain)
        return self._rho_core(dx, dy, dz, rsq, mask, el_own, el_all, main)

    def energy(self, x, strain, types, nbr: NeighborData, h,
               center_mask=None):
        main = nbr.lists["main"]
        el_own, el_all = self._elements(types, nbr.ghosts)
        rho_etc = self._rho_field(x, strain, el_own, el_all, nbr.ghosts,
                                  main, h)
        return self._energy_from_rho(rho_etc, el_own, center_mask)

    def _energy_core(self, dx, dy, dz, rsq, mask, el_own, el_all, main):
        """Scalar energy from the per-edge displacements (the mirror-edge
        force path takes its gradient in (dx, dy, dz))."""
        rho_etc = self._rho_core(dx, dy, dz, rsq, mask, el_own, el_all, main)
        return self._energy_from_rho(rho_etc, el_own)

    def _energy_from_rho(self, rho_etc, el_own, center_mask=None):
        rho, ang_center, r, mask, phi, cut_ij = rho_etc
        # embedding argument rho^n with the minrho force guard
        # (pair_aeam.cpp:329-332): the value uses rho^n always, the gradient
        # is cut below minrho; the double where keeps sqrt'(0) out of the
        # backward pass
        live = rho > MINRHO
        rho_safe = torch.where(live, rho, 1.0)
        pow_live = torch.where(ang_center, torch.sqrt(rho_safe), rho_safe)
        pow_dead = torch.where(ang_center,
                               torch.sqrt(torch.where(live, 1.0, rho)),
                               rho).detach()
        rho_pow = torch.where(live, pow_live, pow_dead)
        p_arg = rho_pow * self.frho_rdrho[el_own] + 1.0
        embed = self._embed(el_own, p_arg)
        if center_mask is not None:
            embed = torch.where(center_mask, embed, 0.0)
        e_embed = torch.sum(embed)
        # pair term: full cut (cpp:350), half per directed edge (cpp:387);
        # under sharding only the owned centres' directed edges count
        in_pair = mask & (r <= cut_ij)
        if center_mask is not None:
            in_pair = in_pair & center_mask[:, None]
        e_pair = 0.5 * torch.sum(torch.where(in_pair, phi, 0.0))
        return e_embed + e_pair

    # -- forces ----------------------------------------------------------
    def rebuild_tables(self, nbr: NeighborData) -> dict:
        """Tables the force path reads, built with the lists at each
        rebuild (NeighborData.pair_tables): the target-major table of the
        angular centres' Newton reactions, when the fast path has a
        compacted angular subset."""
        sel = self._ang_sel
        if not self._sym_grids or sel is None or sel.shape[0] == 0:
            return {}
        return {REACT_KEY: self._reaction_table(nbr)}

    def _reaction_table(self, nbr: NeighborData) -> torch.Tensor:
        """[n, K] int64: for each owned atom, the flat indices (a * K + k,
        a the angular row of the compacted subset, k its slot) of the
        angular entries whose target is the atom or one of its ghost
        images, in entry order; E = Na * K (a zero row) fills the rest.

        No atom receives more than K entries while the lists are complete
        (each entry onto j is the mirror of an angular slot in j's own
        row); a truncated rebuild, which the Engine discards, sends the
        excess to the dropped row n.  Built by a stable sort of the
        entries' owner targets: no float atomics, one fixed order."""
        main, ghosts = nbr.lists["main"], nbr.ghosts
        sel = self._ang_sel
        n, K = main.idx.shape
        tgt = edge_targets(main, ghosts, n)[sel]
        return target_table(tgt.reshape(-1), n, K)

    def forces(self, x, types, nbr: NeighborData, h):
        """The fast path when the file's r-grids are symmetric; otherwise
        the mirror-edge autograd (or plain autograd without a mirror
        table)."""
        main = nbr.lists["main"]
        if self._sym_grids:
            return self._forces_fast(x, types, nbr, h)
        if main.mirror is None:
            return super().forces(x, types, nbr, h)
        el_own, el_all = self._elements(types, nbr.ghosts)
        x_all = nbr.ghosts.all_positions(x, h)
        D = x_all[main.idx]                           # [N, K, 3] row gather
        with torch.enable_grad():
            d = [(D[..., a] - x[:, a][:, None]).detach().requires_grad_(True)
                 for a in range(3)]
            rsq = torch.where(main.mask,
                              d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1.0)
            e = self._energy_core(*d, rsq, main.mask, el_own, el_all, main)
            gx, gy, gz = torch.autograd.grad(e, d)
        return mirror_combine(gx, gy, gz, main)

    def _poly_pair_terms(self, ei, ej, r, cut_ij):
        """(f_ij, f'_ij, f'_ji, phi'_ij) per edge from the piecewise
        Chebyshev refits (polyfit.py), in place of the spline-row gather:
        one 7-deep segment select chain per type-pair corner, then an
        exact bilinear combine over the element codes (shared by the
        (ei, ej) and (ej, ei) directions)."""
        from .polyfit import DEG, NSEG, U0
        inv_cut = 1.0 / cut_ij
        u = r * inv_cut
        t = (u - U0) * (NSEG / (1.0 - U0))
        t = torch.clamp(t, 0.0, NSEG * (1.0 - 1e-6))
        seg = torch.floor(t).to(torch.int64)
        v = 2.0 * (t - seg) - 1.0
        dv_dr = (2.0 * NSEG / (1.0 - U0)) * inv_cut
        nel = self.nel
        fco = np.asarray(self.poly.f_coef).reshape(nel, nel, NSEG, DEG + 1)
        pco = np.asarray(self.poly.phi_coef).reshape(nel, nel, NSEG,
                                                     DEG + 1)
        eif = ei.to(self.dtype)
        ejf = ej.to(self.dtype)
        eijf = eif * ejf
        hi = min(1, nel - 1)

        def seg_chain(col):
            out = torch.full(r.shape, float(col[0]), dtype=self.dtype,
                             device=r.device)
            for s_ in range(1, NSEG):
                out = torch.where(seg == s_, float(col[s_]), out)
            return out

        def corner_coeffs(tab, k):
            c00 = tab[0, 0, :, k]
            d10 = tab[hi, 0, :, k] - c00
            d01 = tab[0, hi, :, k] - c00
            d11 = tab[hi, hi, :, k] - tab[hi, 0, :, k] - tab[0, hi, :, k] \
                + c00
            return (seg_chain(c00), seg_chain(d10), seg_chain(d01),
                    seg_chain(d11))

        def horner_pair(tab, want_val, want_rev):
            val = der = der_r = None
            for k in range(DEG, -1, -1):
                c00, d10, d01, d11 = corner_coeffs(tab, k)
                cf = c00 + d10 * eif + d01 * ejf + d11 * eijf
                if want_val:
                    val = cf if val is None else val * v + cf
                if der is None:
                    if k > 0:
                        der = DEG * cf
                elif k > 0:
                    der = der * v + k * cf
                if want_rev:
                    cr = c00 + d10 * ejf + d01 * eif + d11 * eijf
                    if der_r is None:
                        if k > 0:
                            der_r = DEG * cr
                    elif k > 0:
                        der_r = der_r * v + k * cr
            return (val, None if der is None else der * dv_dr,
                    None if der_r is None else der_r * dv_dr)

        f_ij, fp_ij, fp_ji = horner_pair(fco, True, True)
        _, phip, _ = horner_pair(pco, False, False)
        return f_ij, fp_ij, fp_ji, phip

    def _forces_fast(self, x, types, nbr: NeighborData, h):
        """See forces().  Row gathers: positions, spline rows [., 21] and
        F'_j; the angular subset's reaction through the target table."""
        ghosts = nbr.ghosts
        main = nbr.lists["main"]
        idx, mask = main.idx, main.mask
        el_own, el_all = self._elements(types, ghosts)
        sel = self._ang_sel
        if sel is None:
            # no compaction (an angular majority): autograd of the energy
            return PairStyle.forces(self, x, types, nbr, h)

        x_all = ghosts.all_positions(x, h)
        D = x_all[idx]                                # [N, K, 3] row gather
        dx = D[..., 0] - x[:, 0][:, None]
        dy = D[..., 1] - x[:, 1][:, None]
        dz = D[..., 2] - x[:, 2][:, None]
        rsq = torch.where(mask, dx * dx + dy * dy + dz * dz, 1.0)
        r = torch.sqrt(rsq)

        ei = el_own[:, None]
        ej = self._jel(main, el_all)
        ang_i = ei >= self.nnonangular
        ang_j = ej >= self.nnonangular
        ang_center = el_own >= self.nnonangular
        cut_ij = self._cut_ij(ei, ej, r.shape)
        leg_cut = cut_ij - torch.where(ang_i & ang_j, CUTDEC, 0.0)
        in_leg = mask & (r <= leg_cut)
        in_pair = mask & (r <= cut_ij)

        if self.poly is not None:
            f_ij, fp_ij, fp_ji, phip = self._poly_pair_terms(ei, ej, r,
                                                             cut_ij)
        else:
            tab = (ei * self.nel + ej).expand(r.shape)
            p_raw = r * self._sel_tab(tab, self.rhor_rdr_np) + 1.0
            nknot = self._sel_tab(tab, self.rhor_nr_np).to(torch.int64)
            m = torch.minimum(torch.floor(p_raw).to(torch.int64), nknot - 1)
            p = torch.clamp(p_raw - m, max=1.0)
            c = self.pair_flat21[tab * self.rhor_stride + m]  # [N, K, 21]
            f_ij = ((c[..., 3] * p + c[..., 4]) * p + c[..., 5]) * p \
                + c[..., 6]
            fp_ij = (c[..., 0] * p + c[..., 1]) * p + c[..., 2]
            phip = (c[..., 7] * p + c[..., 8]) * p + c[..., 9]
            fp_ji = (c[..., 14] * p + c[..., 15]) * p + c[..., 16]

        # density field (linear everywhere; the angular subset replaces it)
        fw = torch.where(in_leg, f_ij, 0.0)
        rho = torch.sum(fw, dim=1)
        K = main.capacity
        not_diag = ~torch.eye(K, dtype=torch.bool, device=x.device)[None]
        if sel.shape[0] > 0:
            rho = rho.index_copy(0, sel, _ang_density(
                fw[sel], dx[sel], dy[sel], dz[sel], r[sel], not_diag))

        # embedding derivative F'(rho) with the minrho guard (cpp:329-332)
        live = rho > MINRHO
        rho_safe = torch.where(live, rho, 1.0)
        rho_pow = torch.where(ang_center, torch.sqrt(rho_safe), rho_safe)
        p_arg = rho_pow * self.frho_rdrho[el_own] + 1.0
        Fp = self._embed_deriv(el_own, p_arg)
        # linear centres only; angular centres are exact through the subset
        # autograd below (their sqrt / minrho chain included there)
        Fp_lin = torch.where(live & ~ang_center, Fp, 0.0)        # [N]
        # F'_j per edge (the reference's fp forward communication)
        Fp_j = torch.cat([Fp_lin, Fp_lin[ghosts.owner]])[idx]    # [N, K]

        s_own = Fp_lin[:, None] * torch.where(in_leg, fp_ij, 0.0)
        s_mir = Fp_j * torch.where(in_leg, fp_ji, 0.0)
        s_pair = torch.where(in_pair, phip, 0.0)
        s = torch.where(mask, (s_own + s_mir + s_pair) / r, 0.0)
        force = torch.stack([torch.sum(s * dx, dim=1),
                             torch.sum(s * dy, dim=1),
                             torch.sum(s * dz, dim=1)], dim=1)
        if sel.shape[0] == 0:
            return force

        # angular centres: exact cotangents of their embedding energy on the
        # compacted subset, then the reaction through the target table
        maskB = mask[sel]
        in_legB = in_leg[sel]
        f_ijB = f_ij[sel]
        fp_ijB = fp_ij[sel]
        rsel = r[sel]
        el_sel = el_own[sel]
        with torch.enable_grad():
            dB = [a[sel].detach().requires_grad_(True) for a in (dx, dy, dz)]
            rB = torch.sqrt(torch.where(
                maskB, dB[0] ** 2 + dB[1] ** 2 + dB[2] ** 2, 1.0))
            # f(r) re-linearized around the gathered rows: value +
            # derivative * (rB - r) keeps the row gather out of the
            # backward pass and matches the spline's local slope exactly
            fB = torch.where(in_legB, f_ijB + fp_ijB * (rB - rsel), 0.0)
            rhoB = _ang_density(fB, *dB, rB, not_diag)
            liveB = rhoB > MINRHO
            rhoB_safe = torch.where(liveB, rhoB, 1.0)
            pow_dead = torch.sqrt(torch.where(
                liveB, 1.0, torch.clamp(rhoB, min=0.0))).detach()
            rho_powB = torch.where(liveB, torch.sqrt(rhoB_safe), pow_dead)
            p_argB = rho_powB * self.frho_rdrho[el_sel] + 1.0
            gB = torch.autograd.grad(
                torch.sum(self._embed(el_sel, p_argB)), dB)
        gB = torch.stack(gB, dim=-1)                          # [Na, K, 3]
        force = force.index_copy(0, sel, force[sel] + gB.sum(dim=1))
        table = nbr.pair_tables.get(REACT_KEY)
        if table is None:
            table = self._reaction_table(nbr)
        g_pad = torch.cat([gB.reshape(-1, 3), gB.new_zeros((1, 3))])
        return force - g_pad[table].sum(dim=1)

    # -- analysis --------------------------------------------------------
    def force_pass_deviation(self, x, types, nbr: NeighborData, h):
        """Per-atom bound on |F_reference - F_here| from the reference's
        force-pass cutoff inconsistency (pair_aeam.cpp:350 vs :192): the
        [N, 3] sum of every shell-triplet force term the reference's force
        pass may add (see the JAX module).  Zero whenever no angular-angular
        pair sits in the 1.5 A shell, or the angular-angular density table
        is zero there.  An analysis path: it reads the angular rows back."""
        ghosts = nbr.ghosts
        main = nbr.lists["main"]
        el_own, el_all = self._elements(types, ghosts)
        n = x.shape[0]
        m_all = n + ghosts.count
        dx, dy, dz, rsq, mask = edge_components(x, ghosts, main, h, None)
        r = torch.sqrt(rsq)
        ei = el_own[:, None]
        ej = self._jel(main, el_all)
        ang_i = ei >= self.nnonangular
        ang_j = ej >= self.nnonangular
        cut_ij = self._cut_ij(ei, ej, r.shape)
        # shell legs: both ends angular, r in (cut - 1.5, cut]
        shell = mask & ang_i & ang_j & (r > cut_ij - CUTDEC) & (r <= cut_ij)
        leg_cut = cut_ij - torch.where(ang_i & ang_j, CUTDEC, 0.0)
        in_leg = mask & (r <= leg_cut)

        # rho and fp exactly as the energy uses them
        rho, ang_center, _, _, _, _ = self._rho_core(
            dx, dy, dz, rsq, mask, el_own, el_all, main)
        live = rho > MINRHO
        rho_safe = torch.where(live, rho, 1.0)
        p_arg = torch.sqrt(rho_safe) * self.frho_rdrho[el_own] + 1.0
        fp = self._embed_deriv(el_own, p_arg)
        Fptmp = torch.where(live & ang_center, 0.5 / torch.sqrt(rho_safe),
                            0.0)                               # ni = 0.5
        pref_i = Fptmp * fp

        # spline values and derivatives at the legs (full cut)
        f_ij = self._rhor(ei, ej, r)
        tab = (ei * self.nel + ej).expand(r.shape)
        p_raw = r * self._sel_tab(tab, self.rhor_rdr_np) + 1.0
        nknot = self._sel_tab(tab, self.rhor_nr_np).to(torch.int64)
        mm = torch.minimum(torch.floor(p_raw).to(torch.int64), nknot - 1)
        pp = torch.clamp(p_raw - mm, max=1.0)
        cc = self.rhor_flat[tab * self.rhor_stride + mm]
        df_ij = (cc[..., 0] * pp + cc[..., 1]) * pp + cc[..., 2]

        ang_rows = torch.nonzero(el_own >= self.nnonangular).flatten()
        if ang_rows.shape[0] == 0:
            return torch.zeros((n, 3), dtype=x.dtype, device=x.device)
        dxB, dyB, dzB = dx[ang_rows], dy[ang_rows], dz[ang_rows]
        rB = r[ang_rows]
        shellB = shell[ang_rows]
        legB = in_leg[ang_rows]
        fB = torch.where(legB, f_ij[ang_rows], 0.0)
        dfB = df_ij[ang_rows]
        f_fullB = f_ij[ang_rows]
        prefB = pref_i[ang_rows]
        idxB = main.idx[ang_rows]

        # triplet tensors [Na, K (j = shell), K (k = normal)]
        r1 = rB[:, :, None]
        r2 = rB[:, None, :]
        dots = (dxB[:, :, None] * dxB[:, None, :]
                + dyB[:, :, None] * dyB[:, None, :]
                + dzB[:, :, None] * dzB[:, None, :])
        cs = dots / (r1 * r2)
        rsq3 = r1 ** 2 + r2 ** 2 - 2.0 * dots
        r3 = torch.sqrt(torch.clamp(rsq3, min=1e-12))
        delcs = cs + 1.0 / 3.0
        ftet = delcs * delcs
        pair_ok = shellB[:, :, None] & legB[:, None, :]
        ci = 2.0
        fik = fB[:, None, :]
        dfik_t = dfB[:, None, :]
        fij_t = f_fullB[:, :, None]
        dfij_t = dfB[:, :, None]
        DFij = ci * (fik * dfij_t * ftet + fij_t * fik * 2.0 * delcs
                     * (1.0 / r2 - cs / r1))
        DFik = ci * (fij_t * dfik_t * ftet + fij_t * fik * 2.0 * delcs
                     * (1.0 / r1 - cs / r2))
        DFjk = ci * fij_t * fik * 2.0 * delcs * (-r3 / (r1 * r2))
        w = torch.where(pair_ok, prefB[:, None, None], 0.0)
        FFij = -w * DFij / r1
        FFik = -w * DFik / r2
        FFjk = -w * DFjk / r3
        d1 = torch.stack([dxB, dyB, dzB], dim=-1)
        d3 = d1[:, None, :, :] - d1[:, :, None, :]      # x_k - x_j
        fj = FFij[..., None] * d1[:, :, None, :] - FFjk[..., None] * d3
        fk = FFik[..., None] * d1[:, None, :, :] + FFjk[..., None] * d3

        out = torch.zeros((m_all + 1, 3), dtype=x.dtype, device=x.device)
        out = out.index_add(0, ang_rows, -torch.sum(fj + fk, dim=(1, 2)))
        tgt_j = torch.where(shellB, idxB, m_all)
        out = out.index_add(0, tgt_j.reshape(-1),
                            torch.sum(fj, dim=2).reshape(-1, 3))
        tgt_k = torch.where(legB, idxB, m_all)
        out = out.index_add(0, tgt_k.reshape(-1),
                            torch.sum(fk, dim=1).reshape(-1, 3))
        # ghost contributions to their owners
        return out[:n].index_add(0, ghosts.owner, out[n:m_all])

    def energy_peratom(self, x, types, nbr: NeighborData, h):
        """Per-atom energies as the reference tallies them: the embedding
        F to each centre with the 1/3 factor for angular atoms
        (pair_aeam.cpp:296-301), and 0.5 phi per directed edge to the
        centre only (cpp:389 adds to eatom[i], not j)."""
        main = nbr.lists["main"]
        el_own, el_all = self._elements(types, nbr.ghosts)
        rho, ang_center, r, mask, phi, cut_ij = self._rho_field(
            x, None, el_own, el_all, nbr.ghosts, main, h)
        rho_pow = torch.where(ang_center,
                              torch.sqrt(torch.clamp(rho, min=0.0)), rho)
        p_arg = rho_pow * self.frho_rdrho[el_own] + 1.0
        embed = self._embed(el_own, p_arg)
        eat = torch.where(ang_center, embed / 3.0, embed)
        phi = torch.where(mask & (r <= cut_ij), phi, 0.0)
        return eat + 0.5 * torch.sum(phi, dim=1)

    def virial_peratom(self, x, types, nbr: NeighborData, h):
        """[N, 6] vatom through the edge cotangents of the whole energy
        (density, embedding, angular and pair terms all enter through the
        edge displacements), tallied half-half (JAX aeam.py:458); sums to
        the strain-derivative virial.  On the card the neighbour halves
        are gathered through the mirror table or, on the fast path's
        lists without one, base.target_table: no float atomics."""
        main = nbr.lists["main"]
        el_own, el_all = self._elements(types, nbr.ghosts)
        dx, dy, dz, _, mask = edge_components(x, nbr.ghosts, main, h)
        with torch.enable_grad():
            d = [c.detach().requires_grad_(True) for c in (dx, dy, dz)]
            rsq = torch.where(mask, d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                              1.0)
            e = self._energy_core(*d, rsq, mask, el_own, el_all, main)
            g = torch.autograd.grad(e, d)
        return edge_virial_peratom((dx, dy, dz), g, main, nbr.ghosts,
                                   x.shape[0])
