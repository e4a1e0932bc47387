"""REBOMoS — REBO bond-order potential for Mo-S (port of
lammps_plugins_tpu/potentials/rebomos.py).

Physics from pair_rebomos.{h,cpp} (Liang, Phillpot & Sinnott 2009;
Stewart & Spearot 2013), as in the JAX package: one differentiable energy
E = 1/2 sum_edges [VR + p_ij VA] over the padded REBO list plus the
three-regime switched LJ over the dense cell grid; forces on the
per-step path are analytic:

  * REBO: edge cotangents G_e = dE/dd_e (ops/rebo.py, CUDA kernel A) and
    the mirror combine F_i = sum_k G[i,k] - sum_k G[mirror(i,k)]
    (ops/mirror.py, kernel B) — no per-edge scatter;
  * LJ: the 27-offset A-side cell sweep (ops/lj_cells.py, kernel C) and
    a gather through the rebuild-time `aslot` table.

The JAX package's other force configurations (its LPT_LJ_HALF, LPT_MIR
and LPT_REACT flags) are constructor arguments here:

  * lj="half": the Newton-half cell sweep (ops/lj_half.py, kernel E);
  * combine="rows": the REBO kernel also emits the [K, Np, 4] rows, which
    are gathered at mirT and reduced by ops/mirror_rows.py (kernel F);
  * combine="pin" / "pin2": the stacked cotangent table goes through the
    layout-pin copy (ops/pin.py) as [R, 128] / [K, 3 Np], then a gather at
    mirT and the K sums in torch;
  * combine="react": the rebuild-time route tables, turned target-major,
    and the block-sparse reaction combine (ops/react.py, kernel G); the
    Engine builds the tables, and a geometry its gate refuses raises (react_gate=False
    builds them at any size).

Energy and virial (thermo rows, energy_virial) on the rebuild's lists
take no autograd: E is the REBO edge energy's forward pass plus the sum of
kernel C's energy row; W = -dE/dstrain is -Σ_e d_e ⊗ G_e over the live
REBO slots (kernel A's cotangents; the strain enters as d'_a = d_a +
Σ_b d_b strain[b, a]) plus the sum of C's virial rows.  On host-built
lists they are autograd of `energy`, on the CPU only.

Per-atom tallies (compute pe/atom, stress/atom) keep the JAX package's
half-half split with the directed p_ij.  On the rebuild's lists the
REBO terms come in the kernels' [K, Np] layout (the cotangents G from
kernel A) and are tallied through the mirror table (kernel B,
base.half_half_mirror); the LJ energy and virial are kernel C's energy
and virial rows.  Host-built lists (a master list, no mirror table) take
the JAX package's [N, K] path with the scatter twin, on the CPU only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve
from ..neighbor.build import CellData, NeighborData
from ..neighbor.neighbor import Ghosts, NeighborList, edge_components
from ..ops.lj_cells import derive_lj_constants, lj_cell_forces
from ..ops.lj_half import lj_cell_forces_half
from ..ops.mirror import mirror_combine
from ..ops.mirror_rows import mirror_combine_rows
from ..ops.pin import pin_rows3, pin_rows3_v2
from ..ops.react import react_combine
from ..ops.rebo import derive_rebo_constants, rebo_cotangents
from ..registry import register_pair_style
from .base import (VIRIAL_PAIRS, PairStyle, edge_virial_peratom, half_half,
                   half_half_mirror)
from .tables import REBOMoSTables, read_rebomos

TOL = 1.0e-9      # pair_rebomos.cpp:52


def lookup22(tab: torch.Tensor, ei, ej):
    """2x2 parameter table lookup as a select chain (element codes 0/1)."""
    return torch.where(ei == 0,
                       torch.where(ej == 0, tab[0, 0], tab[0, 1]),
                       torch.where(ej == 0, tab[1, 0], tab[1, 1]))


def sp_cutoff(r, rmin, inv_drc):
    """Cosine switching function Sp (pair_rebomos.h:195-211), C1."""
    t = (r - rmin) * inv_drc
    mid = 0.5 * (1.0 + torch.cos(t.clamp(0.0, 1.0) * math.pi))
    return torch.where(t <= 0.0, torch.ones_like(t),
                       torch.where(t >= 1.0, torch.zeros_like(t), mid))


def _poly6(coeffs, x):
    """Horner evaluation of c0 + c1 x + ... + c6 x^6; coeffs [..., 7]."""
    out = coeffs[..., 6]
    for k in range(5, -1, -1):
        out = out * x + coeffs[..., k]
    return out


def g_spline(costh, b, bg):
    """Angular function g(cos theta) (pair_rebomos.h:68-167): for
    cos >= 1/2 the two polynomials are blended by
    psi = (1 - cos(2 pi (cos - 1/2)))/2."""
    gcos = _poly6(b, costh)
    gamma = _poly6(bg, costh)
    psi = 0.5 * (1.0 - torch.cos(2.0 * math.pi * (costh - 0.5)))
    return torch.where(costh >= 0.5, gcos + psi * (gamma - gcos), gcos)


def p_coord(NM, NS, a):
    """Coordination penalty P(N) (pair_rebomos.h:173-179); a: [..., 4]."""
    N = NM + NS
    return -a[..., 0] * (N - 1.0) - a[..., 1] * torch.exp(-a[..., 2] * N) \
        + a[..., 3]


#: elements of one piece of the autograd energy's [rows, K, K] (REBO) or
#: [cells, C, C] (LJ cells) temporaries: past it the sum runs over pieces,
#: each recomputed in the backward pass (checkpoint), so that a thermo
#: row's autograd holds one piece's temporaries; below it one piece, the
#: sums as they were
ENERGY_PIECE_ELEMS = 2 ** 25


def _pieces(n: int, per_row: int):
    """Row ranges of at most ENERGY_PIECE_ELEMS // per_row rows."""
    step = max(1, ENERGY_PIECE_ELEMS // per_row)
    return [(c0, min(c0 + step, n)) for c0 in range(0, n, step)]


def rebo_energy_rows(dx, dy, dz, mask, ei, ej, consts):
    """REBO energy of [N, K] edge displacements (rows = centers).

    ei: [N] center element codes and ej: [N, K] neighbor codes, both
    float 0/1; consts: derive_rebo_constants(tables) (bilinear rows).
    Every term is row-local, so a large N is summed in row pieces
    (ENERGY_PIECE_ELEMS)."""
    N, K = mask.shape
    pieces = _pieces(N, K * K)
    if len(pieces) == 1:
        return 0.5 * torch.sum(rebo_edge_energy(dx, dy, dz, mask, ei, ej,
                                                consts))

    def piece(*rows):
        return torch.sum(rebo_edge_energy(*rows, consts))

    e = dx.new_zeros(())
    for c0, c1 in pieces:
        e = e + checkpoint(piece, dx[c0:c1], dy[c0:c1], dz[c0:c1],
                           mask[c0:c1], ei[c0:c1], ej[c0:c1],
                           use_reentrant=False)
    return 0.5 * e


def rebo_edge_energy(dx, dy, dz, mask, ei, ej, consts):
    """[N, K] per directed edge VR + p_ij VA (0 on masked and dead
    slots), of which rebo_energy_rows is half the sum; p_ij is the
    directed bond order, whose per-atom split the JAX package documents
    (README "Documented deviations")."""
    eI = ei[:, None]

    def pairc(name):
        a0, a1, b0, b1 = consts["pair:" + name]
        return (a0 + a1 * eI) + (b0 + b1 * eI) * ej

    def ctr(prefix, n):
        return torch.stack([consts[f"ctr:{prefix}{i}"][0]
                            + consts[f"ctr:{prefix}{i}"][1] * ei
                            for i in range(n)], dim=-1)          # [N, n]

    rsq = torch.where(mask, dx * dx + dy * dy + dz * dz,
                      torch.ones_like(dx))
    r = torch.sqrt(rsq)
    w = sp_cutoff(r, pairc("rcmin"), pairc("inv_drc"))
    w = torch.where(mask, w, torch.zeros_like(w))
    # coordination numbers over the REBO shell (pair_rebomos.cpp:337-343)
    nM = torch.sum(w * (1.0 - ej), dim=1)
    nS = torch.sum(w * ej, dim=1)
    # pair repulsion / attraction (pair_rebomos.cpp:418-427)
    VR = w * (1.0 + pairc("Q") / r) * pairc("A") * torch.exp(
        -pairc("alpha") * r)
    VA = -w * pairc("BIJc") * torch.exp(-pairc("Beta") * r)
    # angular sum Etmp_j = sum_{k != j} w_k g(cos theta_jk)
    dots = (dx[:, :, None] * dx[:, None, :] + dy[:, :, None] * dy[:, None, :]
            + dz[:, :, None] * dz[:, None, :])
    cos = dots / (r[:, :, None] * r[:, None, :])
    # straight-through clamp: value clipped to [-1, 1] (cpp:617-618), the
    # full dcos chain kept (cpp:648-665)
    cos = cos + (cos.clamp(-1.0, 1.0) - cos).detach()
    g = g_spline(cos, ctr("b", 7)[:, None, None, :],
                 ctr("bg", 7)[:, None, None, :])
    K = mask.shape[1]
    eye = torch.eye(K, dtype=torch.bool, device=mask.device)
    kmask = mask[:, None, :] & ~eye[None]
    Etmp = torch.sum(torch.where(kmask, w[:, None, :] * g,
                                 torch.zeros_like(g)), dim=2)
    P = p_coord(nM, nS, ctr("a", 4))
    pij = torch.rsqrt(1.0 + Etmp + P[:, None])
    live = mask & (w > TOL)            # wij <= TOL skip, cpp:412
    return torch.where(live, VR + pij * VA, torch.zeros_like(VR))


@register_pair_style("rebomos")
class REBOMoS(PairStyle):
    """pair_style rebomos — see module docstring."""

    #: tiers the device rebuild provides in cell form / with mirror tables
    cell_tiers = ("master",)
    mirror_tiers = ("rebo",)

    LJ_MODES = ("full", "half")
    COMBINE_MODES = ("mirror", "rows", "pin", "pin2", "react")

    def __init__(self, tables: REBOMoSTables, typemap,
                 dtype=torch.float32, device="cuda", lj="full",
                 combine="mirror", react_gate=True):
        """typemap: 1-based atom type -> element index (0=Mo, 1=S,
        -1=NULL), index 0 unused (`pair_coeff * * file Mo S`).
        lj, combine, react_gate: the force configuration (module
        docstring); the defaults are the main path."""
        if lj not in self.LJ_MODES or combine not in self.COMBINE_MODES:
            raise ValueError(f"REBOMoS: lj={lj!r} (one of {self.LJ_MODES}),"
                             f" combine={combine!r} (one of "
                             f"{self.COMBINE_MODES})")
        self.lj = lj
        self.combine = combine
        self.react_gate = bool(react_gate)
        self.tables = tables
        self.typemap_np = np.asarray(typemap, dtype=np.int64)
        self.dtype = dtype
        self.device = resolve(device)
        t = tables
        as_t = lambda v: torch.as_tensor(  # noqa: E731
            np.asarray(v, np.float64), dtype=dtype, device=self.device)
        self.sigma = as_t(t.sigma)
        self.epsilon = as_t(t.epsilon)
        self.rcLJmin = as_t(t.rcLJmin)
        self.rcLJmax = as_t(t.rcLJmax)
        self.lj3 = as_t(t.lj3)
        self.lj4 = as_t(t.lj4)
        # element code per type (NULL and the unused type 0 map to 0; an
        # empty slot's type 0 is masked everywhere)
        self.el_of_type = torch.as_tensor(
            np.maximum(self.typemap_np, 0), device=self.device)
        self._lj_consts = derive_lj_constants(t)
        self._rebo_consts = derive_rebo_constants(t)

    @classmethod
    def from_file(cls, path: str, elements, ntypes=None,
                  dtype=torch.float32, device="cuda", **config):
        """elements: per atom type, 'Mo'/'M'/'S'/'NULL' (1-based order);
        config: lj, combine, react_gate."""
        ntypes = ntypes or len(elements)
        tmap = np.full(ntypes + 1, -1, dtype=np.int64)
        codes = {"Mo": 0, "M": 0, "S": 1, "NULL": -1}
        for i, el in enumerate(elements, start=1):
            if el not in codes:
                raise ValueError(f"Unknown REBOMOS element {el!r}")
            tmap[i] = codes[el]
        return cls(read_rebomos(path), tmap, dtype=dtype, device=device,
                   **config)

    def neighbor_requests(self):
        t = self.tables
        ntypes = len(self.typemap_np) - 1
        el = self.typemap_np[1:]
        master = np.zeros((ntypes + 1, ntypes + 1))
        rebo = np.zeros((ntypes + 1, ntypes + 1))
        for i in range(1, ntypes + 1):
            for j in range(1, ntypes + 1):
                ei, ej = el[i - 1], el[j - 1]
                if ei < 0 or ej < 0:
                    continue
                master[i, j] = t.rcLJmax[ei, ej]
                rebo[i, j] = t.rcmax[ei, ej]
        return {"master": master, "rebo": rebo}

    def ghost_margin(self, skin: float) -> float:
        """Halo width for spatial sharding (JAX rebomos.py:178): the LJ
        reach, or two REBO hops (a halo centre's bond order needs its own
        rcmax neighbourhood), whichever is larger."""
        t = self.tables
        return max(float(np.max(t.rcLJmax)) + skin,
                   2.0 * (float(np.max(t.rcmax)) + skin))

    # -- energy (autograd on host-built lists and in the tests) ------------
    def energy(self, x, strain, types, nbr: NeighborData, h,
               center_mask=None):
        """center_mask: [N] bool of the true owned centres (JAX
        rebomos.py:203).  Under the sharded engine the halo rows are
        pseudo-owned centres whose directed edges another shard counts, so
        they are masked out of every tier."""
        ghosts = nbr.ghosts
        el_own = self.el_of_type[types]

        def owned(nlist):
            if center_mask is None:
                return nlist
            return dataclasses.replace(
                nlist, mask=nlist.mask & center_mask[:, None])

        e_rebo = self._rebo_energy(x, strain, el_own, ghosts,
                                   owned(nbr.lists["rebo"]), h)
        if "master" in nbr.lists:
            e_lj = self._lj_energy(x, strain, el_own, ghosts,
                                   owned(nbr.lists["master"]), h)
        else:
            e_lj = self._lj_energy_cells(x, strain, ghosts, nbr.cells, h,
                                         center_mask=center_mask)
        return e_rebo + e_lj

    def _rebo_energy(self, x, strain, el_own, ghosts: Ghosts,
                     rebo: NeighborList, h):
        dx, dy, dz, _, mask = edge_components(x, ghosts, rebo, h, strain)
        return self._rebo_energy_core(dx, dy, dz, mask, el_own,
                                      self.el_of_type[rebo.jtype])

    def _rebo_energy_core(self, dx, dy, dz, mask, el_own, el_nbr):
        return rebo_energy_rows(dx, dy, dz, mask, el_own.to(dx.dtype),
                                el_nbr.to(dx.dtype), self._rebo_consts)

    def _vlj(self, ei, ej, r, rsq):
        """Three-regime switched LJ (pair_rebomos.cpp:518-543): zero outside
        [rcLJmin, rcLJmax], 12-6 above 0.95 sigma, cubic ramp below."""
        sig = lookup22(self.sigma, ei, ej)
        eps = lookup22(self.epsilon, ei, ej)
        ljmin = lookup22(self.rcLJmin, ei, ej)
        ljmax = lookup22(self.rcLJmax, ei, ej)
        r2inv = 1.0 / rsq
        r6inv = r2inv * r2inv * r2inv
        v_126 = r6inv * (lookup22(self.lj3, ei, ej) * r6inv
                         - lookup22(self.lj4, ei, ej))
        drw = 0.95 * sig - ljmin
        r6c = (1.0 / 0.95) ** 6
        vdw = 4.0 * eps * r6c * (r6c - 1.0)
        dvdw = (-4.0 * eps / (0.95 * sig)) * r6c * (12.0 * r6c - 6.0)
        c2 = ((3.0 / drw) * vdw - dvdw) / drw
        c3 = (vdw / (drw * drw) - c2) / drw
        drp = r - ljmin
        v_ramp = drp * drp * (drp * c3 + c2)
        zero = torch.zeros_like(r)
        return torch.where((r > ljmax) | (r < ljmin), zero,
                           torch.where(r >= 0.95 * sig, v_126, v_ramp))

    def _lj_energy(self, x, strain, el_own, ghosts, master, h):
        """LJ over the [N, K] master list (host-built neighbor data)."""
        _, _, _, rsq, mask = edge_components(x, ghosts, master, h, strain)
        vlj = self._vlj(el_own[:, None], self.el_of_type[master.jtype],
                        torch.sqrt(rsq), rsq)
        return 0.5 * torch.sum(torch.where(mask, vlj, torch.zeros_like(vlj)))

    def _lj_energy_cells(self, x, strain, ghosts, cells: CellData, h,
                         center_mask=None):
        """Switched LJ over the half-offset cell decomposition: each
        unordered candidate pair once (the self-cell block holds both slot
        orders, hence its extra 1/2), weighted by (owned_a + owned_b)/2.
        With a center_mask the ownership is that mask (ghosts and the pad
        row 0) instead of the row range.  The per-offset body is
        recomputed in the backward pass (checkpoint), so autograd never
        holds every offset's [ncells, C, C] block at once; many cells are
        taken in pieces of cells (ENERGY_PIECE_ELEMS)."""
        x_all = ghosts.all_positions(x, h)
        m_all = x_all.shape[0]
        xpad = torch.cat([x_all, x.new_full((1, 3), 1e7)], dim=0)
        cxs = [xpad[:, a][cells.table] for a in range(3)]
        cel = self.el_of_type[cells.jtype]
        valid = cells.table < m_all
        if center_mask is None:
            ownedf = (cells.table < cells.n_owned).to(x.dtype)
        else:
            own_pad = torch.cat([center_mask.to(x.dtype), x.new_zeros(
                m_all + 1 - center_mask.shape[0])])
            ownedf = own_pad[cells.table]
        ncells = cells.nbr_map.shape[0]
        ael, aid = cel[:ncells], cells.table[:ncells]
        aval, aown = valid[:ncells], ownedf[:ncells]

        def one_offset(c0, c1, nb_col, s, strain_, *cx):
            d = [cx[a][nb_col][:, None, :] - cx[a][c0:c1][:, :, None]
                 for a in range(3)]
            if strain_ is not None:
                d = [d[a] + d[0] * strain_[0, a] + d[1] * strain_[1, a]
                     + d[2] * strain_[2, a] for a in range(3)]
            rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            w = (aown[c0:c1, :, None] + ownedf[nb_col][:, None, :]) * s
            pmask = (aval[c0:c1, :, None] & valid[nb_col][:, None, :]
                     & (aid[c0:c1, :, None]
                        != cells.table[nb_col][:, None, :]))
            rsq = torch.where(pmask, rsq, torch.ones_like(rsq))
            vlj = self._vlj(ael[c0:c1, :, None], cel[nb_col][:, None, :],
                            torch.sqrt(rsq), rsq)
            return torch.sum(torch.where(pmask, w * vlj,
                                         torch.zeros_like(vlj)))

        e = x.new_zeros(())
        C = cells.table.shape[1]
        for o in range(cells.nbr_map.shape[1]):
            s = 0.25 if o == 0 else 0.5
            for c0, c1 in _pieces(ncells, C * C):
                e = e + checkpoint(one_offset, c0, c1,
                                   cells.nbr_map[c0:c1, o], s, strain, *cxs,
                                   use_reentrant=False)
        return e

    # -- analytic forces (the per-step path) -------------------------------
    def forces(self, x, types, nbr: NeighborData, h):
        """REBO through the cotangent kernel and the configured combine,
        LJ through the configured cell kernel.  Host-built neighbor data
        (no cells, no mirror tables) falls back to autograd of the energy,
        on CPU tensors only."""
        if not self._tables_path(nbr):
            return super().forces(x, types, nbr, h)
        el_own = self.el_of_type[types]
        f = self._rebo_forces_mirror(x, el_own, nbr.ghosts,
                                     nbr.lists["rebo"], h)
        return f + self._lj_forces_cells(x, nbr.ghosts, nbr.cells, h)

    def energy_forces(self, x, types, nbr: NeighborData, h):
        """(E, F) for FIRE: on the rebuild's lists the LJ energy comes
        with the LJ forces from one launch of kernel C (its energy row,
        summed) and the REBO energy from the row-local edge terms; on
        host-built lists, the base class's path."""
        if not self._tables_path(nbr):
            return super().energy_forces(x, types, nbr, h)
        with torch.no_grad():
            el_own = self.el_of_type[types]
            e = self._rebo_energy(x, None, el_own, nbr.ghosts,
                                  nbr.lists["rebo"], h)
            f = self._rebo_forces_mirror(x, el_own, nbr.ghosts,
                                         nbr.lists["rebo"], h)
            f_lj, e_lj, _ = self._lj_cells(x, nbr.ghosts, nbr.cells, h,
                                           with_energy=True)
            return e + e_lj.sum(), f + f_lj

    def energy_virial(self, x, types, nbr: NeighborData, h,
                      center_mask=None):
        """(E, W) for a thermo row.  On the rebuild's lists, without
        autograd: one launch each of kernels A and C (module docstring).
        center_mask [N] bool (the sharded engine's owned centres) keeps
        the REBO rows and C's rows of those centres alone, the weighting
        energy() applies.  On host-built lists, the base class's
        autograd (CPU tensors only)."""
        if not self._tables_path(nbr):
            return super().energy_virial(x, types, nbr, h, center_mask)
        with torch.no_grad():
            e, w, _ = self._energy_virial_tables(x, types, nbr, h,
                                                 center_mask)
        return e, w

    def energy_value(self, x, types, nbr: NeighborData, h,
                     center_mask=None):
        """E alone: energy_virial's E on the rebuild's lists (kernels A
        and C, no twin), the energy's forward pass on host-built ones."""
        if not self._tables_path(nbr):
            return super().energy_value(x, types, nbr, h, center_mask)
        return self.energy_virial(x, types, nbr, h, center_mask)[0]

    def energy_force_virial(self, x, types, nbr: NeighborData, h):
        """(E, F, W): on the rebuild's lists the launches of
        energy_virial, whose cotangents and C sweep also give the forces
        (through the configured combine; kernel E's sweep with
        lj="half"); on host-built lists, autograd (CPU tensors only)."""
        if not self._tables_path(nbr):
            return super().energy_force_virial(x, types, nbr, h)
        with torch.no_grad():
            e, w, f = self._energy_virial_tables(x, types, nbr, h, None,
                                                 with_forces=True)
        return e, f, w

    def _energy_virial_tables(self, x, types, nbr: NeighborData, h,
                              center_mask, with_forces=False):
        """(E, W [3, 3], F [N, 3] or None) on the rebuild's tables: E and
        W as energy_virial's, summed in the tensors' dtype."""
        N = x.shape[0]
        el_own = self.el_of_type[types]
        rebo = nbr.lists["rebo"]
        rebo_own = rebo if center_mask is None else dataclasses.replace(
            rebo, mask=rebo.mask & center_mask[:, None])
        e = self._rebo_energy(x, None, el_own, nbr.ghosts, rebo_own, h)
        planes = self._rebo_planes(x, el_own, nbr.ghosts, rebo, h)
        if with_forces:
            f, g = self._rebo_combine(planes, rebo, N)
        else:
            f, g = None, rebo_cotangents(*planes, self._rebo_consts)
        live = planes[4] > 0
        if center_mask is not None:
            live = live & torch.cat([center_mask, center_mask.new_zeros(
                live.shape[1] - N)])[None]
        w = -torch.stack([torch.stack([
            torch.where(live, planes[a] * g[b], 0.0).sum()
            for b in range(3)]) for a in range(3)])
        f_lj, e_lj, v_lj = self._lj_cells(x, nbr.ghosts, nbr.cells, h,
                                          with_energy=True, with_virial=True,
                                          with_forces=with_forces)
        if center_mask is not None:
            e_lj = torch.where(center_mask, e_lj, 0.0)
            v_lj = torch.where(center_mask[:, None], v_lj, 0.0)
        v6 = v_lj.sum(dim=0)
        w_lj = torch.stack([v6[[0, 3, 4]], v6[[3, 1, 5]], v6[[4, 5, 2]]])
        return e + e_lj.sum(), w + w_lj, None if f is None else f + f_lj

    def _rebo_planes(self, x, el_own, ghosts, rebo, h):
        """Inputs of the cotangent kernel in the [K, Np] layout: the
        displacement planes from one row gather of the neighbor positions,
        the neighbor element and mask planes, the center element row."""
        N, K = rebo.idx.shape
        Np = rebo.idxT.shape[1]
        dtype = x.dtype
        x_all = ghosts.all_positions(x, h)
        rows = x_all[rebo.idxT.reshape(-1)].reshape(K, Np, 3)
        xT = F.pad(x.t(), (0, Np - N))                       # [3, Np]
        dxT, dyT, dzT = ((rows[..., a] - xT[a][None, :]).contiguous()
                         for a in range(3))
        return (dxT, dyT, dzT, self.el_of_type[rebo.jtypeT].to(dtype),
                rebo.maskT.to(dtype), F.pad(el_own.to(dtype), (0, Np - N)))

    def _rebo_forces_mirror(self, x, el_own, ghosts, rebo, h):
        """[K, Np]-layout REBO forces: cotangent kernel, then the combine
        (JAX rebomos.py:569-717)."""
        planes = self._rebo_planes(x, el_own, ghosts, rebo, h)
        return self._rebo_combine(planes, rebo, x.shape[0])[0]

    def _rebo_combine(self, planes, rebo, N):
        """(F [N, 3], (gx, gy, gz)): the cotangent kernel on `planes`,
        then the configured combine."""
        mirv = rebo.mirvT.to(planes[0].dtype)
        if self.combine == "rows":
            gx, gy, gz, g4 = rebo_cotangents(*planes, self._rebo_consts,
                                             emit_rows=True)
            K, Np = gx.shape
            rows = g4.reshape(K * Np, 4)
            idx = rebo.mirT.reshape(-1).long()
            if rows.dtype == torch.float32:
                # each 16-byte row gathered as one complex128 element:
                # torch's row gather of [K*Np, 4] took 1.0 ms at 98k atoms
                # on an H100, this element gather 0.05 ms (PERF.md, PR 2)
                gmir4 = rows.view(torch.complex128).reshape(-1)[idx] \
                    .view(torch.float32)
            else:
                gmir4 = rows[idx]
            f = mirror_combine_rows(gx, gy, gz, gmir4.reshape(K, Np, 4),
                                    mirv)
            return f[:N], (gx, gy, gz)
        g = gx, gy, gz = rebo_cotangents(*planes, self._rebo_consts)
        if self.combine == "react":
            if rebo.rtgt is None:
                raise RuntimeError("combine='react' needs the rebuild's "
                                   "route tables (Engine builds them)")
            return react_combine(gx, gy, gz, rebo.rtgt)[:N], g
        if self.combine in ("pin", "pin2"):
            K, Np = gx.shape
            pin = pin_rows3 if self.combine == "pin" else pin_rows3_v2
            grows = pin(torch.stack([gx, gy, gz], dim=-1))   # [K*Np, 3]
            gmir = grows[rebo.mirT.reshape(-1).long()].reshape(K, Np, 3) \
                * mirv[..., None]
            f = torch.stack([gx.sum(dim=0), gy.sum(dim=0), gz.sum(dim=0)],
                            dim=-1) - gmir.sum(dim=0)
            return f[:N], g
        return mirror_combine(gx, gy, gz, rebo.mirT, mirv)[:N], g

    def _cell_planes(self, x, ghosts, cells: CellData, h):
        """Packed [Dx, Dy, Dz, 8, C] planes for the LJ cell kernel: rows
        0-2 x/y/z (pad slots parked at 1e7), 3 element, 4 owned."""
        x_all = ghosts.all_positions(x, h)
        xpad = torch.cat([x_all, x.new_full((1, 3), 1e7)], dim=0)
        Dx, Dy, Dz = cells.dims
        C = cells.table.shape[1]
        ncells = Dx * Dy * Dz
        table = cells.table[:ncells]
        xyz = xpad[table].transpose(1, 2)                    # [ncells, 3, C]
        cel = self.el_of_type[cells.jtype[:ncells]].to(x.dtype)
        owned = (table < cells.n_owned).to(x.dtype)
        P = torch.cat([xyz, cel[:, None, :], owned[:, None, :],
                       x.new_zeros((ncells, 3, C))], dim=1)
        return P.reshape(Dx, Dy, Dz, 8, C).contiguous()

    def _lj_forces_cells(self, x, ghosts, cells: CellData, h):
        """Cell-kernel LJ forces remapped to atoms by the aslot gather."""
        return self._lj_cells(x, ghosts, cells, h)[0]

    def _lj_cells(self, x, ghosts, cells: CellData, h, with_energy=False,
                  with_virial=False, with_forces=True):
        """(forces [N, 3], per-atom energy [N], per-atom virial [N, 6];
        each None unless asked for): the cell kernel's outputs remapped to
        atoms by the aslot gather.  The energy and virial are kernel C's
        rows (half of each pair's V and fp d ⊗ d to each endpoint); with
        lj="half" the forces come from kernel E, the energy and virial
        from C."""
        P = self._cell_planes(x, ghosts, cells, h)
        out = vir = f = None
        if self.lj != "half" or with_energy or with_virial:
            out = lj_cell_forces(P, self._lj_consts, cells.a_range,
                                 with_energy=with_energy,
                                 with_virial=with_virial)
            if with_virial:
                out, vir = out
        if with_forces:
            if self.lj == "half":
                F3 = lj_cell_forces_half(P, self._lj_consts, cells.a_range)
            else:
                F3 = out[..., 0:3, :].permute(0, 1, 2, 4, 3)
            f = F3.reshape(-1, 3)[cells.aslot]
        e = (out[..., 3, :].reshape(-1)[cells.aslot] if with_energy
             else None)
        v = (vir.transpose(-1, -2).reshape(-1, 6)[cells.aslot]
             if with_virial else None)
        return f, e, v

    # -- per-atom tallies (compute pe/atom, stress/atom) --------------------
    def _tables_path(self, nbr: NeighborData) -> bool:
        """True on the rebuild's lists (cells and the [K, Np] mirror
        tables); False on host-built ones, which the CPU alone serves."""
        if nbr.cells is not None and nbr.lists["rebo"].mirT is not None:
            return True
        if nbr.x_build.is_cuda:
            raise RuntimeError("REBOMoS on a CUDA tensor needs the device "
                               "rebuild's cell and mirror tables")
        return False

    def energy_peratom(self, x, types, nbr: NeighborData, h):
        """[N] eatom under ev_tally's half-half split: half of each REBO
        edge's 1/2 (VR + p_ij VA) to its centre, half to its neighbour's
        owner; the LJ pair energy split evenly between its endpoints.
        Sums to energy() (JAX rebomos.py:957)."""
        N = x.shape[0]
        el_own = self.el_of_type[types]
        rebo = nbr.lists["rebo"]
        if self._tables_path(nbr):
            dxT, dyT, dzT, jelT, mskT, eiT = self._rebo_planes(
                x, el_own, nbr.ghosts, rebo, h)
            e = 0.5 * rebo_edge_energy(dxT.t(), dyT.t(), dzT.t(),
                                       mskT.t() > 0, eiT, jelT.t(),
                                       self._rebo_consts)
            eat = half_half_mirror([e.t().contiguous()], rebo.mirT,
                                   rebo.mirvT.to(x.dtype), N)[:, 0]
            return eat + self._lj_cells(x, nbr.ghosts, nbr.cells, h,
                                        with_energy=True,
                                        with_forces=False)[1]
        dx, dy, dz, _, mask = edge_components(x, nbr.ghosts, rebo, h)
        e = 0.5 * rebo_edge_energy(dx, dy, dz, mask, el_own.to(x.dtype),
                                   self.el_of_type[rebo.jtype].to(x.dtype),
                                   self._rebo_consts)
        eat = half_half(e[..., None], rebo, nbr.ghosts, N)[:, 0]
        master = nbr.lists["master"]
        _, _, _, rsq, mask = edge_components(x, nbr.ghosts, master, h)
        vlj = self._vlj(el_own[:, None], self.el_of_type[master.jtype],
                        torch.sqrt(rsq), rsq)
        e = torch.where(mask, 0.5 * vlj, 0.0)
        return eat + half_half(e[..., None], master, nbr.ghosts, N)[:, 0]

    def virial_peratom(self, x, types, nbr: NeighborData, h):
        """[N, 6] vatom: the REBO tier through the edge cotangents G
        (v_e = -(d_e ⊗ G_e), tallied half-half), the LJ tier per pair
        (fpair d ⊗ d, half to each endpoint: kernel C's virial rows).
        Sums to energy_virial()'s W (JAX rebomos.py:1022)."""
        N = x.shape[0]
        el_own = self.el_of_type[types]
        rebo = nbr.lists["rebo"]
        if self._tables_path(nbr):
            planes = self._rebo_planes(x, el_own, nbr.ghosts, rebo, h)
            g = rebo_cotangents(*planes, self._rebo_consts)
            live = planes[4] > 0
            v = [torch.where(live, -(planes[a] * g[b]), 0.0)
                 for a, b in VIRIAL_PAIRS]
            vat = half_half_mirror(v, rebo.mirT, rebo.mirvT.to(x.dtype), N)
            return vat + self._lj_cells(x, nbr.ghosts, nbr.cells, h,
                                        with_virial=True,
                                        with_forces=False)[2]
        el_nbr = self.el_of_type[rebo.jtype]
        vat = self._list_virial(
            x, nbr, rebo, h,
            lambda dx, dy, dz, mask: self._rebo_energy_core(
                dx, dy, dz, mask, el_own, el_nbr))
        master = nbr.lists["master"]
        ej = self.el_of_type[master.jtype]

        def e_lj(dx, dy, dz, mask):
            rsq = torch.where(mask, dx * dx + dy * dy + dz * dz, 1.0)
            vlj = self._vlj(el_own[:, None], ej, torch.sqrt(rsq), rsq)
            return 0.5 * torch.sum(torch.where(mask, vlj, 0.0))

        return vat + self._list_virial(x, nbr, master, h, e_lj)

    @staticmethod
    def _list_virial(x, nbr, nlist, h, energy_of_d):
        """Per-atom virial of one [N, K] list tier from the autograd
        cotangents of energy_of_d(dx, dy, dz, mask)."""
        dx, dy, dz, _, mask = edge_components(x, nbr.ghosts, nlist, h)
        with torch.enable_grad():
            d = [c.detach().requires_grad_(True) for c in (dx, dy, dz)]
            g = torch.autograd.grad(energy_of_d(*d, mask), d)
        return edge_virial_peratom((dx, dy, dz), g, nlist, nbr.ghosts,
                                   x.shape[0])
