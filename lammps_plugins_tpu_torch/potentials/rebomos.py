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

Energy and virial (thermo rows) are autograd of `energy`.
"""

from __future__ import annotations

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
from .base import PairStyle
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


def rebo_energy_rows(dx, dy, dz, mask, ei, ej, consts):
    """REBO energy of [N, K] edge displacements (rows = centers).

    ei: [N] center element codes and ej: [N, K] neighbor codes, both
    float 0/1; consts: derive_rebo_constants(tables) (bilinear rows).
    Every term is row-local."""
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
    e_edge = torch.where(live, VR + pij * VA, torch.zeros_like(VR))
    return 0.5 * torch.sum(e_edge)


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

    # -- energy (autograd path: thermo, virial, host-list forces) ---------
    def energy(self, x, strain, types, nbr: NeighborData, h):
        ghosts = nbr.ghosts
        el_own = self.el_of_type[types]
        e_rebo = self._rebo_energy(x, strain, el_own, ghosts,
                                   nbr.lists["rebo"], h)
        if "master" in nbr.lists:
            e_lj = self._lj_energy(x, strain, el_own, ghosts,
                                   nbr.lists["master"], h)
        else:
            e_lj = self._lj_energy_cells(x, strain, ghosts, nbr.cells, h)
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

    def _lj_energy_cells(self, x, strain, ghosts, cells: CellData, h):
        """Switched LJ over the half-offset cell decomposition: each
        unordered candidate pair once (the self-cell block holds both slot
        orders, hence its extra 1/2), weighted by (owned_a + owned_b)/2.
        The per-offset body is recomputed in the backward pass
        (checkpoint), so autograd never holds every offset's
        [ncells, C, C] block at once."""
        x_all = ghosts.all_positions(x, h)
        m_all = x_all.shape[0]
        xpad = torch.cat([x_all, x.new_full((1, 3), 1e7)], dim=0)
        cxs = [xpad[:, a][cells.table] for a in range(3)]
        cel = self.el_of_type[cells.jtype]
        valid = cells.table < m_all
        ownedf = (cells.table < cells.n_owned).to(x.dtype)
        ncells = cells.nbr_map.shape[0]
        ael, aid = cel[:ncells], cells.table[:ncells]
        aval, aown = valid[:ncells], ownedf[:ncells]

        def one_offset(nb_col, s, strain_, *cx):
            d = [cx[a][nb_col][:, None, :] - cx[a][:ncells][:, :, None]
                 for a in range(3)]
            if strain_ is not None:
                d = [d[a] + d[0] * strain_[0, a] + d[1] * strain_[1, a]
                     + d[2] * strain_[2, a] for a in range(3)]
            rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            w = (aown[:, :, None] + ownedf[nb_col][:, None, :]) * s
            pmask = (aval[:, :, None] & valid[nb_col][:, None, :]
                     & (aid[:, :, None] != cells.table[nb_col][:, None, :]))
            rsq = torch.where(pmask, rsq, torch.ones_like(rsq))
            vlj = self._vlj(ael[:, :, None], cel[nb_col][:, None, :],
                            torch.sqrt(rsq), rsq)
            return torch.sum(torch.where(pmask, w * vlj,
                                         torch.zeros_like(vlj)))

        e = x.new_zeros(())
        for o in range(cells.nbr_map.shape[1]):
            s = 0.25 if o == 0 else 0.5
            e = e + checkpoint(one_offset, cells.nbr_map[:, o], s, strain,
                               *cxs, use_reentrant=False)
        return e

    # -- analytic forces (the per-step path) -------------------------------
    def forces(self, x, types, nbr: NeighborData, h):
        """REBO through the cotangent kernel and the configured combine,
        LJ through the configured cell kernel.  Host-built neighbor data
        (no cells, no mirror tables) falls back to autograd of the energy,
        on CPU tensors only."""
        if nbr.cells is None or nbr.lists["rebo"].mirT is None:
            if x.is_cuda:
                raise RuntimeError("REBOMoS.forces on a CUDA tensor needs "
                                   "the device rebuild's cell and mirror "
                                   "tables")
            return super().forces(x, types, nbr, h)
        el_own = self.el_of_type[types]
        f = self._rebo_forces_mirror(x, el_own, nbr.ghosts,
                                     nbr.lists["rebo"], h)
        return f + self._lj_forces_cells(x, nbr.ghosts, nbr.cells, h)

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
        N = x.shape[0]
        planes = self._rebo_planes(x, el_own, ghosts, rebo, h)
        mirv = rebo.mirvT.to(x.dtype)
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
            return mirror_combine_rows(gx, gy, gz, gmir4.reshape(K, Np, 4),
                                       mirv)[:N]
        gx, gy, gz = rebo_cotangents(*planes, self._rebo_consts)
        if self.combine == "react":
            if rebo.rtgt is None:
                raise RuntimeError("combine='react' needs the rebuild's "
                                   "route tables (Engine builds them)")
            return react_combine(gx, gy, gz, rebo.rtgt)[:N]
        if self.combine in ("pin", "pin2"):
            K, Np = gx.shape
            pin = pin_rows3 if self.combine == "pin" else pin_rows3_v2
            grows = pin(torch.stack([gx, gy, gz], dim=-1))   # [K*Np, 3]
            gmir = grows[rebo.mirT.reshape(-1).long()].reshape(K, Np, 3) \
                * mirv[..., None]
            f = torch.stack([gx.sum(dim=0), gy.sum(dim=0), gz.sum(dim=0)],
                            dim=-1) - gmir.sum(dim=0)
            return f[:N]
        return mirror_combine(gx, gy, gz, rebo.mirT, mirv)[:N]

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
        P = self._cell_planes(x, ghosts, cells, h)
        if self.lj == "half":
            F3 = lj_cell_forces_half(P, self._lj_consts, cells.a_range)
        else:
            out = lj_cell_forces(P, self._lj_consts, cells.a_range)
            F3 = out[..., 0:3, :].permute(0, 1, 2, 4, 3)
        return F3.reshape(-1, 3)[cells.aslot]
