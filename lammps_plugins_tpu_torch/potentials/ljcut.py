"""pair_style lj/cut and lj/cut/coul/cut (port of
lammps_plugins_tpu/potentials/ljcut.py; LAMMPS pair_lj_cut.cpp and
pair_lj_cut_coul_cut.cpp semantics):

  * E_lj   = 4 eps [(sig/r)^12 - (sig/r)^6] for r < cut_lj (unshifted,
    LAMMPS's default `pair_modify shift no`; the truncation is exact at r =
    cut although the lists carry the skin);
  * E_coul = qqr2e q_i q_j / r for r < cut_coul;
  * unset type pairs mix geometrically, eps_ij = sqrt(eps_i eps_j) and
    sig_ij = sqrt(sig_i sig_j) (the lj/cut default).

One masked [N, K] edge sweep over the full `main` list; the per-edge
coefficients come from flat [T*T] tables gathered at ti*T + tj.  The
energy (with the strain, for the virial) is the JAX package's; it feeds
thermo through autograd.

Forces take no float atomics: the JAX package's jax.grad scatter-adds
through the x_all[idx] gather, which in torch is an index_put with float
atomics on the card.  On the card kernel I (ops/ljcut.py) sums each
atom's own list row, F_i = sum_k 2 e'(r^2_ik) d_ik: on the full list each
pair's two edges carry opposite cotangents, so row i alone holds atom i's
force, and fixed-order sums keep reruns and the graph and eager loops
bit for bit.  On the CPU the per-edge cotangents G = dE/dd are written
out (E = 1/2 sum e(r^2) gives G = e'(r^2) d, elementwise) and combined
through the list's mirror table, F_i = sum_k G[i,k] - sum_k G[mirror(i,k)]
(neighbor.mirror_combine).  The style asks the rebuild for the table
(`mirror_tiers`; the per-atom tallies read it too).  Lists without one
(the host build of the CPU tests) take plain autograd on the CPU.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..core.device import resolve
from ..neighbor.build import NeighborData
from ..neighbor.neighbor import edge_components, mirror_combine
from ..ops import ljcut
from ..registry import register_pair_style
from .base import PairStyle, edge_virial_peratom, half_half


@register_pair_style("lj/cut")
class PairLJCut(PairStyle):
    mirror_tiers = ("main",)

    def __init__(self, cutoff: float, ntypes: int = 1, dtype=torch.float32,
                 device="cuda"):
        self.cut_global = float(cutoff)
        self.ntypes = int(ntypes)
        self.dtype = dtype
        self.device = resolve(device)
        T = self.ntypes + 1
        self._eps = np.zeros((T, T))
        self._sig = np.zeros((T, T))
        self._cut = np.full((T, T), self.cut_global)
        self._isset = np.zeros((T, T), bool)
        self._tabs = None

    # -- coefficients ------------------------------------------------------
    def set_coeff(self, i: int, j: int, eps: float, sigma: float,
                  cut: float | None = None) -> None:
        """pair_coeff i j eps sigma [cut] (symmetric)."""
        for a, b in ((i, j), (j, i)):
            self._eps[a, b] = eps
            self._sig[a, b] = sigma
            self._cut[a, b] = self.cut_global if cut is None else float(cut)
            self._isset[a, b] = True
        self._tabs = None

    def _mix(self) -> None:
        """Geometric mixing of the unset off-diagonal pairs (LAMMPS
        Pair::mix_energy / mix_distance, mix_flag GEOMETRIC)."""
        T = self.ntypes + 1
        for i in range(1, T):
            for j in range(i + 1, T):
                if self._isset[i, j]:
                    continue
                if not (self._isset[i, i] and self._isset[j, j]):
                    raise ValueError(
                        f"pair_coeff missing for type pair {i} {j} "
                        "and no i-i/j-j coefficients to mix from")
                eps = np.sqrt(self._eps[i, i] * self._eps[j, j])
                sig = np.sqrt(self._sig[i, i] * self._sig[j, j])
                cut = max(self._cut[i, i], self._cut[j, j])
                self.set_coeff(i, j, eps, sig, cut)

    def prepare(self, types_np: np.ndarray) -> None:
        self._tables()

    def _tables(self):
        """Flat [T*T] device tables lj3 = 4 eps sig^12, lj4 = 4 eps sig^6
        and cutsq, made in float64 and cast once."""
        if self._tabs is None:
            self._mix()
            lj3 = 4.0 * self._eps * self._sig ** 12
            lj4 = 4.0 * self._eps * self._sig ** 6
            cutsq = self._cut ** 2
            self._tabs = tuple(
                torch.as_tensor(t.reshape(-1), dtype=self.dtype,
                                device=self.device)
                for t in (lj3, lj4, cutsq))
        return self._tabs

    # -- PairStyle interface -----------------------------------------------
    def neighbor_requests(self):
        self._mix()
        return {"main": self._interaction_cut()}

    def _interaction_cut(self) -> np.ndarray:
        """[T+1, T+1] per-type-pair list cutoff."""
        return self._cut.copy()

    def _edge_flat_types(self, types, nbr: NeighborData, nlist):
        T = self.ntypes + 1
        tj = (nlist.jtype if nlist.jtype is not None
              else nbr.ghosts.all_types(types)[nlist.idx])
        return types[:, None] * T + tj

    def _lj(self, rsq, mask, flat):
        """(e, e') of the LJ term per edge: e(r^2) and de/d(r^2), zero
        outside the mask and the cutoff."""
        lj3_t, lj4_t, cutsq = self._tables()
        lj3, lj4 = lj3_t[flat], lj4_t[flat]
        r2inv = 1.0 / rsq
        r6inv = r2inv * r2inv * r2inv
        live = mask & (rsq < cutsq[flat])
        e = r6inv * (lj3 * r6inv - lj4)
        de = r2inv * r6inv * (3.0 * lj4 - 6.0 * lj3 * r6inv)
        return torch.where(live, e, 0.0), torch.where(live, de, 0.0)

    def _edge_terms(self, rsq, mask, types, nbr, nlist):
        """(e, e') per edge of the style."""
        return self._lj(rsq, mask, self._edge_flat_types(types, nbr, nlist))

    def energy(self, x, strain, types, nbr: NeighborData, h,
               center_mask=None):
        nlist = nbr.lists["main"]
        _, _, _, rsq, mask = edge_components(x, nbr.ghosts, nlist, h, strain)
        e, _ = self._edge_terms(rsq, mask, types, nbr, nlist)
        if center_mask is not None:
            e = e * center_mask[:, None].to(e.dtype)
        # a full (directed) list: each pair appears twice
        return 0.5 * torch.sum(e)

    def _kernel_charges(self) -> dict:
        """The Coulomb arguments of kernel I (none for lj/cut)."""
        return {}

    def kernel_inputs(self, x, types, nbr: NeighborData, h):
        """(args, kwargs) of ops.ljcut.ljcut_forces (kernel I and its twin)
        for this style on these lists."""
        g, nlist = nbr.ghosts, nbr.lists["main"]
        return ((x, types, g.owner, g.shift.to(x.dtype), h.to(x.dtype),
                 nlist.idx, nlist.mask, *self._tables()),
                self._kernel_charges())

    def forces(self, x, types, nbr: NeighborData, h):
        """-dE/dx: kernel I over each atom's own row on the card; on the
        CPU the written-out edge cotangents and the mirror combine, or
        plain autograd for lists without a mirror table."""
        if x.is_cuda:
            args, kw = self.kernel_inputs(x, types, nbr, h)
            return ljcut.ljcut_forces(*args, **kw)
        if nbr.lists["main"].mirror is None:
            return super().forces(x, types, nbr, h)
        return self.mirror_forces(x, types, nbr, h)

    def mirror_forces(self, x, types, nbr: NeighborData, h):
        """The forces in torch ops: the [N, K] edge cotangents combined
        through the list's mirror table (the CPU path, and the yardstick
        of kernel I on the card)."""
        nlist = nbr.lists["main"]
        dx, dy, dz, rsq, mask = edge_components(x, nbr.ghosts, nlist, h)
        _, de = self._edge_terms(rsq, mask, types, nbr, nlist)
        return mirror_combine(de * dx, de * dy, de * dz, nlist)

    # -- per-atom tallies (compute pe/atom, stress/atom) --------------------
    def energy_peratom(self, x, types, nbr: NeighborData, h):
        """[N] eatom: each directed edge's 1/2 e split half-half between
        its endpoints (LAMMPS ev_tally); sums to energy()."""
        nlist = nbr.lists["main"]
        _, _, _, rsq, mask = edge_components(x, nbr.ghosts, nlist, h)
        e, _ = self._edge_terms(rsq, mask, types, nbr, nlist)
        return half_half(0.5 * e[..., None], nlist, nbr.ghosts,
                         x.shape[0])[:, 0]

    def virial_peratom(self, x, types, nbr: NeighborData, h):
        """[N, 6] vatom from the written-out edge cotangents G = e' d
        (JAX ljcut.py:136), tallied half-half; sums to the
        strain-derivative virial.  The Coulomb term of lj/cut/coul/cut
        enters through the same e'."""
        nlist = nbr.lists["main"]
        dx, dy, dz, rsq, mask = edge_components(x, nbr.ghosts, nlist, h)
        _, de = self._edge_terms(rsq, mask, types, nbr, nlist)
        return edge_virial_peratom((dx, dy, dz),
                                   (de * dx, de * dy, de * dz), nlist,
                                   nbr.ghosts, x.shape[0])


@register_pair_style("lj/cut/coul/cut")
class PairLJCutCoulCut(PairLJCut):
    """lj/cut plus truncated 1/r Coulomb between static per-atom charges.

    The Engine binds the charges once (bind_charges(state.q) at set-up):
    they are constant over a run, as with LAMMPS atom_style charge and no
    charge-changing fix.  The style keeps its own device copy, so a
    captured step reads the same storage on every replay; ghost charges
    are gathered through ghosts.owner in each evaluation."""

    needs_charges = True

    def __init__(self, cut_lj: float, cut_coul: float | None = None,
                 ntypes: int = 1, qqr2e: float = 1.0, dtype=torch.float32,
                 device="cuda"):
        super().__init__(cut_lj, ntypes=ntypes, dtype=dtype, device=device)
        self.cut_coul = float(cut_lj if cut_coul is None else cut_coul)
        self.qqr2e = float(qqr2e)
        self._q = None

    def bind_charges(self, q) -> None:
        """Keep a device copy of q; a later binding of as many charges
        writes into the same storage, which a captured graph reads."""
        q = torch.as_tensor(q, dtype=self.dtype, device=self.device).detach()
        if self._q is not None and self._q.shape == q.shape:
            self._q.copy_(q)
        else:
            self._q = q.clone()

    def with_charges(self, q) -> "PairLJCutCoulCut":
        view = copy.copy(self)
        view._q = q
        return view

    def for_sharded(self) -> "PairLJCutCoulCut":
        """Without the globally bound charges: the sharded engine binds
        each shard's [owned | halo] charges through with_charges."""
        return self.with_charges(None)

    def _interaction_cut(self) -> np.ndarray:
        return np.maximum(self._cut, self.cut_coul)

    def _bound_charges(self):
        if self._q is None:
            raise ValueError("lj/cut/coul/cut: bind_charges() was never "
                             "called (system has no charge array)")
        return self._q

    def _kernel_charges(self) -> dict:
        return dict(q=self._bound_charges(), cut_coulsq=self.cut_coul ** 2,
                    qqr2e=self.qqr2e)

    def _edge_terms(self, rsq, mask, types, nbr, nlist):
        q = self._bound_charges()
        e, de = super()._edge_terms(rsq, mask, types, nbr, nlist)
        q_all = torch.cat([q, q[nbr.ghosts.owner]])
        qq = q[:, None] * q_all[nlist.idx]
        ecoul = self.qqr2e * qq / torch.sqrt(rsq)
        live = mask & (rsq < self.cut_coul ** 2)
        # d(qqr2e qq / r)/d(r^2) = -ecoul / (2 r^2)
        return (e + torch.where(live, ecoul, 0.0),
                de + torch.where(live, -0.5 * ecoul / rsq, 0.0))
