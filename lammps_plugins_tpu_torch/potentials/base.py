"""Pair-style interface (port of lammps_plugins_tpu/potentials/base.py).

A PairStyle is one differentiable energy E(x, strain) over fixed-shape
neighbor structures.  Forces are -dE/dx and the virial is -dE/dstrain,
both taken with torch.autograd.grad, as the JAX package takes them with
jax.grad.  Styles may override `forces` with a faster analytic path.

Per-atom tallies (eatom, vatom: compute pe/atom and stress/atom) split
each directed edge's term half to its centre and half to its neighbour's
owner, LAMMPS ev_tally's half-half split.  The neighbour half is a sum
over the edges that land on an atom, which the JAX package scatter-adds.
Here no float atomics run on the card: `half_half` gathers through the
list's [N, K] mirror table (or, for a list without one, a target-major
table built by a stable integer sort), and `half_half_mirror` reads the
rebuild's [K, Np] mirror tables through the mirror combine (kernel B).
The scatter stays as the CPU twin.
"""

from __future__ import annotations

import copy
from typing import Mapping

import numpy as np
import torch

from ..neighbor.build import NeighborData
from ..neighbor.neighbor import Ghosts, NeighborList
from ..ops.mirror import mirror_combine

#: LAMMPS vatom component order: xx, yy, zz, xy, xz, yz
VIRIAL_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def edge_targets(nlist: NeighborList, ghosts: Ghosts, n: int):
    """[N, K] int64: the owner of each slot's neighbour; n on a masked
    slot."""
    dev = nlist.idx.device
    owner_all = torch.cat([torch.arange(n, device=dev), ghosts.owner])
    return torch.where(nlist.mask, owner_all[nlist.idx],
                       torch.full_like(nlist.idx, n))


def target_table(tgt: torch.Tensor, n: int, width: int | None = None):
    """[n, W] int64: for each atom a < n the positions e in the flat
    target vector tgt [E] with tgt[e] == a, in order; E (a zero row of the
    gathered values) fills the rest, and a target >= n is dropped.  W is
    `width` (entries past it dropped) or the largest count (one host
    read).  Built by a stable sort of the targets: integer work only, one
    fixed order, no float atomics."""
    E = tgt.shape[0]
    st, order = torch.sort(tgt, stable=True)
    if width is None:
        counts = torch.bincount(st, minlength=n + 1)[:n]
        width = max(1, int(counts.max()) if n else 1)
    rank = torch.arange(E, device=st.device) - torch.searchsorted(st, st)
    ok = (st < n) & (rank < width)
    table = torch.full((n + 1, width), E, dtype=torch.int64,
                       device=st.device)
    table[torch.where(ok, st, n), torch.where(ok, rank, 0)] = order
    return table[:n]


def half_half(per_edge, nlist: NeighborList, ghosts: Ghosts, n: int):
    """[n, C] per-atom tally of per_edge [N, K, C] (zero on masked slots):
    1/2 of each slot to its centre, 1/2 to its neighbour's owner.  The
    neighbour halves are gathered through the list's mirror table where it
    has one (the edges that land on atom i are the reverse edges of i's
    own); without it a CPU tensor takes the scatter-add twin (the JAX
    package's .at[].add) and a CUDA one a target_table of the slots."""
    N, K, C = per_edge.shape
    own = 0.5 * per_edge.sum(dim=1)
    if nlist.mirror is not None:
        table = torch.where(nlist.mask & (nlist.mirror >= 0),
                            nlist.mirror.long(), N * K)
    elif not per_edge.is_cuda:
        tgt = edge_targets(nlist, ghosts, n).reshape(-1)
        out = torch.cat([own, own.new_zeros((1, C))])
        return out.index_add(0, tgt, 0.5 * per_edge.reshape(-1, C))[:n]
    else:
        table = target_table(edge_targets(nlist, ghosts, n).reshape(-1), n)
    flat = torch.cat([per_edge.reshape(-1, C), per_edge.new_zeros((1, C))])
    return own + 0.5 * flat[table].sum(dim=1)


def half_half_mirror(planes, mirT, mirvT, n: int):
    """[n, C] per-atom tally of C per-edge planes [K, Np] in the rebuild's
    [K, Np] layout (zero on masked slots): 1/2 Σ_k p[k, i] + 1/2 Σ_k
    mirv p[mirT[k, i]], the reverse edges of atom i's own being exactly
    the edges that land on it.  The mirror combine gives S - M three
    planes at a time (kernel B on CUDA float32, its twin on the CPU), so
    the tally is S - (S - M) / 2 with S = Σ_k p[k, i]."""
    out = []
    for c0 in range(0, len(planes), 3):
        grp = list(planes[c0:c0 + 3])
        grp += [torch.zeros_like(grp[0])] * (3 - len(grp))
        s = torch.stack([g.sum(dim=0) for g in grp], dim=-1)
        out.append((s - 0.5 * mirror_combine(*grp, mirT, mirvT))
                   [:n, :min(3, len(planes) - c0)])
    return torch.cat(out, dim=1)


def edge_virial_components(dxyz, gxyz, mask):
    """[N, K, 6] per-edge virial -(d_e ⊗ G_e) in vatom order from the
    displacement and cotangent components, zero on masked slots.  Summed
    over every edge it is the strain-derivative virial exactly (the
    strain enters as d'_a = d_a + Σ_b d_b strain[b, a])."""
    comps = [-(dxyz[a] * gxyz[b]) for a, b in VIRIAL_PAIRS]
    per_edge = torch.stack(comps, dim=-1)
    return torch.where(mask[..., None], per_edge, 0.0)


def edge_virial_peratom(dxyz, gxyz, nlist: NeighborList, ghosts: Ghosts,
                        n: int):
    """[n, 6] per-atom virial from per-edge displacements and cotangents
    (JAX potentials/base.py::edge_virial_peratom): the per-edge tensors,
    tallied half-half.  The reference distributes 3-body terms in thirds
    (v_tally3, pair_rebomos.cpp:710,725); the per-atom split differs by
    that convention, the totals are identical."""
    return half_half(edge_virial_components(dxyz, gxyz, nlist.mask), nlist,
                     ghosts, n)


def _on_device(v, dev):
    """v with its tensors on dev (dicts, lists and tuples walked)."""
    if torch.is_tensor(v):
        return v.to(dev)
    if isinstance(v, dict):
        return {k: _on_device(x, dev) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_on_device(x, dev) for x in v)
    return v


class PairStyle:
    """Base class: subclasses implement neighbor_requests() and energy()."""

    name: str = "none"
    #: the style reads per-atom charges (the Engine binds state.q at setup)
    needs_charges: bool = False

    def bind_charges(self, q) -> None:
        """Receive the system's static per-atom charges (a no-op for a
        charge-free style)."""

    def with_charges(self, q) -> "PairStyle":
        """This style bound to the charge array `q` (itself for a
        charge-free style)."""
        return self

    def neighbor_requests(self) -> Mapping[str, np.ndarray]:
        """name -> cutoff (scalar or [T+1, T+1] per-type-pair matrix)."""
        raise NotImplementedError

    def prepare(self, types_np: np.ndarray) -> None:
        """Optional host-side setup from the (static) atom types."""

    def max_cutoff(self) -> float:
        return max(float(np.max(np.asarray(c)))
                   for c in self.neighbor_requests().values())

    def ghost_margin(self, skin: float) -> float:
        """Halo width for exact owned forces under spatial sharding
        (JAX base.py:114): a halo atom whose edge mirrors into an owned
        force sum needs its own many-body environment complete, so the
        conservative default is twice the max cutoff plus skin; styles
        may override it with their per-tier structure.  A pairwise style
        (lj/cut) keeps it too: its halo rows need neighbours within one
        cutoff only, but the mirror combine reads a halo row's whole edge
        row (JAX ljcut.py:104)."""
        return 2.0 * (self.max_cutoff() + skin)

    def for_sharded(self) -> "PairStyle":
        """This style configured for per-shard evaluation (JAX base.py:99):
        every call then sees one shard's [owned | halo] row space, so a
        style that keeps a row index set built from the global types in
        prepare() returns a copy without it.  The copy may share every
        table with the original."""
        return self

    def to(self, device) -> "PairStyle":
        """A copy of this style with every tensor it holds (in its
        attributes, their dicts, lists and tuples) on `device`, the host
        tables shared: the sharded engine's per-device placement gives
        each shard its own."""
        dev = torch.device(device)
        new = copy.copy(self)
        for k, v in vars(self).items():
            setattr(new, k, _on_device(v, dev))
        if isinstance(getattr(self, "device", None), torch.device):
            new.device = dev
        return new

    def energy(self, x: torch.Tensor, strain: torch.Tensor | None,
               types: torch.Tensor, nbr: NeighborData,
               h: torch.Tensor, center_mask=None) -> torch.Tensor:
        """Total potential energy (differentiable in x and strain).

        center_mask: optional [N] bool of the rows that count as owned
        centres.  The sharded engine passes its shard's owned rows: the
        halo rows of its local block are centres owned by another shard,
        so their terms are left out and each directed edge is counted by
        exactly one shard."""
        raise NotImplementedError

    def energy_force_virial(self, x, types, nbr, h):
        """(E, F, W): energy, forces = -dE/dx, virial = -dE/dstrain."""
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            s = torch.zeros((3, 3), dtype=x.dtype, device=x.device,
                            requires_grad=True)
            e = self.energy(x_, s, types, nbr, h)
            gx, gs = torch.autograd.grad(e, (x_, s))
        return e.detach(), -gx, -gs

    def energy_virial(self, x, types, nbr, h, center_mask=None):
        """(E, W) without forces — for thermo rows; center_mask as in
        energy() (the sharded engine's owned centres of one shard)."""
        with torch.enable_grad():
            s = torch.zeros((3, 3), dtype=x.dtype, device=x.device,
                            requires_grad=True)
            e = self.energy(x.detach(), s, types, nbr, h,
                            center_mask=center_mask)
            (gs,) = torch.autograd.grad(e, (s,))
        return e.detach(), -gs

    def energy_value(self, x, types, nbr, h, center_mask=None):
        """E alone, without gradients: the energy's forward pass."""
        with torch.no_grad():
            return self.energy(x, None, types, nbr, h,
                               center_mask=center_mask)

    def energy_forces(self, x, types, nbr, h):
        """(E, F) without the virial (FIRE's iteration): the energy's
        forward pass and the style's force path."""
        with torch.no_grad():
            e = self.energy(x, None, types, nbr, h)
        return e, self.forces(x, types, nbr, h)

    def forces(self, x, types, nbr, h):
        """Forces only (the per-step path): -dE/dx without the strain."""
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(
                self.energy(x_, None, types, nbr, h), (x_,))
        return -gx

    def energy_peratom(self, x, types, nbr, h):
        """[N] per-atom energy (eatom; compute pe/atom)."""
        raise NotImplementedError(
            f"pair_style {self.name} does not implement per-atom energy")

    def virial_peratom(self, x, types, nbr, h):
        """[N, 6] per-atom virial (vatom; compute stress/atom) in LAMMPS
        order xx yy zz xy xz yz; sums to the strain-derivative virial."""
        raise NotImplementedError(
            f"pair_style {self.name} does not implement per-atom virial")
