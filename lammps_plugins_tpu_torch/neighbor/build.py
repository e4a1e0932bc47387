"""Neighbor data containers and the host (numpy) build.

Port of lammps_plugins_tpu/neighbor/build.py.  The host build runs the
port's native pair search (ops/native.py, csrc/neighbor_native.cpp); the
Engine uses it only on CPU states, for the parity tests (the path is the
on-device rebuild).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from ..core.box import Box
from ..core.device import resolve
from ..ops import native
from .neighbor import Ghosts, NeighborList


@dataclasses.dataclass(frozen=True)
class CellData:
    """Dense cell decomposition for the LJ tier.

    table [ncells+2, C] maps (cell, slot) to a row of the owned+ghost
    array (m_all = empty slot; the last two rows are the junk and
    out-of-range rows); jtype holds the atom types (0 = empty);
    nbr_map [ncells, 14] the half-offset neighbour cells (column 0 = the
    cell itself).  dims includes the one-cell empty halo ring; a_range is
    the static cell box that holds every owned atom; aslot [n_owned] is
    each owned atom's flat (cell, slot) index into the a_range grid, so
    the force remap is a gather."""

    table: torch.Tensor
    jtype: torch.Tensor
    nbr_map: torch.Tensor
    n_owned: int
    dims: "tuple | None" = None
    a_range: "tuple | None" = None
    cell_mn: "tuple | None" = None
    cell_size: "float | None" = None
    aslot: "torch.Tensor | None" = None


@dataclasses.dataclass(frozen=True)
class NeighborData:
    """Everything an energy function needs, rebuilt together.
    pair_tables: tensors a pair style builds from the lists at each
    rebuild (its `rebuild_tables`), e.g. AEAM's angular reaction table."""

    ghosts: Ghosts
    lists: Dict[str, NeighborList]
    x_build: torch.Tensor     # positions at build time (rebuild trigger)
    skin: float
    cells: "CellData | None" = None
    pair_tables: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def max_displacement_sq(self, x: torch.Tensor) -> torch.Tensor:
        """max_i |x_i - x_build_i|^2 (a 0-d device tensor)."""
        d = x - self.x_build
        return torch.max(torch.sum(d * d, dim=-1))

    def needs_rebuild(self, x) -> bool:
        """The half-skin displacement rule (LAMMPS
        Neighbor::check_distance); one device-to-host read."""
        return float(self.max_displacement_sq(x)) > (0.5 * self.skin) ** 2


def build_ghosts_np(x: np.ndarray, box: Box, cutoff: float):
    """Periodic images within `cutoff` of the box, by a per-axis
    fractional slab test (numpy)."""
    h = box.h_np()
    lo = box.lo_np()
    widths = box.perpendicular_widths_np()
    frac = (x - lo) @ np.linalg.inv(h)
    margins = cutoff / widths
    nrep = [int(np.ceil(cutoff / widths[d])) if box.periodic[d] else 0
            for d in range(3)]
    owners, shifts = [], []
    for sx in range(-nrep[0], nrep[0] + 1):
        for sy in range(-nrep[1], nrep[1] + 1):
            for sz in range(-nrep[2], nrep[2] + 1):
                if sx == 0 and sy == 0 and sz == 0:
                    continue
                s = np.array([sx, sy, sz], dtype=np.float64)
                fi = frac + s
                keep = np.all((fi >= -margins) & (fi <= 1.0 + margins),
                              axis=1)
                idx = np.nonzero(keep)[0]
                if idx.size:
                    owners.append(idx)
                    shifts.append(np.broadcast_to(s, (idx.size, 3)))
    if not owners:
        return np.zeros((0,), np.int64), np.zeros((0, 3), np.float64)
    return np.concatenate(owners).astype(np.int64), np.concatenate(shifts)


def _pairs_to_padded(pi, pj, n, pad_multiple=8):
    """(i, j) pair arrays -> dense padded [N, K] idx + mask."""
    order = np.argsort(pi, kind="stable")
    pi, pj = pi[order], pj[order]
    counts = np.bincount(pi, minlength=n)
    k = int(counts.max()) if len(pi) else 0
    k = max(pad_multiple, -(-k // pad_multiple) * pad_multiple)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(pi)) - starts[pi]
    idx = np.zeros((n, k), dtype=np.int64)
    mask = np.zeros((n, k), dtype=bool)
    idx[pi, slot] = pj
    mask[pi, slot] = True
    return idx, mask


def build_neighbor_data(x, types, box: Box,
                        requests: Mapping[str, np.ndarray],
                        skin: float = 2.0, pad_multiple: int = 8,
                        dtype=torch.float32, device="cuda") -> NeighborData:
    """Ghosts + every requested [N, K] list, built on the host and placed
    on `device`.

    requests: name -> cutoff, scalar or [T+1, T+1] per type pair."""
    device = resolve(device)
    x_np = np.asarray(x, dtype=np.float64)
    t_np = np.asarray(types)
    cut_mats = {name: np.asarray(c, np.float64)
                for name, c in requests.items()}
    list_cut = max(float(c.max()) for c in cut_mats.values()) + skin
    owner, shift = build_ghosts_np(x_np, box, list_cut + skin)
    h = box.h_np()
    x_all = np.concatenate([x_np, x_np[owner] + shift @ h], axis=0)
    t_all = np.concatenate([t_np, t_np[owner]])
    pi, pj, rsq = native.find_pairs(x_np, x_all, list_cut)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa
    lists = {}
    for name, cut in cut_mats.items():
        pair_cut = (np.full(len(pi), float(cut)) if cut.ndim == 0
                    else cut[t_np[pi], t_all[pj]])
        sel = rsq < (pair_cut + skin) ** 2
        idx, mask = _pairs_to_padded(pi[sel], pj[sel], len(x_np),
                                     pad_multiple)
        jtype = np.where(mask, t_all[idx], 0)
        lists[name] = NeighborList(idx=as_t(idx, torch.int64),
                                   mask=as_t(mask, torch.bool),
                                   jtype=as_t(jtype, torch.int64))
    ghosts = Ghosts(owner=as_t(owner, torch.int64), shift=as_t(shift, dtype))
    return NeighborData(ghosts=ghosts, lists=lists,
                        x_build=as_t(x_np, dtype), skin=skin)
