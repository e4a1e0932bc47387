"""Bridge from the JAX package's objects to the port's, by way of numpy.

The functions read attributes and convert arrays with np.asarray, so they
take the JAX package's State / NeighborData / RebuildPlan (or anything
shaped like them) without importing JAX.  The parity tests use them to
feed a force slice the reference's own neighbor lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.box import Box
from .core.state import State
from .neighbor.build import CellData, NeighborData
from .neighbor.device_build import RebuildPlan
from .neighbor.neighbor import Ghosts, NeighborList
from .potentials.aeam import AEAM
from .potentials.ljcut import PairLJCut, PairLJCutCoulCut
from .potentials.rebomos import REBOMoS


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def state_from_numpy(state, dtype=torch.float64, device="cpu") -> State:
    """Port State from a JAX-package State."""
    b = state.box
    box = Box.from_numpy(b.h_np(), b.lo_np(), b.periodic, dtype, device)
    return State(x=_t(state.x, dtype, device), v=_t(state.v, dtype, device),
                 f=_t(state.f, dtype, device),
                 type=_t(state.type, torch.int64, device),
                 q=_t(state.q, dtype, device),
                 image=_t(state.image, torch.int32, device),
                 mass=_t(state.mass, dtype, device), box=box,
                 step=int(np.asarray(state.step)), extras={})


_LIST_DTYPES = {"idx": torch.int64, "mask": torch.bool,
                "jtype": torch.int64, "mirror": torch.int64,
                "idxT": torch.int64, "maskT": torch.bool,
                "jtypeT": torch.int64, "mirT": torch.int32,
                "mirvT": torch.bool, "rblocks": torch.int32,
                "route": torch.int32}


def neighbor_data_from_numpy(nbr, dtype=torch.float64,
                             device="cpu") -> NeighborData:
    """Port NeighborData (ghosts, [N, K] lists with their mirror and route
    tables, cell grid) from a JAX-package NeighborData."""
    ghosts = Ghosts(owner=_t(nbr.ghosts.owner, torch.int64, device),
                    shift=_t(nbr.ghosts.shift, dtype, device))
    lists = {}
    for name, lst in nbr.lists.items():
        lists[name] = NeighborList(**{
            f: _t(getattr(lst, f), dt, device)
            for f, dt in _LIST_DTYPES.items()
            if getattr(lst, f, None) is not None})
    cells = None
    if nbr.cells is not None:
        c = nbr.cells
        cells = CellData(
            table=_t(c.table, torch.int64, device),
            jtype=_t(c.jtype, torch.int64, device),
            nbr_map=_t(c.nbr_map, torch.int64, device),
            n_owned=int(c.n_owned), dims=c.dims, a_range=c.a_range,
            cell_mn=c.cell_mn, cell_size=c.cell_size,
            aslot=None if c.aslot is None
            else _t(c.aslot, torch.int64, device))
    return NeighborData(ghosts=ghosts, lists=lists,
                        x_build=_t(nbr.x_build, dtype, device),
                        skin=float(nbr.skin), cells=cells)


def plan_from_fields(plan) -> RebuildPlan:
    """Port RebuildPlan with the same geometry and capacities, the route
    capacities included (fields the port does not carry are ignored)."""
    return RebuildPlan(**{f.name: getattr(plan, f.name)
                          for f in dataclasses.fields(RebuildPlan)})


def rebomos_from_tables(tables, typemap, dtype=torch.float64,
                        device="cpu") -> REBOMoS:
    """Port REBOMoS from parsed parameter tables (numpy already)."""
    return REBOMoS(tables, np.asarray(typemap), dtype=dtype, device=device)


def aeam_from_tables(tables, typemap, dtype=torch.float64, device="cpu",
                     poly_mode: bool = False) -> AEAM:
    """Port AEAM from the JAX style's parsed tables (AEAMTables, numpy
    already) and typemap, so both packages compute from the same
    tables."""
    return AEAM(tables, np.asarray(typemap), dtype=dtype, device=device,
                poly_mode=poly_mode)


def ljcut_from_fields(eps, sig, cut, isset, cut_global: float,
                      cut_coul: float | None = None, qqr2e: float = 1.0,
                      dtype=torch.float64, device="cpu") -> PairLJCut:
    """Port lj/cut (lj/cut/coul/cut when a Coulomb cutoff is given) from a
    JAX style's coefficient tables: [T+1, T+1] eps, sigma, cutoff and
    is-set arrays (numpy already), its global LJ cutoff and, for the
    charged style, its Coulomb cutoff and qqr2e; so both packages compute
    from the same coefficients."""
    eps = np.array(eps, np.float64)
    ntypes = eps.shape[0] - 1
    if cut_coul is not None:
        pair = PairLJCutCoulCut(cut_global, cut_coul, ntypes=ntypes,
                                qqr2e=qqr2e, dtype=dtype, device=device)
    else:
        pair = PairLJCut(cut_global, ntypes=ntypes, dtype=dtype,
                         device=device)
    pair._eps = eps
    pair._sig = np.array(sig, np.float64)
    pair._cut = np.array(cut, np.float64)
    pair._isset = np.array(isset, bool)
    return pair
