"""Fixed-shape neighbor structures (port of neighbor/neighbor.py).

`Ghosts` is the per-rebuild table of periodic images (owner, integer cell
shift); ghost positions are recomputed from the owned positions inside
every evaluation, so autograd carries image reaction forces back to the
owners.  `NeighborList` is a dense padded [N, K] list into the
owned+ghost row space, plus the rebuild-time [K, Np] tables of the
mirror force path.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Ghosts:
    """Ghost g is owned atom owner[g] translated by shift[g] @ H."""

    owner: torch.Tensor     # [Mg] int64
    shift: torch.Tensor     # [Mg, 3] float (working dtype)

    @property
    def count(self) -> int:
        return self.owner.shape[0]

    def all_positions(self, x: torch.Tensor, h: torch.Tensor):
        """[N+Mg, 3] owned rows then ghost images, differentiable in x.
        The shift @ h product is written per component (as in the JAX
        package, whose TPU matmuls ran in bfloat16)."""
        s = self.shift.to(x.dtype)
        h = h.to(x.dtype)
        cols = [s[:, 0] * h[0, a] + s[:, 1] * h[1, a] + s[:, 2] * h[2, a]
                for a in range(3)]
        ghost_x = x[self.owner] + torch.stack(cols, dim=1)
        return torch.cat([x, ghost_x], dim=0)

    def all_types(self, types: torch.Tensor) -> torch.Tensor:
        return torch.cat([types, types[self.owner]], dim=0)


@dataclasses.dataclass(frozen=True)
class NeighborList:
    """Padded list over owned centers: idx[i, k] indexes the [N+Mg] row
    space, mask marks valid slots (padded idx is 0, always masked), jtype
    caches the neighbor's atom type.

    `mirror` [N, K] is the flat slot (row*K + col) of each edge's reverse
    edge (owner(j), image of i), -1 where absent.  The [K, Np] tables
    (Np = N padded to 128) are the same data transposed at rebuild time
    for the force path: mirT encodes the mirror edge as slot*Np + atom,
    mirvT marks valid mirrors.  rblocks [nch, NW] and route
    [nch, NW, KC, 128] are the reaction-combine route tables
    (ops/react.py::build_route_tables), present when the rebuild was asked
    for them and the plan carries route capacities; rtgt [K, Np] int32 is
    the same routing target-major (ops/react.py::route_by_target), the
    table the reaction-combine kernel reads."""

    idx: torch.Tensor
    mask: torch.Tensor
    jtype: torch.Tensor | None = None
    mirror: torch.Tensor | None = None
    idxT: torch.Tensor | None = None
    maskT: torch.Tensor | None = None
    jtypeT: torch.Tensor | None = None
    mirT: torch.Tensor | None = None
    mirvT: torch.Tensor | None = None
    rblocks: torch.Tensor | None = None
    route: torch.Tensor | None = None
    rtgt: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.idx.shape[1]


def edge_components(x: torch.Tensor, ghosts: Ghosts, nlist: NeighborList,
                    h: torch.Tensor, strain: torch.Tensor | None = None):
    """Per-edge displacement components (dx, dy, dz) as three [N, K]
    tensors, plus rsq (1.0 on masked slots) and the mask.  Strain enters
    as d'_a = d_a + sum_b d_b * strain[b, a] (the virial trick)."""
    x_all = ghosts.all_positions(x, h)
    rows = x_all[nlist.idx]                              # [N, K, 3]
    comps = [rows[..., a] - x[:, a][:, None] for a in range(3)]
    if strain is not None:
        d0, d1, d2 = comps
        comps = [comps[a] + d0 * strain[0, a] + d1 * strain[1, a]
                 + d2 * strain[2, a] for a in range(3)]
    dx, dy, dz = comps
    rsq = dx * dx + dy * dy + dz * dz
    rsq_safe = torch.where(nlist.mask, rsq, torch.ones_like(rsq))
    return dx, dy, dz, rsq_safe, nlist.mask


def edge_vectors(x: torch.Tensor, ghosts: Ghosts, nlist: NeighborList,
                 h: torch.Tensor, strain: torch.Tensor | None = None):
    """Per-edge displacement vectors d[i, k] = x_neighbor - x_center.

    `strain` (3x3, typically zeros) implements the virial as a strain
    derivative, d' = d @ (1 + strain): every energy term depends on
    positions only through these vectors, so W = -dE/dstrain.  Returns
    (d [N, K, 3], rsq_safe [N, K], mask); rsq is 1.0 on masked slots so
    that sqrt and reciprocals never see zero."""
    x_all = ghosts.all_positions(x, h)
    d = x_all[nlist.idx] - x[:, None, :]
    if strain is not None:
        d = d @ (torch.eye(3, dtype=d.dtype, device=d.device) + strain)
    rsq = torch.sum(d * d, dim=-1)
    rsq_safe = torch.where(nlist.mask, rsq, torch.ones_like(rsq))
    return d, rsq_safe, nlist.mask


def mirror_combine(gx, gy, gz, nlist: NeighborList) -> torch.Tensor:
    """Atom forces from [N, K] edge cotangents G = dE/dd through the
    mirror-edge bijection: F_i = sum_k G[i,k] - sum_k G[mirror(i,k)] —
    a gather instead of a scatter-add of reaction forces."""
    N, K = gx.shape
    grows = torch.cat([torch.stack([gx, gy, gz], dim=-1).reshape(N * K, 3),
                       gx.new_zeros((1, 3))], dim=0)
    ok = nlist.mask & (nlist.mirror >= 0)
    mir = torch.where(ok, nlist.mirror.long(),
                      torch.full_like(nlist.mirror.long(), N * K))
    gmir = grows[mir.reshape(-1)].reshape(N, K, 3)
    return torch.stack([gx, gy, gz], dim=-1).sum(dim=1) - gmir.sum(dim=1)
