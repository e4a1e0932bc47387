"""lj/cut (and lj/cut/coul/cut) forces from each atom's own list row
(kernel I): CUDA kernel wrapper and plain-PyTorch twin.

No TPU kernel precedes it: the JAX package's lj/cut is XLA ops, whose
forces come from jax.grad.  On the full (directed) list every pair (i, j)
appears in both rows, and its two edges carry opposite cotangents, so
the force on atom i needs only row i:

    F_i = sum_k 2 e'(r^2_ik) (x_j(k) - x_i) [live_ik]
    e'  = r2inv r6inv (3 lj4 - 6 lj3 r6inv)  (+ the Coulomb term
          -qqr2e q_i q_j / (2 r^3) for r^2 < cut_coul^2)
    live = mask and r^2 < cutsq[ti * T + tj]

which is LAMMPS's `newton off` full-list sum (fpair = -2 e').  Inputs:
the owned positions x [N, 3], their types [N] (int64), the ghost table
(owner [Mg] int64, shift [Mg, 3], the box matrix h [3, 3]), the [N, K]
list (idx int64 into the [N + Mg] rows, mask bool), the flat [T*T]
tables lj3, lj4 and cutsq, and for the Coulomb term the owned charges q
[N] with cut_coul^2 and qqr2e.  Returns [N, 3].
"""

from __future__ import annotations

import torch

from ..neighbor.neighbor import Ghosts
from . import build
from .select_k import SMEM_LIMIT

#: kernel launches (one per call that reached the CUDA kernel: the ghost
#: table's pass and the sweep)
launches = 0


def ljcut_forces_ref(x, types, owner, shift, h, idx, mask, lj3, lj4, cutsq,
                     q=None, cut_coulsq=0.0, qqr2e=0.0):
    """Twin: the row-local sum in torch ops on [N, K].  The ghost rows
    come from Ghosts.all_positions, whose floats the kernel's table
    repeats."""
    T = _types(lj3)
    ghosts = Ghosts(owner=owner, shift=shift)
    x_all = ghosts.all_positions(x, h)
    t_all = ghosts.all_types(types)
    d = x_all[idx] - x[:, None, :]                     # [N, K, 3]
    dx, dy, dz = d.unbind(-1)
    rsq = dx * dx + dy * dy + dz * dz
    rsq = torch.where(mask, rsq, torch.ones_like(rsq))
    flat = types[:, None] * T + t_all[idx]
    r2inv = 1.0 / rsq
    r6inv = r2inv * r2inv * r2inv
    de = r2inv * r6inv * (3.0 * lj4[flat] - 6.0 * lj3[flat] * r6inv)
    de = torch.where(mask & (rsq < cutsq[flat]), de, torch.zeros_like(de))
    if q is not None:
        q_all = torch.cat([q, q[owner]])
        ecoul = qqr2e * (q[:, None] * q_all[idx]) / torch.sqrt(rsq)
        de = de + torch.where(mask & (rsq < cut_coulsq), -0.5 * ecoul / rsq,
                              torch.zeros_like(de))
    return 2.0 * torch.sum(de[..., None] * d, dim=1)


def _types(lj3) -> int:
    T = int(round(lj3.numel() ** 0.5))
    if T * T != lj3.numel():
        raise ValueError(f"ljcut_forces: {lj3.numel()} coefficients are no "
                         "T*T table")
    return T


def ljcut_forces(x, types, owner, shift, h, idx, mask, lj3, lj4, cutsq,
                 q=None, cut_coulsq=0.0, qqr2e=0.0):
    """[N, 3] forces of lj/cut (with q: lj/cut/coul/cut) from the [N, K]
    full list.  CPU tensors take the twin; CUDA float32 tensors the
    kernel (any other dtype on the card raises)."""
    global launches
    if not build.use_kernel(x, "ljcut_forces"):
        return ljcut_forces_ref(x, types, owner, shift, h, idx, mask, lj3,
                                lj4, cutsq, q, cut_coulsq, qqr2e)
    N, K = idx.shape
    Mg = owner.shape[0]
    T = _types(lj3)
    if 3 * T * T * 4 > SMEM_LIMIT:
        raise ValueError(f"ljcut_forces: {T - 1} types need "
                         f"{3 * T * T * 4} bytes of shared memory, past the "
                         f"{SMEM_LIMIT}-byte limit")
    dev, f32 = x.device, torch.float32
    ptrs = [build.check(x, "x", (N, 3), f32, dev),
            build.check(types, "types", (N,), torch.int64, dev),
            build.check(owner, "owner", (Mg,), torch.int64, dev),
            build.check(shift, "shift", (Mg, 3), f32, dev),
            build.check(h, "h", (3, 3), f32, dev),
            build.check(idx, "idx", (N, K), torch.int64, dev),
            build.check(mask, "mask", (N, K), torch.bool, dev)]
    ptrs += [build.check(t, n, (T * T,), f32, dev)
             for t, n in ((lj3, "lj3"), (lj4, "lj4"), (cutsq, "cutsq"))]
    ptrs.append(None if q is None
                else build.check(q, "q", (N,), f32, dev))
    out = torch.empty((N, 3), dtype=f32, device=dev)
    table = torch.empty((N + Mg, 4), dtype=f32, device=dev)
    q_all = (None if q is None
             else torch.empty((N + Mg,), dtype=f32, device=dev))
    status = build.lib().lpt_ljcut_forces(
        *ptrs, out.data_ptr(), table.data_ptr(),
        None if q_all is None else q_all.data_ptr(), N, Mg, K, T,
        float(cut_coulsq), float(qqr2e), build.stream(dev))
    build.raise_on_error(status, "ljcut_forces")
    launches += 1
    return out
