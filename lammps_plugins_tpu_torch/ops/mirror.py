"""Mirror combine: CUDA kernel wrapper and plain-PyTorch twin.

Counterpart of lammps_plugins_tpu/ops/mirror_pallas.py::
mirror_combine_rowfetch (and the layout pin it needed, pin_rows._pin_call).
From the REBO cotangent planes G [K, Np] and the rebuild-time mirror
tables, the per-atom REBO force is

    F_i = sum_k G[k, i] - sum_k mirv[k, i] * G_flat[mirT[k, i]]

with mirT encoding the reverse edge as slot * Np + atom.  Returns [Np, 3].
"""

from __future__ import annotations

import torch

from . import build

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0


def mirror_combine_ref(gx, gy, gz, mirT, mirvT):
    """Twin: the element-gather form of the JAX package
    (potentials/rebomos.py:712-717)."""
    K, Np = gx.shape
    g = torch.stack([gx, gy, gz], dim=-1)                  # [K, Np, 3]
    gmir = g.reshape(K * Np, 3)[mirT.reshape(-1).long()].reshape(K, Np, 3)
    gmir = gmir * mirvT[..., None]
    return g.sum(dim=0) - gmir.sum(dim=0)


def mirror_combine(gx, gy, gz, mirT, mirvT):
    """Per-atom forces [Np, 3] from cotangent planes gx/gy/gz [K, Np],
    mirT [K, Np] int32 and mirvT [K, Np] validity as float 0/1.
    CPU tensors take the twin; CUDA float32 tensors the kernel."""
    global launches
    if not build.use_kernel(gx, "mirror_combine"):
        return mirror_combine_ref(gx, gy, gz, mirT, mirvT)
    K, Np = gx.shape
    dev, f32 = gx.device, torch.float32
    ptrs = [build.check(t, n, (K, Np), f32, dev) for t, n in
            ((gx, "gx"), (gy, "gy"), (gz, "gz"))]
    ptrs.append(build.check(mirT, "mirT", (K, Np), torch.int32, dev))
    ptrs.append(build.check(mirvT, "mirvT", (K, Np), f32, dev))
    out = torch.empty((Np, 3), dtype=f32, device=dev)
    status = build.lib().lpt_mirror_combine(*ptrs, out.data_ptr(), K, Np,
                                            build.stream(dev))
    build.raise_on_error(status, "mirror_combine")
    launches += 1
    return out
