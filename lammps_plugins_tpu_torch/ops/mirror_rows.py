"""Mirror combine from gathered [K, Np, 4] rows: CUDA kernel wrapper and
plain-PyTorch twin.

Counterpart of lammps_plugins_tpu/ops/mirror_pallas.py::mirror_combine_rows
(the LPT_MIR=pk path, here the `rows` combine of potentials/rebomos.py).
The REBO kernel's emit_rows table g4 [K, Np, 4] is gathered by mirT
(gmir4 = g4.reshape(K*Np, 4)[mirT]) in torch; this kernel reduces

    F_i = sum_k G[k, i] - sum_k mirv[k, i] * gmir4[k, i, 0:3]

and returns [Np, 3] (the JAX kernel's [8, Np] rows 0-2, transposed).
"""

from __future__ import annotations

import torch

from . import build

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0


def mirror_combine_rows_ref(gx, gy, gz, gmir4, mirv):
    """Twin: the closed-form sum."""
    g = torch.stack([gx, gy, gz], dim=-1)                   # [K, Np, 3]
    return g.sum(dim=0) - (gmir4[..., 0:3] * mirv[..., None]).sum(dim=0)


def mirror_combine_rows(gx, gy, gz, gmir4, mirv):
    """Per-atom forces [Np, 3] from cotangent planes gx/gy/gz [K, Np], the
    gathered mirror rows gmir4 [K, Np, 4] and the validity plane mirv
    [K, Np] (float 0/1).  CPU tensors take the twin; CUDA float32 tensors
    the kernel."""
    global launches
    if not build.use_kernel(gx, "mirror_combine_rows"):
        return mirror_combine_rows_ref(gx, gy, gz, gmir4, mirv)
    K, Np = gx.shape
    dev, f32 = gx.device, torch.float32
    ptrs = [build.check(t, n, (K, Np), f32, dev) for t, n in
            ((gx, "gx"), (gy, "gy"), (gz, "gz"))]
    ptrs.append(build.check(gmir4, "gmir4", (K, Np, 4), f32, dev))
    if ptrs[-1] % 16:
        raise ValueError("mirror_combine_rows: gmir4 not 16-byte aligned")
    ptrs.append(build.check(mirv, "mirv", (K, Np), f32, dev))
    out = torch.empty((Np, 3), dtype=f32, device=dev)
    status = build.lib().lpt_mirror_combine_rows(*ptrs, out.data_ptr(), K,
                                                 Np, build.stream(dev))
    build.raise_on_error(status, "mirror_combine_rows")
    launches += 1
    return out
