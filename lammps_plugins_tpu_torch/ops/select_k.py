"""Smallest-K selection: CUDA kernel wrapper and plain-PyTorch twin.

Counterpart of lammps_plugins_tpu/ops/select_k_pallas.py::select_k.  Per
row of keys [N, W] (+inf = invalid), the column positions of the K
smallest keys in ascending order, ties to the lowest column, W for
exhausted slots; payloads [N, W] are returned at the chosen positions
(0 where exhausted).
"""

from __future__ import annotations

import torch

from . import build

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0
MAX_W = 1024        # 8 float4 of keys per lane in registers
MAX_K = 256         # 8 outputs per lane


def select_k_ref(keys, k, payloads=()):
    """Twin: a stable sort per row (lowest column first among ties)."""
    N, W = keys.shape
    vals, order = torch.sort(keys, dim=1, stable=True)
    vals, order = vals[:, :k], order[:, :k]
    found = vals < float("inf")
    pos = torch.where(found, order, torch.full_like(order, W))
    sel = [torch.where(found, torch.gather(p, 1, order),
                       torch.zeros((), dtype=p.dtype, device=p.device))
           for p in payloads]
    return (pos.to(torch.int32), *sel)


def select_k(keys, k, payloads=()):
    """(pos [N, k] int32, *payloads at pos [N, k]).

    keys [N, W] float; on CUDA W must be a multiple of 128 and at most
    MAX_W, k at most MAX_K, keys 16-byte aligned, and at most two float32
    payloads ride along.  CPU tensors take the twin; CUDA float32 tensors
    the kernel."""
    global launches
    if not build.use_kernel(keys, "select_k"):
        return select_k_ref(keys, k, payloads)
    N, W = keys.shape
    if W % 128 or W > MAX_W:
        raise ValueError(f"select_k: W={W} must be a multiple of 128 and "
                         f"<= {MAX_W}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"select_k: k={k} outside [1, {MAX_K}]")
    if len(payloads) > 2:
        raise ValueError("select_k: at most two payloads")
    if keys.data_ptr() % 16:
        raise ValueError("select_k: keys not 16-byte aligned")
    dev, f32 = keys.device, torch.float32
    kp = build.check(keys, "keys", (N, W), f32, dev)
    pp = [build.check(p, f"payload{i}", (N, W), f32, dev)
          for i, p in enumerate(payloads)]
    pos = torch.empty((N, k), dtype=torch.int32, device=dev)
    outs = [torch.empty((N, k), dtype=f32, device=dev) for _ in payloads]
    pp += [None] * (2 - len(pp))
    op = [o.data_ptr() for o in outs] + [None] * (2 - len(outs))
    status = build.lib().lpt_select_k(kp, pp[0], pp[1], len(payloads),
                                      pos.data_ptr(), op[0], op[1], N, W, k,
                                      build.stream(dev))
    build.raise_on_error(status, "select_k")
    launches += 1
    return (pos, *outs)
