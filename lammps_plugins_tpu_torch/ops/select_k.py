"""Smallest-K selection: CUDA kernel wrapper and plain-PyTorch twin.

Counterpart of lammps_plugins_tpu/ops/select_k_pallas.py::select_k.  Per
row of keys [N, W] (+inf = invalid), the column positions of the K
smallest keys in ascending order, ties to the lowest column, W for
exhausted slots; payloads [N, W] are returned at the chosen positions
(0 where exhausted).

The kernel (csrc/select_k.cu) takes any K and any W that is a multiple of
128; each warp's hit buffer in shared memory holds the next power of two
>= max(K, 64) (key, column) pairs, so shared memory is the one limit left
(select_k_plan).
"""

from __future__ import annotations

import torch

from . import build

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0
#: the shared memory one block may use on the H100 (227 KB, the opt-in
#: limit cudaDevAttrMaxSharedMemoryPerBlockOptin)
SMEM_LIMIT = 232_448
#: a warp's radix-select histogram (256 int32 bins)
HIST_BYTES = 256 * 4
#: rows (D) or atoms (D') a block takes at once, most first
WARPS = (4, 2, 1)


def hit_capacity(k: int) -> int:
    """A warp's hit buffer: the next power of two >= max(k, 64)."""
    return max(64, 1 << (int(k) - 1).bit_length())


def buffer_bytes(warps: int, cap: int) -> int:
    """The hit buffers (float32 key, int32 column) and histograms of
    `warps` warps."""
    return warps * (8 * cap + HIST_BYTES)


def select_k_plan(k: int):
    """(warps, cap, shared bytes) of a select_k launch at k: the most warps
    a block whose buffers fit SMEM_LIMIT; a ValueError naming the limit
    when one warp's do not."""
    cap = hit_capacity(k)
    for warps in WARPS:
        nbytes = buffer_bytes(warps, cap)
        if nbytes <= SMEM_LIMIT:
            return warps, cap, nbytes
    raise ValueError(f"select_k: k={k} needs a {cap}-entry hit buffer, "
                     f"{buffer_bytes(1, cap)} bytes of shared memory for one "
                     f"warp, past the H100's {SMEM_LIMIT}-byte block limit")


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

    keys [N, W] float; on CUDA W must be a positive multiple of 128, keys
    16-byte aligned, at most two float32 payloads ride along, and k's hit
    buffers must fit shared memory (select_k_plan).  CPU tensors take the
    twin; CUDA float32 tensors the kernel."""
    global launches
    if not build.use_kernel(keys, "select_k"):
        return select_k_ref(keys, k, payloads)
    N, W = keys.shape
    if W < 128 or W % 128:
        raise ValueError(f"select_k: W={W} must be a positive multiple of "
                         "128")
    if k < 1:
        raise ValueError(f"select_k: k={k} must be at least 1")
    warps, cap, _ = select_k_plan(k)
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
                                      warps, cap, build.stream(dev))
    build.raise_on_error(status, "select_k")
    launches += 1
    return (pos, *outs)
