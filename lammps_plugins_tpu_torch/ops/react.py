"""Block-sparse REBO reaction combine: CUDA kernel wrapper, plain-PyTorch
twins, and the rebuild-time route tables with their target-major form.

Counterpart of lammps_plugins_tpu/ops/react_pallas.py (react_combine,
build_route_tables) and of neighbor/device_build.py::choose_react.  With
G = dE/dd per directed edge ([K, Np] planes of the REBO kernel) the atom
forces are

    F_i = sum_k G[k, i] - sum over edges (j, k) with owner(idx[j, k]) = i
                          of G[k, j],

the reaction sum written as routes: on a spatially sorted scene the source
columns of every edge aimed at one 128-atom output chunk lie in a few
128-column source blocks (rblocks), and route[c, w, kc, col] packs
(k << 8) | target lane for the kc-th such edge of source column col of
window w, -1 where there is none.  route_by_target turns these tables, at
rebuild time, into one list per output atom of the plane entries it
subtracts; the kernel reads that list.  react_combine_ref reads the route
tables themselves: it is the twin held against the JAX package's
react_combine.
"""

from __future__ import annotations

import torch

from . import build

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0

_CH = 128


def react_combine_ref(gx, gy, gz, rblocks, route):
    """Forces from the route tables: decode every route entry to (k,
    source column, target) and index_add the reaction sum."""
    K, Np = gx.shape
    nch = route.shape[0]
    g = torch.stack([gx, gy, gz], dim=-1)                   # [K, Np, 3]
    r = route.long()
    ok = r >= 0
    dev = gx.device
    src = (rblocks.long()[:, :, None, None] * _CH
           + torch.arange(_CH, device=dev)).expand(r.shape)
    tgt = (torch.arange(nch, device=dev)[:, None, None, None] * _CH
           + (r & 255))
    R = g.new_zeros((Np, 3)).index_add_(0, tgt[ok], g[(r >> 8)[ok], src[ok]])
    return g.sum(dim=0) - R


def react_combine_target_ref(gx, gy, gz, rtgt):
    """Twin of the kernel: the reaction sum read from the target-major
    table rtgt [Dt, Np] (flat plane indices k * Np + source, -1 for
    none)."""
    K, Np = gx.shape
    g = torch.stack([gx, gy, gz], dim=-1)                   # [K, Np, 3]
    e = rtgt.long()
    ok = (e >= 0)[..., None]
    rows = g.reshape(K * Np, 3)[torch.clamp(e, min=0)]     # [Dt, Np, 3]
    return g.sum(dim=0) - torch.where(ok, rows, torch.zeros_like(rows)) \
        .sum(dim=0)


def react_combine(gx, gy, gz, rtgt):
    """Per-atom forces [Np, 3] from cotangent planes gx/gy/gz [K, Np] and
    the target-major route table rtgt [Dt, Np] int32 (route_by_target).
    CPU tensors take the twin; CUDA float32 tensors the kernel."""
    global launches
    if not build.use_kernel(gx, "react_combine"):
        return react_combine_target_ref(gx, gy, gz, rtgt)
    K, Np = gx.shape
    Dt = rtgt.shape[0]
    if K * Np >= 2 ** 31:
        raise ValueError(f"react_combine: K * Np = {K * Np} needs int64 "
                         "plane indices")
    dev, f32, i32 = gx.device, torch.float32, torch.int32
    ptrs = [build.check(t, n, (K, Np), f32, dev) for t, n in
            ((gx, "gx"), (gy, "gy"), (gz, "gz"))]
    ptrs.append(build.check(rtgt, "rtgt", (Dt, Np), i32, dev))
    out = torch.empty((Np, 3), dtype=f32, device=dev)
    status = build.lib().lpt_react_combine(*ptrs, out.data_ptr(), K, Np, Dt,
                                           build.stream(dev))
    build.raise_on_error(status, "react_combine")
    launches += 1
    return out


def _spread(n: int, base: int, device) -> torch.Tensor:
    """n dump positions base, base + 1, ..., base + 1023, base, ...: the
    entries a fixed-shape scatter discards, spread so that they do not all
    store to one address."""
    return base + torch.arange(n, device=device) % 1024


def route_by_target(rblocks, route, K: int, Np: int):
    """The route tables turned target-major, at rebuild time.

    Returns (rtgt [K, Np] int32, depth_needed): rtgt[d, t] is the flat
    plane index k * Np + source of the d-th entry aimed at atom t, -1 past
    its last; each atom's entries are in the order the route tables list
    them, window, then route row, then source column.  Under the mirror
    bijection an atom receives one entry per mirrored edge of its own row,
    so K rows suffice; depth_needed (the largest count of any atom)
    measures it, and entries past K are dropped (the rebuild flags that).
    Fixed shapes throughout: no host synchronisation."""
    dev = route.device
    nch, NW, KC, L = route.shape
    r = route.reshape(-1).long()
    ok = r >= 0
    cap = K * Np                  # routed entries <= mirrored edges <= K Np
    # the valid entries' flat positions, in table order (masked cumsum)
    rank = torch.cumsum(ok.to(torch.int64), 0) - 1
    dst = torch.where(ok & (rank < cap), rank, _spread(r.numel(), cap, dev))
    sel = torch.full((cap + 1024,), -1, dtype=torch.int64, device=dev)
    sel.scatter_(0, dst, torch.arange(r.numel(), device=dev))
    sel = sel[:cap]
    e = torch.clamp(sel, min=0)
    re = r[e]
    c, w, col = e // (NW * KC * L), (e // (KC * L)) % NW, e % L
    src = rblocks.reshape(-1).long()[c * NW + w] * L + col
    flat = (re >> 8) * Np + src
    tgt = torch.where(sel >= 0, c * L + (re & 255), torch.full_like(e, Np))
    # stable: each target keeps the table order of its entries
    tsort, order = torch.sort(tgt, stable=True)
    depth = torch.arange(cap, device=dev) \
        - torch.searchsorted(tsort, tsort)
    hit = tsort < Np
    depth_needed = torch.where(hit, depth + 1, torch.zeros_like(depth)).max()
    fits = hit & (depth < K)
    pos = torch.where(fits, depth * Np + tsort, _spread(cap, cap, dev))
    out = torch.full((cap + 1024,), -1, dtype=torch.int32, device=dev)
    out[pos] = flat[order].to(torch.int32)
    return out[:cap].reshape(K, Np), depth_needed


def build_route_tables(idx, mask, mirror, owner, n: int, K: int, NW: int,
                       KC: int, QR: int = 0):
    """Rebuild-time route construction (react_pallas.build_route_tables).

    idx/mask: the [N, K] list into the owned+ghost rows; mirror [N, K]:
    an edge takes part iff its mirror was resolved; owner [Mg]: ghost ->
    owned atom.  Returns (rblocks [nch, NW] i32, qoff [nch, NW] i32,
    route [nch, NW, KC, 128] i32, nw_needed, kc_needed, rq_needed,
    overflow); the counts are exact whatever the capacities.  qoff, the
    packed row offset of each window (clamped to QR), is what the TPU
    kernel stacked by; the CUDA kernel reads rows window by window and
    does not need it, but rq_needed = max(qoff + depth) stays the measure
    of a chunk's routed rows.  NW == 0 only measures (tables None)."""
    dev = idx.device
    Np = -(-n // _CH) * _CH
    nch = nblk = Np // _CH
    valid = mask & (mirror >= 0)
    owner_all = torch.cat([torch.arange(n, device=dev), owner.long()])
    otgt = owner_all[idx.long().clamp(0, owner_all.shape[0] - 1)]  # [N, K]
    c = otgt // _CH
    src = torch.arange(n, device=dev)[:, None].expand(n, K)
    b = src // _CH

    # per-edge depth: rank among earlier same-row edges into the same chunk
    same = (c[:, :, None] == c[:, None, :]) & valid[:, None, :]
    ar = torch.arange(K, device=dev)
    tri = ar[None, None, :] < ar[None, :, None]
    kcr = (same & tri).sum(dim=2)
    kc_needed = torch.where(valid, kcr, torch.zeros_like(kcr)).max() + 1

    # (target chunk, source block): marked iff any edge, with its depth
    pid = c * nblk + b
    pid_s = torch.where(valid, pid, torch.full_like(pid, nch * nblk))
    depthm = torch.zeros(nch * nblk + 1, dtype=torch.int64, device=dev)
    depthm.scatter_reduce_(0, pid_s.reshape(-1), (kcr + 1).reshape(-1),
                           "amax")
    depthm = depthm[:-1].reshape(nch, nblk)
    markm = depthm > 0
    nw_needed = markm.sum(dim=1).max()

    # marked blocks first, in block order (unmarked ones all have depth 0)
    key = torch.where(markm, torch.arange(nblk, device=dev).expand(nch, nblk),
                      torch.full_like(depthm, nblk))
    blk_sorted, order = torch.sort(key, dim=1, stable=True)
    depth_sorted = torch.gather(depthm, 1, order)
    if NW > nblk:
        # fewer source blocks than windows: pad windows of depth 0
        pad = NW - nblk
        blk_sorted = torch.nn.functional.pad(blk_sorted, (0, pad), value=nblk)
        depth_sorted = torch.nn.functional.pad(depth_sorted, (0, pad))
    qoff_full = torch.cumsum(depth_sorted, dim=1) - depth_sorted
    rq_needed = (qoff_full + depth_sorted).max()
    if NW <= 0:
        return (None, None, None, nw_needed, kc_needed, rq_needed,
                torch.zeros((), dtype=torch.bool, device=dev))

    rblocks = torch.where(blk_sorted[:, :NW] < nblk, blk_sorted[:, :NW],
                          torch.zeros_like(blk_sorted[:, :NW]))
    qoff = torch.clamp(qoff_full[:, :NW], max=QR)
    # per-edge window: rank of its block among the marked blocks of c
    cum = torch.cumsum(markm.to(torch.int64), dim=1).reshape(-1)
    w_e = cum[torch.clamp(pid, max=nch * nblk - 1)] - 1
    packed = (ar[None, :] << 8) | (otgt % _CH)
    fits = valid & (w_e < NW) & (kcr < KC)
    total = nch * NW * KC * _CH
    pos = ((c * NW + w_e) * KC + kcr) * _CH + src % _CH
    # fitting edges have distinct positions; the rest share the sentinel
    pos_s = torch.where(fits, pos, torch.full_like(pos, total))
    route = torch.full((total + 1,), -1, dtype=torch.int64, device=dev)
    route[pos_s.reshape(-1)] = torch.where(
        fits, packed, torch.full_like(packed, -1)).reshape(-1)
    overflow = (nw_needed > NW) | (kc_needed > KC) | (rq_needed > QR)
    i32 = torch.int32
    return (rblocks.to(i32), qoff.to(i32),
            route[:-1].reshape(nch, NW, KC, _CH).to(i32),
            nw_needed, kc_needed, rq_needed, overflow)


def choose_react(n: int, nw_needed: int, kc_needed: int, rq_needed: int,
                 gate: bool = True):
    """(NW, KC, QR) route capacities from measured geometry, or (0, 0, 0)
    when the gate refuses: fewer than 16,384 atoms or more than 2,048
    chunks, or a measured geometry past NW 48, KC 12, QR 112 (a scene
    that is not spatially sorted).  gate=False keeps only the
    quantization (the JAX package's LPT_REACT=force)."""
    if nw_needed <= 0 or kc_needed <= 0 or rq_needed <= 0:
        return 0, 0, 0
    nch = -(-n // _CH)
    if gate and (n < 16384 or nch > 2048):
        return 0, 0, 0
    NW = -(-int(nw_needed) // 4) * 4 + 4
    KC = -(-int(kc_needed) // 2) * 2 + 2
    QR = -(-int(rq_needed) // 16) * 16 + 16
    if gate and (NW > 48 or KC > 12 or QR > 112):
        return 0, 0, 0
    return NW, KC, QR
