"""Spatially sharded engine (port of
lammps_plugins_tpu/parallel/sharded_engine.py): x-slabs and Px x Py grids
with migration, halo exchange and per-shard rebuilds, the shards stacked
on one card or placed per device (Placement, below).

The JAX engine is one controller over a mesh of devices whose state
carries a leading device axis, [Pn, n_cap, ...].  The stacked layout keeps
that shape on one device: the Pn shards' blocks are stacked, [Pn * n_cap, ...]
viewed as [Pn, n_cap, ...] (ShardState).  A `ppermute` along the grid is a
gather from the peer block into the receiving shard's buffer, and a
`psum` is a sum over every block:

  * Each shard owns one domain of the (Px, Py) grid (default (Pn, 1),
    x-slabs; devices row-major, d = dx * Py + dy, JAX :180-184).  Its local
    block is [owned (n_cap) | x halos (2 Bhx) | y halos (2 Bhy)]: copies
    of the neighbours' boundary rows, refreshed at every step, in two
    stages (x, then y over the [owned | x-halo] block), so corner halos
    need no diagonal exchange.
  * Lists, cells and mirror tables are built per shard by the Engine's
    device_rebuild on a "slab box" (the global cell sliced along the split
    axes, non-periodic there, the halo margin inside), with the pad rows
    kept out (valid=).  Halo rows are pseudo-owned centres, so every edge
    of an owned atom and its mirror are local and no reverse force
    exchange is needed; the halo width is pair.ghost_margin(skin).
  * Migration (LAMMPS Comm::exchange) runs at every resettle: rows whose
    slab changed are packed into fixed buffers and gathered by the
    neighbour; packing is a masked cumsum and a scatter, no host value.
  * The fixes run once on the whole stacked state: their sums over every
    row are the psum of JAX's per-shard sums (StepContext.asum stays the
    identity, natoms_global = N, ctx.shards = (Pn, n_cap)); group fixes
    resolve their group by the rows' global tags.

Per step: every fix's initial_integrate and post_integrate on the stack,
then for each shard its halo refresh, pair.forces on its local block and
f[:n_cap] * valid, then post_force, final_integrate and end_of_step on the
stack (JAX _build_segment, :788-825).

The loop is the Engine's (run/driver.LoopDriver's host half): on a CUDA
state one CUDA graph per plan and capacities (every shard's resettle under the IF node, then the
check_every-step segment; ShardLoop), up to 16 launches a span and one
host read; elsewhere the host loop, one read per segment, under the same
decision rule (dprev carried across spans), so both give the same
trajectory bit for bit.  The capacities (n_cap, Bhx, Bhy, B_mig, n_loc)
come from JAX's numpy arithmetic (_pack_initial); a lost-atom flag, read
in one host copy, raises, and an overflow re-sizes from the measured
counts (_grow, which repacks the shards when n_cap grows).  The host loop
re-sizes within the resettle that overflowed; the device loop discards
its span, re-lists the last resettle before it from that resettle's own
inputs (_relist: the same rows, new capacities) and runs the span again,
so that both take the same decisions.  Nothing falls back: a failed
capture or replay raises, and so does the halo probe that attributes
Comm time.

Placement.  `devices` names one device per shard.  When they all name one
device the shards are stacked as above (the measured one-card path).  When
they name more than one distinct device, or with placement="per_device",
ShardedEngine(...) returns a parallel/per_device.PerDeviceEngine: each
shard keeps its rows, halo tables, lists and fix state on its own device
and CUDA stream, runs its own program, and the ppermutes and psums above
are copies between the devices (parallel/collectives.py).  Both
placements share the per-shard pieces of the resettle and of the halo
refresh below (_wrap, _emigrants, _immigrants, _export, _with_halo,
_rebuild_shard).
"""

from __future__ import annotations

import dataclasses
import types as _types
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.box import Box, matvec3
from ..core.state import State
from ..core.units import UnitSystem
from ..fixes.base import Fix, StepContext
from ..neighbor import device_build
from ..neighbor.build import NeighborData
from ..potentials.base import PairStyle
from ..run.device_loop import (GraphIteration, _nested, device_seconds,
                               extras_items, tensors)
from ..run.driver import LoopDriver
from ..run.simulation import _quantize_k
from ..run.thermo import thermo_row
from ..run.timers import Timers

#: the per-row fields of the shard state, in migration order
_ROWS = ("x", "v", "f", "image", "type", "q", "tag")
_STEPPED = ("x", "v", "f")
#: what a resettle reads of the rows (its inputs, kept for a re-list)
_LAYOUT = _ROWS + ("valid",)
#: the x and y stages' tables in HaloTables
HALO_X = ("exp_r", "exp_l", "val_hl", "val_hr")
HALO_Y = ("exp_u", "exp_d", "val_hd", "val_hu")
#: K headroom of a sharded plan over the high-water kmax: a K overflow
#: costs a discarded span and a repack on every shard
K_HEADROOM = 4


@dataclasses.dataclass(frozen=True)
class ShardState:
    """The shards' blocks stacked, [Pn * n_cap, ...] (JAX's [Pn, n_cap,
    ...]): x, v, f [., 3]; type int64; q; tag int64, the global atom id
    (-1 on a pad row); image int32 [., 3]; valid bool.  step: a Python
    int; extras: the fixes' state, per-atom tensors [Pn * n_cap, ...] and
    the rest once."""

    x: torch.Tensor
    v: torch.Tensor
    f: torch.Tensor
    type: torch.Tensor
    q: torch.Tensor
    tag: torch.Tensor
    image: torch.Tensor
    valid: torch.Tensor
    step: int
    extras: Dict

    def replace(self, **kw) -> "ShardState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class HaloTables:
    """Every shard's halo exchange tables, fixed between resettles.

    exp_r / exp_l [Pn, Bhx]: slots of the shard's owned block exported to
    its forward / backward x neighbour (they become that neighbour's low /
    high halo); val_hl / val_hr [Pn, Bhx]: validity of the shard's own low
    / high x-halo rows.  exp_u / exp_d / val_hd / val_hu [Pn, Bhy]: the
    same for y, indexing the [owned | x-halo] block.  t_loc, q_loc,
    valid_loc [Pn, n_loc]: types, charges and validity of each local
    block (static between resettles, as types are)."""

    exp_r: torch.Tensor
    exp_l: torch.Tensor
    val_hl: torch.Tensor
    val_hr: torch.Tensor
    exp_u: torch.Tensor
    exp_d: torch.Tensor
    val_hd: torch.Tensor
    val_hu: torch.Tensor
    t_loc: torch.Tensor
    q_loc: torch.Tensor
    valid_loc: torch.Tensor


def _pack(mask, cap: int, arrs):
    """(rows of each array compacted to the front of [cap, ...], count,
    overflow): a masked cumsum and a scatter with unique targets; rows
    past the capacity are dropped and flagged (JAX _pack)."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    cnt = mask.sum()
    tgt = torch.where(mask & (rank < cap), rank, torch.full_like(rank, cap))
    out = []
    for a in arrs:
        o = a.new_zeros((cap + 1,) + a.shape[1:])
        o[tgt] = a
        out.append(o[:cap])
    return out, cnt, cnt > cap


def _merge(mask, base, cap: int, dst_list, src_list):
    """Scatter the masked src rows into dst from slot `base` on (JAX
    _merge); returns (new dst arrays, count)."""
    tgt = base + torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (tgt < cap), tgt, torch.full_like(tgt, cap))
    out = []
    for dst, src in zip(dst_list, src_list):
        o = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
        o[tgt] = src
        out.append(o[:cap])
    return out, mask.sum()


def _shard_devices(devices) -> List[torch.device]:
    """The shards' devices as torch devices, a CUDA device without an index
    taken as the current one (so that "cuda" and "cuda:0" are one device
    on a machine whose current card is 0)."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None and torch.cuda.is_available():
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def _placement_of(devices, placement: str | None) -> str:
    """"stacked" or "per_device" for these shard devices: shards on more
    than one distinct device are placed per device; shards on one device
    are stacked unless placement="per_device" asks otherwise."""
    distinct = len(set(_shard_devices(devices))) > 1
    if placement is None:
        return "per_device" if distinct else "stacked"
    if placement not in ("stacked", "per_device"):
        raise ValueError(f"placement {placement!r}: 'stacked' or "
                         "'per_device'")
    if placement == "stacked" and distinct:
        raise ValueError("placement='stacked' stacks the shards on one "
                         f"device; devices {[str(d) for d in devices]} "
                         "name several")
    return placement


class ShardedEngine(LoopDriver):
    """The sharded counterpart of run/simulation.Engine (its run, thermo,
    callbacks, timers and to_state; callbacks receive the gathered global
    State, the sharded analogue of ranks funnelling dump data to the
    writing rank)."""

    overflow_retries = 5           # JAX sharded_engine.py:641, :1113

    def __new__(cls, *args, **kw):
        """The per-device placement is the subclass
        parallel/per_device.PerDeviceEngine (see _placement_of)."""
        devices = kw.get("devices", args[4] if len(args) > 4 else None)
        if cls is ShardedEngine and devices is not None:
            if _placement_of(devices, kw.get("placement")) == "per_device":
                from .per_device import PerDeviceEngine
                return super().__new__(PerDeviceEngine)
        return super().__new__(cls)

    def __init__(self, state: State, pair: PairStyle, fixes: Sequence[Fix],
                 units: UnitSystem, devices: Sequence,
                 dt: float | None = None, skin: float | None = None,
                 check_every: int = 10, slack: float = 1.4,
                 grid: "tuple[int, int] | None" = None,
                 placement: str | None = None):
        """devices: one torch device per shard (the JAX engine's
        n_devices).  grid: (Px, Py), the LAMMPS `processors` analogue;
        (Pn, 1) when None.  placement: None takes the stacked layout when
        every shard names one device and the per-device placement when
        they name several; "per_device" forces the per-device placement
        on one device too (for the CPU parity tests and the one-card
        checks: it adds no physics and no output)."""
        devices = _shard_devices(devices)
        Pn = len(devices)
        if Pn < 2:
            raise ValueError("ShardedEngine needs >= 2 shards; use "
                             "run.simulation.Engine on one device")
        if grid is None:
            grid = (Pn, 1)
        if grid[0] * grid[1] != Pn:
            raise ValueError(f"grid {grid} does not tile {Pn} devices")
        if grid[0] < 1 or grid[1] < 1 or (grid[0] == 1 and grid[1] == 1):
            raise ValueError(f"invalid processor grid {grid}")
        if getattr(pair, "combine", None) == "react":
            raise ValueError("combine='react' is single-device: the sharded "
                             "rebuild builds no route tables (as in JAX)")
        self._place(state, devices)
        self.grid = (int(grid[0]), int(grid[1]))
        self.n_devices = Pn
        self.pair = pair.for_sharded()
        self.fixes = list(fixes)
        self.units = units
        self.skin = skin if skin is not None else units.skin
        self.check_every = check_every
        self.slack = slack
        self.dt = dt if dt is not None else units.dt
        self.box = state.box
        self.natoms = state.natoms
        self.dtype = state.x.dtype
        #: the device loop: None = on for a CUDA state, off on the CPU;
        #: True on the CPU runs its iteration eagerly (the parity tests)
        self.fused_loop: bool | None = None
        self.pair.prepare(state.type.cpu().numpy())
        self._setup_geometry(state)
        self._pack_initial(state)
        self._setup_fix_extras()
        self._make_plan()
        self.halo: HaloTables | None = None
        self.nbrs: List[NeighborData] | None = None
        self._flags: Dict[str, int] = {}
        self._flag_names = None
        self._f_valid = False
        self._k_hwm: Dict[str, int] = {}
        self._bnd_hwm = 0
        self._plan_tightened = False
        self._rs_in = None             # the rows the last resettle took
        self._loop = None
        self._loop_key = None
        self._comm_cost = None
        self.resettles = 0
        self.regrows = 0
        self.thermo_rows: List[dict] = []
        self.timers = Timers()

    # -- host-side set-up ---------------------------------------------------
    def _place(self, state: State, devices: List[torch.device]):
        """The stacked layout keeps the state's box and masses and the
        pair's tables where they are: its one device must be the state's
        (the per-device placement copies them to each shard's device)."""
        dev = devices[0]
        if state.x.device != dev and not (
                dev.type == state.x.device.type == "cuda"
                and dev.index is None):
            raise ValueError(f"the state lies on {state.x.device}, the "
                             f"stacked shards on {dev}: the stacked layout "
                             "runs on the state's device")
        self.device = state.x.device

    def _setup_geometry(self, state: State):
        """The slab box and the geometry tensors (JAX :239-281)."""
        box = state.box
        h = box.h_np()
        lo = box.lo_np()
        widths = box.perpendicular_widths_np()
        Px, Py = self.grid
        margin = self.pair.ghost_margin(self.skin)
        mfs = [0.0, 0.0]
        hs = h.copy()
        for ax, P in ((0, Px), (1, Py)):
            if P <= 1:
                continue
            if not box.periodic[ax]:
                raise ValueError(
                    f"slab decomposition requires periodic axis {ax}")
            mfs[ax] = margin / widths[ax]
            slab_w = widths[ax] / P
            if slab_w < margin:
                raise ValueError(
                    f"slab width {slab_w:.2f} A < halo margin "
                    f"{margin:.2f} A: box too small in axis {ax} for "
                    f"{P}-way decomposition")
            # the slab box: a slice of the global cell along this axis with
            # the halo margins inside, non-periodic (halos are explicit rows)
            hs[ax] = h[ax] * (1.0 / P + 2.0 * mfs[ax])
        self.margin_frac = tuple(mfs)
        self.slab_box = Box.from_numpy(
            hs, lo, (Px == 1 and box.periodic[0],
                     Py == 1 and box.periodic[1], box.periodic[2]),
            dtype=self.dtype, device=self.device)
        los = np.stack([
            lo + (dx / Px - mfs[0]) * h[0] + (dy / Py - mfs[1]) * h[1]
            for dx in range(Px) for dy in range(Py)])
        self._geom_np = dict(
            lo_shards=los, h_glob=h, hinv_glob=np.linalg.inv(h), lo_glob=lo,
            h_slab=hs, hinv_slab=np.linalg.inv(hs), arow=h[0], brow=h[1],
            per=[1.0 if p else 0.0 for p in box.periodic])
        self._gm = self._geometry(self.device)
        g = self._gm
        self._lo_shards = g.lo_shards                   # [Pn, 3]
        self._h_glob, self._hinv_glob = g.h_glob, g.hinv_glob
        self._lo_glob = g.lo_glob
        self._h_slab, self._hinv_slab = g.h_slab, g.hinv_slab
        self._arow, self._brow = g.arow, g.brow         # global a, b
        self._per = g.per
        self._park = g.park

    def _geometry(self, dev) -> _types.SimpleNamespace:
        """The geometry tensors on `dev`: the shards' slab-box origins
        lo_shards [Pn, 3], the global and slab cells and inverses, the
        global a and b rows, the periodic mask, and `park`, where pad rows
        wait outside every slab box (along the first split axis)."""
        g = _types.SimpleNamespace(**{
            k: torch.as_tensor(np.asarray(v, np.float64), dtype=self.dtype,
                               device=dev)
            for k, v in self._geom_np.items()})
        g.park = g.lo_glob + 2.0 * (g.arow if self.grid[0] > 1 else g.brow)
        return g

    def _perms(self):
        """The grid's flattened permutations, (src, dst) pairs: x forward,
        x backward, y forward (up), y backward (down) (JAX :283-296)."""
        Px, Py = self.grid

        def flat(ix, iy):
            return ix * Py + iy

        ids = [(ix, iy) for ix in range(Px) for iy in range(Py)]
        return ([(flat(ix, iy), flat((ix + 1) % Px, iy)) for ix, iy in ids],
                [(flat(ix, iy), flat((ix - 1) % Px, iy)) for ix, iy in ids],
                [(flat(ix, iy), flat(ix, (iy + 1) % Py)) for ix, iy in ids],
                [(flat(ix, iy), flat(ix, (iy - 1) % Py)) for ix, iy in ids])

    def _sources(self, ax: int):
        """(from_back, from_fwd) for grid axis ax: the shard whose rows a
        forward / backward ppermute delivers to each shard d."""
        perms = self._perms()
        fwd, bwd = perms[2 * ax], perms[2 * ax + 1]
        from_back = [0] * self.n_devices
        from_fwd = [0] * self.n_devices
        for s, d in fwd:
            from_back[d] = s
        for s, d in bwd:
            from_fwd[d] = s
        return from_back, from_fwd

    def _coord(self, d: int, ax: int) -> int:
        return d // self.grid[1] if ax == 0 else d % self.grid[1]

    def _pack_initial(self, state: State):
        """Capacities from the initial configuration and the packed shard
        state, by the JAX package's numpy arithmetic (:298-378); a
        capacity only grows.  The fixes' context follows n_cap."""
        cols = self._packed_np(state)
        self.shards = ShardState(
            step=int(state.step), extras={},
            **{a: torch.as_tensor(v, dtype=t, device=self.device)
               for a, (v, t) in cols.items()})
        self._mass = state.mass
        self.ctx = StepContext(units=self.units, dt=self.dt,
                               natoms_global=self.natoms,
                               shards=(self.n_devices, self.n_cap))

    def _packed_np(self, state: State) -> Dict[str, tuple]:
        """Set the capacities; {field: (numpy array [Pn * n_cap, ...], torch
        dtype)} of the packed shards, block d at rows d * n_cap on."""
        Pn = self.n_devices
        Px, Py = self.grid
        x_np, image_np = state.box.wrap_np(
            state.x.detach().cpu().double().numpy(),
            state.image.cpu().numpy())
        h = state.box.h_np()
        lo = state.box.lo_np()
        frac = (x_np - lo) @ np.linalg.inv(h)
        N = self.natoms
        sxf = frac[:, 0] * Px
        syf = frac[:, 1] * Py
        sx = np.clip(sxf.astype(np.int64), 0, Px - 1)
        sy = np.clip(syf.astype(np.int64), 0, Py - 1)
        slab_of = sx * Py + sy
        counts = np.bincount(slab_of, minlength=Pn)
        n_cap = int(-(-int(counts.max() * self.slack) // 8) * 8)
        self.n_cap = max(getattr(self, "n_cap", 0), n_cap, 8)
        # halo capacities from the measured per-boundary populations: the
        # x stage exports owned boundary bands, the y stage bands of the
        # [owned | x-halo] block (margin-expanded x range)
        mfx, mfy = self.margin_frac
        hx, hy = [0], [0]
        for dx in range(Px):
            dxf = np.mod(sxf - dx + Px / 2.0, Px) - Px / 2.0
            in_x = (dxf >= 0) & (dxf < 1.0)
            in_x_exp = (dxf >= -mfx * Px) & (dxf <= 1.0 + mfx * Px)
            for dy in range(Py):
                dyf = np.mod(syf - dy + Py / 2.0, Py) - Py / 2.0
                in_y = (dyf >= 0) & (dyf < 1.0)
                own = in_x & in_y
                if Px > 1:
                    hx.append((own & (dxf <= mfx * Px)).sum())
                    hx.append((own & (dxf >= 1.0 - mfx * Px)).sum())
                if Py > 1:
                    hy.append((in_x_exp & in_y & (dyf <= mfy * Py)).sum())
                    hy.append((in_x_exp & in_y
                               & (dyf >= 1.0 - mfy * Py)).sum())

        def cap(v):
            return max(8, int(-(-int(v * self.slack) // 8) * 8))

        self.Bhx = (max(getattr(self, "Bhx", 0), cap(max(hx)))
                    if Px > 1 else 0)
        self.Bhy = (max(getattr(self, "Bhy", 0), cap(max(hy)))
                    if Py > 1 else 0)
        self.B_mig = max(8, -(-self.n_cap // 8) * 2)     # ~25% of a slab
        self.n_loc = self.n_cap + 2 * self.Bhx + 2 * self.Bhy

        order = np.argsort(slab_of, kind="stable")
        starts = np.zeros(Pn + 1, np.int64)
        starts[1:] = np.cumsum(counts)
        slot = np.arange(N) - starts[slab_of[order]]
        d_all = slab_of[order]
        flat = d_all * self.n_cap + slot
        dt = self.dtype

        def packed(a_np, fill, dtype):
            a_np = np.asarray(a_np)
            out = np.full((Pn * self.n_cap,) + a_np.shape[1:], fill,
                          dtype=a_np.dtype)
            out[flat] = a_np[order]
            return out, dtype

        valid = np.zeros(Pn * self.n_cap, bool)
        valid[flat] = True
        xs = np.empty((Pn * self.n_cap, 3))
        xs[flat] = x_np[order]
        xs[~valid] = lo + 2.0 * h[0]            # park pads outside the slabs
        return dict(
            x=(xs, dt),
            v=packed(state.v.detach().cpu().numpy(), 0.0, dt),
            f=packed(state.f.detach().cpu().numpy(), 0.0, dt),
            type=packed(state.type.cpu().numpy(), 1, torch.int64),
            q=packed(state.q.detach().cpu().numpy(), 0.0, dt),
            tag=packed(np.arange(N), -1, torch.int64),
            image=packed(image_np, 0, torch.int32),
            valid=(valid, torch.bool))

    def _setup_fix_extras(self):
        """Fix state made once on the stacked template: per-atom extras are
        [Pn * n_cap, ...], the rest exists once (JAX :380-393 makes them
        per shard and broadcasts)."""
        st = self._local_state(self.shards)
        for f in self.fixes:
            st = f.setup(st, self.ctx)
        self.shards = self._from_state(self.shards, st)

    def _make_plan(self):
        """The density-based plan of a local block (JAX :395-407)."""
        requests = self.pair.neighbor_requests()
        Px, Py = self.grid
        mfx, mfy = self.margin_frac
        natoms_est = int(self.natoms * (1.0 / Px + 2 * mfx)
                         * (1.0 / Py + 2 * mfy) * 1.1) + 8
        self._plan = device_build.make_plan_from_density(
            self.slab_box, requests, self.skin, natoms_est,
            slack=max(self.slack, 1.5),
            cell_tiers=getattr(self.pair, "cell_tiers", ()),
            mirror_tiers=getattr(self.pair, "mirror_tiers", ()))

    def _replan(self, flags, grow: float, k_grow: float = 1.0):
        """A plan from measured counts: K = _quantize_k(high-water kmax x
        k_grow + K_HEADROOM), the other capacities padded by `grow`."""
        for k, v in flags.items():
            if k.startswith("count:k:"):
                name = k.split(":", 2)[2]
                self._k_hwm[name] = max(self._k_hwm.get(name, 0), int(v))
        k_counts = {name: _quantize_k(int(m * k_grow) + K_HEADROOM)
                    for name, m in self._k_hwm.items()}
        self._bnd_hwm = max(self._bnd_hwm, int(flags.get("count:bnd", 0)))
        self._plan = device_build.make_plan(
            self.slab_box, self.pair.neighbor_requests(), self.skin,
            int(flags["count:ghost"]), int(flags["count:cell"]), k_counts,
            slack=grow, k_final=True,
            cell_tiers=getattr(self.pair, "cell_tiers", ()),
            mirror_tiers=getattr(self.pair, "mirror_tiers", ()),
            cand_occupancy=int(flags["count:candcell"])
            if "count:candcell" in flags else None,
            bnd_count=int(self._bnd_hwm * grow) + 64 if self._bnd_hwm else 0)

    # -- the stacked state as the fixes see it -----------------------------
    def _local_state(self, ss: ShardState) -> State:
        """The stacked rows as one State; extras["__tag__"] carries the
        global ids, by which group fixes find their rows (JAX :734-742)."""
        extras = dict(ss.extras)
        extras["__tag__"] = ss.tag
        return State(x=ss.x, v=ss.v, f=ss.f, type=ss.type, q=ss.q,
                     image=ss.image, mass=self._mass, box=self.box,
                     step=ss.step, extras=extras)

    @staticmethod
    def _from_state(ss: ShardState, st: State) -> ShardState:
        extras = dict(st.extras)
        extras.pop("__tag__", None)
        return ss.replace(x=st.x, v=st.v, f=st.f, image=st.image,
                          step=st.step, extras=extras)

    # -- the resettle: wrap, migration, halos, per-shard rebuild ------------
    def _split(self, t: torch.Tensor) -> List[torch.Tensor]:
        return list(t.view((self.n_devices, self.n_cap) + t.shape[1:])
                    .unbind(0))

    # per-shard pieces of the resettle and the halo refresh, shared with the
    # per-device placement; g is the geometry on the shard's device
    def _wrap(self, x, image, g):
        """The global wrap (Domain::pbc) and image bookkeeping: (wrapped x,
        image, fractional coordinates)."""
        fg = matvec3(x - g.lo_glob, g.hinv_glob)
        shift = torch.floor(fg) * g.per[None, :]
        return (matvec3(fg - shift, g.h_glob) + g.lo_glob,
                image + shift.to(torch.int32), fg - shift)

    def _emigrants(self, d: int, rows, valid, slab, ax: int):
        """Shard d's side of one exchange stage along grid axis ax (JAX
        migrate_axis): stayers packed to n_cap, rows one slab forward or
        back packed to B_mig with their validity; rows more than one slab
        away are dropped and counted lost.  With P == 2 both neighbours
        are one shard: every mover goes forward.  Returns (kept, count,
        overflow, lost, (forward rows, valid), (backward rows, valid))."""
        P = self.grid[ax]
        n_cap, B = self.n_cap, self.B_mig
        dl = torch.remainder(slab - self._coord(d, ax), P)
        stay = valid & (dl == 0)
        go_f = valid & (dl == 1)
        go_b = torch.zeros_like(go_f) if P == 2 else valid & (dl == P - 1)
        lost = (valid & ~stay & ~go_f & ~go_b).sum()
        k, c, o1 = _pack(stay, n_cap, rows)
        sf, cf, o2 = _pack(go_f, B, rows)
        sb, cb, o3 = _pack(go_b, B, rows)
        ar = torch.arange(B, device=c.device)
        return k, c, o1 | o2 | o3, lost, (sf, ar < cf), (sb, ar < cb)

    def _immigrants(self, kept, nk, fw, bw):
        """The stayers, then the rows from behind (fw, the backward
        neighbour's forward movers), then those from ahead: (rows, count,
        overflow)."""
        (sf, vf), (sb, vb) = fw, bw
        k, c1 = _merge(vf, nk, self.n_cap, kept, sf)
        k, c2 = _merge(vb, nk + c1, self.n_cap, k, sb)
        n_new = nk + c1 + c2
        return k, n_new, n_new > self.n_cap

    def _migrate_axis(self, rows, valid, slab, ax: int):
        """One exchange stage along grid axis ax for every shard: each
        shard's emigrants, then each takes its neighbours' (a ppermute as
        a gather).  Returns (rows, n_new, overflow, lost) per shard."""
        out = [self._emigrants(d, rows[d], valid[d], slab[d], ax)
               for d in range(self.n_devices)]
        from_back, from_fwd = self._sources(ax)
        kept, n_new, ovs = [], [], []
        for d, (k, nk, ov, _, _, _) in enumerate(out):
            k, n, ov2 = self._immigrants(k, nk, out[from_back[d]][4],
                                         out[from_fwd[d]][5])
            kept.append(k)
            n_new.append(n)
            ovs.append(ov | ov2)
        return kept, n_new, ovs, [o[3] for o in out]

    def _export(self, d: int, xb, validb, ax: int, Bh: int, g):
        """Shard d's export tables of one halo stage (JAX halo_axis): the
        slots of block rows within the halo margin of the low and high
        faces, packed to Bh.  Returns (hi slots, lo slots, hi count, lo
        count, max count, overflow)."""
        P = self.grid[ax]
        mf = self.margin_frac[ax]
        s_loc = matvec3(xb - g.lo_glob, g.hinv_glob)[:, ax] * P \
            - float(self._coord(d, ax))
        exp_lo = validb & (s_loc <= mf * P)
        exp_hi = validb & (s_loc >= 1.0 - mf * P)
        slots = torch.arange(xb.shape[0], device=xb.device)
        (hi,), nchi, ov_hi = _pack(exp_hi, Bh, (slots,))
        (lo,), nclo, ov_lo = _pack(exp_lo, Bh, (slots,))
        return hi, lo, nchi, nclo, torch.maximum(nchi, nclo), ov_hi | ov_lo

    def _with_halo(self, d: int, block, lo_rows, hi_rows, val_lo, val_hi,
                   ax: int, g, fill=None, shift: bool = True):
        """Shard d's block with its two halo blocks of stage ax appended:
        lo_rows, the backward neighbour's high export, and hi_rows, the
        forward neighbour's low export.  Positions (shift=True) cross the
        periodic face with +-a or +-b on the grid's first / last shard and
        park where invalid; other rows take `fill` where invalid."""
        if shift:
            row = g.arow if ax == 0 else g.brow
            i = self._coord(d, ax)
            if i == 0:
                lo_rows = lo_rows + (-1.0) * row[None, :]
            if i == self.grid[ax] - 1:
                hi_rows = hi_rows + 1.0 * row[None, :]
            lo_rows = torch.where(val_lo[:, None], lo_rows, g.park[None, :])
            hi_rows = torch.where(val_hi[:, None], hi_rows, g.park[None, :])
        else:
            lo_rows = torch.where(val_lo, lo_rows,
                                  torch.full_like(lo_rows, fill))
            hi_rows = torch.where(val_hi, hi_rows,
                                  torch.full_like(hi_rows, fill))
        return torch.cat([block, lo_rows, hi_rows])

    def _rebuild_shard(self, d: int, pair: PairStyle, xb, tb, vb, g):
        """Shard d's lists on the slab box, its pad rows kept out:
        (NeighborData, flags).  The rows are not wrapped again (_wrap did
        it in the global cell): in float32 _wrap can leave a row on a
        periodic face, which a wrap in the slab box would move by a period
        that the engine's own rows do not take."""
        zero_im = torch.zeros((self.n_loc, 3), dtype=torch.int32,
                              device=xb.device)
        _, _, nbr, fl = device_build.device_rebuild(
            self._plan, xb, zero_im, tb, g.h_slab, g.hinv_slab,
            g.lo_shards[d], pair.neighbor_requests(), valid=vb, wrap=False)
        make = getattr(pair, "rebuild_tables", None)
        if make:
            nbr = dataclasses.replace(nbr, pair_tables=make(nbr))
        return nbr, dict(fl)

    def _exports(self, xb, validb, ax: int, Bh: int):
        """One halo stage's export tables of every shard (_export)."""
        return [self._export(d, xb[d], validb[d], ax, Bh, self._gm)
                for d in range(self.n_devices)]

    def _gather_halo(self, blocks, exp_hi, exp_lo, val_lo, val_hi, ax: int,
                     fill=None, shift: bool = True):
        """Each shard's block with its two halo blocks of stage ax appended
        (_with_halo): its low halo is the backward neighbour's high
        export, its high halo the forward neighbour's low export (a
        ppermute as a gather)."""
        from_back, from_fwd = self._sources(ax)
        return [self._with_halo(
            d, blocks[d], blocks[from_back[d]][exp_hi[from_back[d]]],
            blocks[from_fwd[d]][exp_lo[from_fwd[d]]], val_lo[d], val_hi[d],
            ax, self._gm, fill, shift) for d in range(self.n_devices)]

    def _halo_blocks(self, x: torch.Tensor, halo: HaloTables):
        """[Pn] local blocks [n_loc, 3] of positions: the per-step halo
        refresh, x stage then y stage (JAX _halo_fn)."""
        Px, Py = self.grid
        blocks = self._split(x)
        if Px > 1:
            blocks = self._gather_halo(blocks, halo.exp_r, halo.exp_l,
                                       halo.val_hl, halo.val_hr, 0)
        if Py > 1:
            blocks = self._gather_halo(blocks, halo.exp_u, halo.exp_d,
                                       halo.val_hd, halo.val_hu, 1)
        return blocks

    def _resettle(self, ss: ShardState):
        """(shards, halo, nbrs, flags): the global wrap, the two-stage
        migration, the two halo stages and every shard's device_rebuild
        on the slab box (JAX _build_resettle); flags are device tensors,
        the max over shards (JAX's pmax).  Reads no host value."""
        Pn, n_cap = self.n_devices, self.n_cap
        Px, Py = self.grid
        dev = ss.x.device
        xw, image, fw = self._wrap(ss.x, ss.image, self._gm)
        cols = (xw, ss.v, ss.f, image, ss.type, ss.q, ss.tag)
        rows = list(zip(*[self._split(c) for c in cols]))
        valid = self._split(ss.valid)
        zero_b = torch.zeros((), dtype=torch.bool, device=dev)
        zero_i = torch.zeros((), dtype=torch.int64, device=dev)
        ov_mig = [zero_b] * Pn
        lost = [zero_i] * Pn
        n_true = [v.sum() for v in valid]      # unclipped demand
        ar = torch.arange(n_cap, device=dev)
        for ax, P in ((0, Px), (1, Py)):
            if P <= 1:
                continue
            if ax == 0:
                f_ax = self._split(fw[:, 0])
            else:
                f_ax = [matvec3(r[0] - self._lo_glob, self._hinv_glob)[:, 1]
                        for r in rows]
            slab = [torch.clamp((f * P).to(torch.int64), 0, P - 1)
                    for f in f_ax]
            rows, n_new, ov, l_ = self._migrate_axis(rows, valid, slab, ax)
            valid = [ar < n for n in n_new]
            n_true = n_new
            ov_mig = [a | b for a, b in zip(ov_mig, ov)]
            lost = [a + b for a, b in zip(lost, l_)]

        x2 = [torch.where(v[:, None], r[0], self._park[None, :])
              for r, v in zip(rows, valid)]
        t2 = [torch.where(v, r[4], torch.ones_like(r[4]))
              for r, v in zip(rows, valid)]
        tag2 = [torch.where(v, r[6], torch.full_like(r[6], -1))
                for r, v in zip(rows, valid)]
        q2 = [r[5] for r in rows]

        # halo stages: x over the owned block, y over [owned | x-halo]
        xb, tb, qb, vb = x2, t2, q2, valid
        tabs = {}
        nch = {0: [zero_i] * Pn, 1: [zero_i] * Pn}
        ov_h = [zero_b] * Pn
        for ax, P, Bh, names in ((0, Px, self.Bhx, HALO_X),
                                 (1, Py, self.Bhy, HALO_Y)):
            if P <= 1:
                empty_i = torch.zeros((Pn, 0), dtype=torch.int64, device=dev)
                empty_b = torch.zeros((Pn, 0), dtype=torch.bool, device=dev)
                tabs.update(zip(names, (empty_i, empty_i, empty_b, empty_b)))
                continue
            ex = self._exports(xb, vb, ax, Bh)
            from_back, from_fwd = self._sources(ax)
            ar_h = torch.arange(Bh, device=dev)
            exp_hi = [e[0] for e in ex]
            exp_lo = [e[1] for e in ex]
            val_lo = [ar_h < ex[from_back[d]][2] for d in range(Pn)]
            val_hi = [ar_h < ex[from_fwd[d]][3] for d in range(Pn)]
            nch[ax] = [e[4] for e in ex]
            ov_h = [a | e[5] for a, e in zip(ov_h, ex)]
            xb_new = self._gather_halo(xb, exp_hi, exp_lo, val_lo, val_hi,
                                       ax)
            tb = self._gather_halo(tb, exp_hi, exp_lo, val_lo, val_hi, ax,
                                   fill=1, shift=False)
            qb = self._gather_halo(qb, exp_hi, exp_lo, val_lo, val_hi, ax,
                                   fill=0.0, shift=False)
            vb = [torch.cat([v, lo, hi])
                  for v, lo, hi in zip(vb, val_lo, val_hi)]
            xb = xb_new
            tabs.update(zip(names, (torch.stack(exp_hi), torch.stack(exp_lo),
                                    torch.stack(val_lo),
                                    torch.stack(val_hi))))
        halo = HaloTables(t_loc=torch.stack(tb), q_loc=torch.stack(qb),
                          valid_loc=torch.stack(vb), **tabs)

        # per-shard rebuild on the slab box; the pad rows kept out
        nbrs, shard_flags = [], []
        for d in range(Pn):
            nbr, fl = self._rebuild_shard(d, self.pair, xb[d], tb[d], vb[d],
                                          self._gm)
            nbrs.append(nbr)
            fl.update({"mig_overflow": ov_mig[d], "halo_overflow": ov_h[d],
                       "lost_atoms": lost[d], "count:slab": n_true[d],
                       "count:halo": nch[0][d], "count:haloy": nch[1][d]})
            shard_flags.append(fl)
        flags = {k: torch.stack([fl[k].to(torch.int64).reshape(())
                                 for fl in shard_flags]).max()
                 for k in shard_flags[0]}
        ss2 = ss.replace(x=torch.cat(x2), v=torch.cat([r[1] for r in rows]),
                         f=torch.cat([r[2] for r in rows]),
                         image=torch.cat([r[3] for r in rows]),
                         type=torch.cat(t2), q=torch.cat(q2),
                         tag=torch.cat(tag2), valid=torch.cat(valid))
        return ss2, halo, nbrs, flags

    def resettle(self, _retry: int = 0):
        """Wrap, migrate, exchange halos and rebuild every shard's lists;
        one host copy of the flags.  A lost atom raises; an overflow
        re-sizes from the measured counts and runs again (JAX :621-656)."""
        ss, halo, nbrs, flags_t = self._resettle_now()
        flags = device_build.flags_to_host(flags_t)
        if flags["lost_atoms"]:
            raise RuntimeError(
                f"{flags['lost_atoms']} atoms moved more than one slab "
                "between reneighbor events: check_every too large")
        bad = [k for k, v in flags.items() if "overflow" in k and v]
        if bad:
            if _retry >= self.overflow_retries:
                raise RuntimeError(f"sharded rebuild overflow persists: "
                                   f"{flags}")
            self._grow(flags, bad)
            return self.resettle(_retry + 1)
        if not self._plan_tightened:
            # the density estimate over-pads K: re-size once to the counts
            # (the same input, so the same rows and a new plan)
            self._plan_tightened = True
            caps = dict(self._plan.k_caps)
            if any(caps[k.split(":", 2)[2]] > 1.6 * max(v, 8)
                   for k, v in flags.items() if k.startswith("count:k:")):
                self._replan(flags, grow=1.3)
                return self.resettle(_retry)
        self._flag_names = sorted(flags)
        self._install(ss, halo, nbrs)
        self._flags = flags
        self._pending_rebuild = False
        self.resettles += 1

    def _resettle_now(self):
        """_resettle of the shards as they are."""
        return self._resettle(self.shards)

    def _install(self, ss: ShardState, halo: HaloTables, nbrs):
        """Take a resettle's shards, halo tables and lists; keep its inputs
        for a re-list (copies: the shards may be the device loop's
        buffers)."""
        self._rs_in = {a: getattr(self.shards, a).clone() for a in _LAYOUT}
        self.shards, self.halo, self.nbrs = ss, halo, nbrs

    def _relist(self, _retry: int = 0):
        """Halo tables and lists at the current capacities for the shards
        as they are: the last resettle run again on its own inputs
        (_rs_in), which gives the same rows, so that the shards keep their
        layout and a span re-run after a re-size takes the host loop's
        decisions.  A re-size that repacks the shards resettles instead."""
        ss = self.shards.replace(**self._rs_in)
        out, halo, nbrs, flags_t = self._resettle(ss)
        flags = device_build.flags_to_host(flags_t)
        bad = [k for k, v in flags.items() if "overflow" in k and v]
        if bad:
            if _retry >= self.overflow_retries:
                raise RuntimeError(f"sharded rebuild overflow persists: "
                                   f"{flags}")
            n_cap = self.n_cap
            self._grow(flags, bad)
            if self.n_cap != n_cap:
                return self.resettle()
            return self._relist(_retry + 1)
        if not torch.equal(out.tag, self.shards.tag):
            raise RuntimeError("re-list: the last resettle's inputs do not "
                               "give the shards' rows")
        self._flag_names = sorted(flags)
        self.halo, self.nbrs = halo, nbrs

    def _grow(self, flags, bad):
        """Re-size from the measured counts (JAX :658-731): the plan, then
        n_cap (repacking the shards; per-atom fix extras restart at zero,
        the rest is kept) and the halo capacities."""
        grow = 1.5
        self.regrows += 1
        if "mig_overflow" in bad:
            self.B_mig = -(-int(self.B_mig * grow) // 8) * 8
        self._replan(flags, grow=grow,
                     k_grow=grow if any(k.startswith("k_overflow")
                                        for k in bad) else 1.0)
        old_ncap = self.n_cap
        if "mig_overflow" in bad or flags["count:slab"] > self.n_cap:
            self.n_cap = -(-int(max(flags["count:slab"], self.n_cap) * 1.2)
                           // 8) * 8
        if "halo_overflow" in bad:
            if self.grid[0] > 1:
                self.Bhx = -(-int(max(flags["count:halo"] * 1.3,
                                      self.Bhx)) // 8) * 8
            if self.grid[1] > 1:
                self.Bhy = -(-int(max(flags.get("count:haloy", 0) * 1.3,
                                      self.Bhy)) // 8) * 8
        self.n_loc = self.n_cap + 2 * self.Bhx + 2 * self.Bhy
        if self.n_cap != old_ncap:
            old = self.shards
            rows = old.x.shape[0]
            self._pack_initial(self.to_state())
            self.shards = self.shards.replace(step=old.step, extras=_nested(
                (p, t.new_zeros((self.n_devices * self.n_cap,) + t.shape[1:])
                 if t.dim() >= 1 and t.shape[0] == rows else t)
                for p, t in extras_items(old.extras)))
        self._comm_cost = None

    # -- the step -------------------------------------------------------------
    def _pair_local(self, halo: HaloTables, d: int) -> PairStyle:
        """The pair style bound to shard d's [owned | halo] charges (JAX
        :226-236); charge-free styles as they are."""
        if self.pair.needs_charges:
            return self.pair.with_charges(halo.q_loc[d])
        return self.pair

    def _forces(self, x, valid, halo: HaloTables, nbrs) -> torch.Tensor:
        """[Pn * n_cap, 3]: each shard's halo refresh, pair.forces on its
        local block, the owned rows kept and the pads zeroed."""
        blocks = self._halo_blocks(x, halo)
        parts = [self._pair_local(halo, d).forces(
            blocks[d], halo.t_loc[d], nbrs[d], self._h_slab)[:self.n_cap]
            for d in range(self.n_devices)]
        return torch.cat(parts) * valid[:, None]

    def _one_step(self, st: State, valid, halo, nbrs) -> State:
        return self._verlet_step(st, self.ctx, lambda x: self._forces(
            x, valid, halo, nbrs))

    def _verlet_step(self, st: State, ctx: StepContext, forces) -> State:
        """One step of the fixes' hooks in Verlet::run's order around
        forces(x)."""
        for f in self.fixes:
            st = f.initial_integrate(st, ctx)
        for f in self.fixes:
            st = f.post_integrate(st, ctx)
        st = st.replace(f=forces(st.x))
        for f in self.fixes:
            st = f.post_force(st, ctx)
        for f in self.fixes:
            st = f.final_integrate(st, ctx)
        for f in self.fixes:
            st = f.end_of_step(st, ctx)
        return st.replace(step=st.step + 1)

    def _max_disp(self, x, halo: HaloTables, nbrs) -> torch.Tensor:
        """Largest squared displacement of a valid local row since the
        resettle, over every shard, in float64 (JAX's pmax)."""
        blocks = self._halo_blocks(x, halo)
        m = []
        for d in range(self.n_devices):
            dsp = blocks[d] - nbrs[d].x_build
            d2 = torch.sum(dsp * dsp, dim=1)
            m.append(torch.max(torch.where(halo.valid_loc[d], d2,
                                           torch.zeros_like(d2))))
        return torch.max(torch.stack(m)).double()

    def _steps(self, ss: ShardState, halo, nbrs, nsteps: int):
        """(shard state after nsteps, md)."""
        with torch.no_grad():
            st = self._local_state(ss)
            for _ in range(nsteps):
                st = self._one_step(st, ss.valid, halo, nbrs)
            return (self._from_state(ss, st),
                    self._max_disp(st.x, halo, nbrs))

    def _setup_forces(self):
        """Make the shards' f valid for the first half-kick (LAMMPS
        setup())."""
        if self.nbrs is None:
            self.resettle()
        if self._f_valid:
            return
        with torch.no_grad():
            f = self._forces(self.shards.x, self.shards.valid, self.halo,
                             self.nbrs)
        self.shards = self.shards.replace(f=f)
        self._f_valid = True

    # -- energy and thermo ----------------------------------------------------
    def _owned(self, d: int) -> torch.Tensor:
        v = self._split(self.shards.valid)[d]
        return torch.cat([v, v.new_zeros(self.n_loc - self.n_cap)])

    def _per_shard(self, method: str) -> list:
        """The style's `method` (energy_value or energy_virial) on each
        shard's local block with the shard's centre mask, so that each
        directed edge is counted by the shard that owns its centre.
        REBOMoS takes E and W from kernels A and C on each shard's rebuild
        tables, no autograd; the other styles' energy_virial is one
        autograd pass per shard (the peak memory is one shard's)."""
        if self.nbrs is None:
            self.resettle()
        with torch.no_grad():
            blocks = self._halo_blocks(self.shards.x, self.halo)
            return [getattr(self._pair_local(self.halo, d), method)(
                blocks[d], self.halo.t_loc[d], self.nbrs[d], self._h_slab,
                center_mask=self._owned(d)) for d in range(self.n_devices)]

    def potential_energy(self) -> float:
        """The sum of the shards' owned-centre energies (JAX :978-984)."""
        return float(sum(self._per_shard("energy_value")))

    def thermo(self) -> dict:
        """One thermo row (run/thermo.thermo_row of the global State), the
        energy and the strain virial summed over the shards."""
        parts = self._per_shard("energy_virial")
        return thermo_row(self.to_state(), sum(e for e, _ in parts),
                          sum(w for _, w in parts), self.units)

    # -- LoopDriver's hooks -----------------------------------------------------
    def _host_rebuild(self):
        self.resettle()

    def _host_steps(self, nsteps: int):
        new, md = self._steps(self.shards, self.halo, self.nbrs, nsteps)
        return new, float(md)

    def _accept(self, new: ShardState):
        self.shards = new

    def _thermo_row(self) -> dict:
        return self.thermo()

    def _device_loop(self) -> "ShardLoop":
        """The loop of the current plan, capacities and configuration; a
        change of any of them captures anew."""
        key = (self._plan, self.n_cap, self.Bhx, self.Bhy, self.B_mig,
               id(self.pair), tuple(map(id, self.fixes)),
               tuple(f.capture_key() for f in self.fixes), self.ctx.dt,
               self.skin, self.check_every, self.grid)
        if self._loop is None or self._loop_key != key:
            if self._loop is not None:
                self._loop.close()
                self._loop = None
            self._loop = ShardLoop(self, self._flag_names)
            self._loop_key = key
            self.timers.add("Pair.capture", self._loop.capture_s)
        return self._loop

    def _start_span(self, loop: "ShardLoop"):
        self.shards, self.halo = loop.start(
            self.shards, self.halo, self.nbrs, self._pending_rebuild,
            self._seg_dprev)
        self.nbrs = loop.nbrs
        # the last resettle's inputs follow the loop's (restore() included)
        self._rs_in = loop.rs_in

    def _resize_relist(self, flags, retry: int):
        """A truncated resettle stepped physics: re-size, then re-list the
        last resettle before the span (or resettle, when n_cap grew and
        the shards were repacked)."""
        n_cap = self.n_cap
        self._grow(flags, [k for k, v in flags.items()
                           if "overflow" in k and v])
        if self.n_cap == n_cap:
            self._relist()
        else:
            self.resettle()

    def _after_span(self, res):
        """Count the span's resettles.  K is not re-tightened after a
        span: the sharded plan keeps K_HEADROOM over the high-water kmax
        and tightens once, after the first resettle (resettle())."""
        self.resettles += res.n_rb

    def _comm_cost_estimate(self) -> float:
        """Device seconds of one step's halo refresh of every shard, the
        communication part of a step, measured once per capacities by a
        standalone probe (JAX :875-896).  The probe cannot see an overlap
        with the forces, so the Comm row it feeds is an upper bound."""
        if self._comm_cost is None:
            reps = 5
            self._halo_blocks(self.shards.x, self.halo)
            self._comm_cost = device_seconds(
                lambda: [self._halo_blocks(self.shards.x, self.halo)
                         for _ in range(reps)], self.device) / reps
        return self._comm_cost

    def _advanced(self, nsteps: int):
        """Move the halo refresh's share of the steps from Pair to Comm.
        A failure of the probe raises (JAX :898-905 swallows it)."""
        self.timers.transfer("Pair", "Comm",
                             nsteps * self._comm_cost_estimate())

    # -- outputs ----------------------------------------------------------------
    @property
    def step(self) -> int:
        return self.shards.step

    @step.setter
    def step(self, n: int):
        self.shards = self.shards.replace(step=n)

    def fix_view_state(self):
        """A State-shaped view of the fixes' extras for their outputs
        (compute_scalar / vector, fix_bfield.cpp:542-562): the scalar
        extras exist once and already hold the global sums."""
        return _types.SimpleNamespace(extras=self.shards.extras)

    def to_state(self) -> State:
        """The global State, rows ordered by atom id (JAX :1232-1252)."""
        ss = self.shards
        rows = torch.nonzero(ss.valid).flatten()
        rows = rows[torch.argsort(ss.tag[rows])]
        return State(x=ss.x[rows], v=ss.v[rows], f=ss.f[rows],
                     type=ss.type[rows], q=ss.q[rows], image=ss.image[rows],
                     mass=self._mass, box=self.box, step=int(ss.step),
                     extras={})

    @property
    def state(self) -> State:
        """to_state(): what an Engine's caller reads as `state`."""
        return self.to_state()


class ShardLoop(GraphIteration):
    """The sharded engine's iteration (JAX _build_loop): the resettle of
    every shard into the loop's buffers, then check_every steps of the
    stacked state.  On a CUDA state it is one captured graph, the resettle
    under the conditional node; on the CPU it runs eagerly."""

    def __init__(self, eng: ShardedEngine, flag_names):
        super().__init__(eng.device, flag_names, eng.check_every, eng.skin)
        self.eng = eng
        bad = [type(f).__name__ for f in eng.fixes
               if not getattr(f, "capturable", True)]
        if bad:
            raise RuntimeError(f"fused loop: fixes {bad} read host values "
                               "in their hooks and cannot be captured")
        ss = eng.shards
        self.xpaths = [p for p, _ in extras_items(ss.extras)]
        self.hnames = [f.name for f in dataclasses.fields(HaloTables)]
        self.buf = {a: getattr(ss, a).clone() for a in _LAYOUT}
        self.buf.update(("h:" + a, getattr(eng.halo, a).clone())
                        for a in self.hnames)
        self.buf.update(("rs:" + a, t.clone()) for a, t in eng._rs_in.items())
        self.buf.update((p, t.clone()) for p, t in extras_items(ss.extras))
        # a discarded span re-lists or resettles, which makes the halo
        # tables anew: restore() needs the rest
        self.snap = {a: t.clone() for a, t in self.buf.items()
                     if not (isinstance(a, str) and a.startswith("h:"))}
        # the engine's lists become the loop's buffers (no copy: at 8M
        # atoms they are ~2 GB a shard); start() copies later ones in
        self.nbrs = eng.nbrs
        if self.cuda:
            self._capture(self._warm)

    def _shards(self, step: int = 0) -> ShardState:
        b = self.buf
        return ShardState(step=step, extras=_nested(
            (p, b[p]) for p in self.xpaths),
            **{a: b[a] for a in _LAYOUT})

    def _halo(self) -> HaloTables:
        return HaloTables(**{a: self.buf["h:" + a] for a in self.hnames})

    def _rebuild(self):
        """Every shard's resettle into the loop's buffers; its inputs into
        the rs: buffers (rs_in)."""
        b = self.buf
        for a in _LAYOUT:
            b["rs:" + a].copy_(b[a])
        ss, halo, nbrs, flags = self.eng._resettle(self._shards())
        for a in _LAYOUT:
            b[a].copy_(getattr(ss, a))
        for a in self.hnames:
            b["h:" + a].copy_(getattr(halo, a))
        for dst, src in zip(self.nbrs, nbrs, strict=True):
            for t_dst, t_src in zip(tensors(dst), tensors(src), strict=True):
                t_dst.copy_(t_src)
        self._merge_flags(flags)

    def _steps(self):
        b = self.buf
        ss, md = self.eng._steps(self._shards(), self._halo(), self.nbrs,
                                 self.check)
        new = dict(extras_items(ss.extras))
        if list(new) != self.xpaths or any(
                t.shape != b[p].shape or t.dtype != b[p].dtype
                for p, t in new.items()):
            raise RuntimeError("fused loop: a step changed the keys, shapes "
                               "or types of extras")
        return [(a, getattr(ss, a)) for a in _STEPPED] + list(new.items()), md

    def _warm(self):
        e = self.eng
        with torch.no_grad():
            e._resettle(self._shards())
            e._forces(self.buf["x"], self.buf["valid"], self._halo(),
                      self.nbrs)

    def start(self, shards: ShardState, halo: HaloTables, nbrs,
              pending: bool, dprev: float):
        """Load the engine's shards, halo tables and lists (copied where
        they are not the loop's own) and its pending/dprev; returns the
        shards and halo tables on the loop's buffers."""
        src_of = dict(extras_items(shards.extras))
        if list(src_of) != self.xpaths:
            raise RuntimeError(f"fused loop: extras hold {list(src_of)}, "
                               f"the loop {self.xpaths}")
        src_of.update((a, getattr(shards, a)) for a in _LAYOUT)
        src_of.update(("h:" + a, getattr(halo, a)) for a in self.hnames)
        src_of.update(("rs:" + a, t) for a, t in self.eng._rs_in.items())
        self._load(src_of, pending, dprev)
        if nbrs is not self.nbrs:
            for dst, src in zip(self.nbrs, nbrs, strict=True):
                for t_dst, t_src in zip(tensors(dst), tensors(src),
                                        strict=True):
                    t_dst.copy_(t_src)
        return self._shards(shards.step), self._halo()

    @property
    def rs_in(self):
        """{field: rows} that the last resettle of the loop's shards took."""
        return {a: self.buf["rs:" + a] for a in _LAYOUT}
