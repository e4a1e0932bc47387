"""Engine — velocity-Verlet host loop with ordered fix hooks (port of
lammps_plugins_tpu/run/simulation.py, host-loop form).

Per step (Verlet::run): initial_integrate, post_integrate, forces,
post_force, final_integrate, end_of_step.  Steps run in segments of
`check_every` between neighbor-list checks, and the host synchronises
once per segment to read the segment's maximum displacement.  Rebuild
safety is exact: a segment whose displacement passes half the skin is
discarded and re-run from its start with fresh lists; a predictive rule
rebuilds before the next segment would trip.  The on-device rebuild
sizes its capacities from a plan, re-sizes on overflow flags, keeps a
per-tier K high-water mark and quantizes K (`_quantize_k`).  A pair style
whose `combine` is "react" gets the reaction-combine route tables: the
first rebuild measures the route geometry, the plan then carries route
capacities (high-water marked like K), and a geometry the gate refuses
raises.

The lists are rebuilt on the state's device (`device_rebuild`).  The
host (numpy) build is kept for CPU parity tests, which clear
`Engine.device_rebuild`; a CUDA state refuses it.  The Engine never moves
data off the state's device on its own; the only device-to-host copies
are the per-segment displacement, the rebuild flags and the thermo rows.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..core.state import State
from ..core.units import UnitSystem
from ..fixes.base import Fix, StepContext
from ..neighbor import device_build
from ..neighbor.build import NeighborData, build_neighbor_data
from ..ops.react import choose_react
from ..potentials.base import PairStyle
from .thermo import thermo_row
from .timers import Timers


def _quantize_k(target: int) -> int:
    """Neighbor-list K for a measured kmax: multiples of 4 up to 48 (the
    angular kernel is quadratic in K), multiples of 16 above; min 16."""
    if target <= 48:
        return max(16, -(-target // 4) * 4)
    return -(-target // 16) * 16


class Engine:
    """Owns the state, the neighbor data and the host loop."""

    def __init__(self, state: State, pair: PairStyle, fixes: Sequence[Fix],
                 units: UnitSystem, dt: float | None = None,
                 skin: float | None = None, check_every: int = 10):
        self.state = state
        self.pair = pair
        self.fixes = list(fixes)
        self.units = units
        self.ctx = StepContext(units=units,
                               dt=dt if dt is not None else units.dt)
        self.skin = skin if skin is not None else units.skin
        self.check_every = check_every
        self.nbr: NeighborData | None = None
        self.thermo_rows: List[dict] = []
        self.device_rebuild = True
        self._f_valid = False
        self._k_hwm = {}               # per-tier high-water mark of kmax
        self._bnd_hwm = 0
        self._react = getattr(pair, "combine", None) == "react"
        self._react_gate = getattr(pair, "react_gate", True)
        self._react_hwm = [0, 0, 0]    # measured NW, KC, QR high-water
        self._plan = None
        self._plan_tightened = False
        self._seg_dprev = 0.0
        self.rebuilds = 0
        self.timers = Timers()
        pair.prepare(state.type.cpu().numpy())
        for fix in self.fixes:
            self.state = fix.setup(self.state, self.ctx)
        box = self.state.box
        h = box.h_np()
        dev, dtype = self.state.x.device, self.state.x.dtype
        self._box_dev = tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                              for a in (h, np.linalg.inv(h), box.lo_np()))

    # -- neighbor maintenance ---------------------------------------------
    def rebuild_neighbors(self):
        self.rebuilds += 1
        if self.device_rebuild:
            self._rebuild_on_device()
            return
        st = self.state
        if st.x.is_cuda:
            raise RuntimeError("the host neighbor build serves CPU states "
                               "only; a CUDA state rebuilds on the device")
        xw, image = st.box.wrap_np(st.x.detach().cpu().double().numpy(),
                                   st.image.cpu().numpy())
        dev, dtype = st.x.device, st.x.dtype
        self.state = st.replace(
            x=torch.as_tensor(xw, dtype=dtype, device=dev),
            image=torch.as_tensor(image, dtype=torch.int32, device=dev))
        self.nbr = build_neighbor_data(
            xw, st.type.cpu().numpy(), st.box, self.pair.neighbor_requests(),
            skin=self.skin, dtype=dtype, device=dev)

    def _make_plan_fast(self, slack: float = 1.25):
        """Density-based capacity estimate (no host neighbor build)."""
        self._plan = device_build.make_plan_from_density(
            self.state.box, self.pair.neighbor_requests(), self.skin,
            self.state.natoms, slack=slack,
            cell_tiers=getattr(self.pair, "cell_tiers", ()),
            mirror_tiers=getattr(self.pair, "mirror_tiers", ()))

    def _rebuild_on_device(self, _retry: int = 0):
        if self._plan is None:
            self._make_plan_fast()
        h, h_inv, lo = self._box_dev
        st = self.state
        xw, image, nbr, flags_t = device_build.device_rebuild(
            self._plan, st.x, st.image, st.type, h, h_inv, lo,
            self.pair.neighbor_requests(), react=self._react)
        flags = device_build.flags_to_host(flags_t)
        if any(v for k, v in flags.items() if "overflow" in k):
            if _retry >= 6:
                raise RuntimeError(f"device rebuild overflow persists: "
                                   f"{flags}")
            # re-size from the measured counts (which a too-small capacity
            # may itself truncate, hence a few rounds) and retry
            self._resize_plan(flags, grow=1.5 * (1.3 ** _retry))
            return self._rebuild_on_device(_retry + 1)
        if not self._plan_tightened:
            # the density estimate over-pads K: re-size once to the counts
            self._plan_tightened = True
            caps = dict(self._plan.k_caps)
            loose = any(caps[k.split(":", 2)[2]] > 1.6 * max(v, 8)
                        for k, v in flags.items() if k.startswith("count:k:"))
            # the route tables need capacities from a measured rebuild
            if loose or (self._react and not self._plan.react_nw):
                self._resize_plan(flags, grow=1.3)
                return self._rebuild_on_device(_retry)
        self._note_k_counts(flags)
        self.state = st.replace(x=xw, image=image)
        self.nbr = nbr

    def _note_k_counts(self, flags):
        for k, v in flags.items():
            if k.startswith("count:k:"):
                name = k.split(":", 2)[2]
                self._k_hwm[name] = max(self._k_hwm.get(name, 0), int(v))

    def _choose_react_from(self, flags):
        """Route capacities (NW, KC, QR) from the high-water marks of the
        measured route geometry.  A combine="react" the gate refuses
        raises: the mirror gather never runs in its place."""
        for i, pref in enumerate(("count:rnw:", "count:rkc:", "count:rq:")):
            vals = [int(v) for k, v in flags.items() if k.startswith(pref)]
            if vals:
                self._react_hwm[i] = max(self._react_hwm[i], max(vals))
        caps = choose_react(self.state.natoms, *self._react_hwm,
                            gate=self._react_gate)
        if not caps[0]:
            nw, kc, rq = self._react_hwm
            raise RuntimeError(
                f"combine='react' refused for {self.state.natoms} atoms with "
                f"measured NW {nw}, KC {kc}, QR {rq}: the gate needs "
                f">= 16384 atoms, <= 2048 chunks of 128, and NW <= 48, "
                f"KC <= 12, QR <= 112 after rounding up (a spatially sorted "
                f"scene); react_gate=False builds the routes at any size")
        return caps

    def _resize_plan(self, flags, grow: float):
        """New plan from measured counts (overflow recovery, tightening).

        K = _quantize_k(high-water kmax + 2) whatever overflowed: the REBO
        kernel's cost grows as K^2, while a K overflow costs one more
        rebuild.  `grow` pads the other capacities only."""
        self._note_k_counts(flags)
        k_counts = {name: _quantize_k(m + 2)
                    for name, m in self._k_hwm.items()}
        self._bnd_hwm = max(self._bnd_hwm, int(flags.get("count:bnd", 0)))
        bnd_c = (int(self._bnd_hwm * (1.2 if grow <= 1.3 else grow)) + 64
                 if self._bnd_hwm else 0)
        r_nw, r_kc, r_qr = (self._choose_react_from(flags) if self._react
                            else (0, 0, 0))
        self._plan = device_build.make_plan(
            self.state.box, self.pair.neighbor_requests(), self.skin,
            int(flags["count:ghost"]), int(flags["count:cell"]), k_counts,
            slack=grow, k_final=True,
            cell_tiers=getattr(self.pair, "cell_tiers", ()),
            mirror_tiers=getattr(self.pair, "mirror_tiers", ()),
            cand_occupancy=int(flags["count:candcell"])
            if "count:candcell" in flags else None,
            bnd_count=bnd_c, react_nw=r_nw, react_kc=r_kc, react_qr=r_qr)

    # -- stepping -----------------------------------------------------------
    def _one_step(self, state: State, nbr: NeighborData) -> State:
        ctx = self.ctx
        for f in self.fixes:
            state = f.initial_integrate(state, ctx)
        for f in self.fixes:
            state = f.post_integrate(state, ctx)
        state = state.replace(
            f=self.pair.forces(state.x, state.type, nbr, state.box.h))
        for f in self.fixes:
            state = f.post_force(state, ctx)
        for f in self.fixes:
            state = f.final_integrate(state, ctx)
        for f in self.fixes:
            state = f.end_of_step(state, ctx)
        return state.replace(step=state.step + 1)

    def _segment(self, state, nbr, nsteps: int):
        """`nsteps` steps; returns (state, max displacement^2 since the
        list build) — the one host sync of the segment."""
        with torch.no_grad():
            for _ in range(nsteps):
                state = self._one_step(state, nbr)
            d = state.x - nbr.x_build
            return state, float(torch.max(torch.sum(d * d, dim=-1)))

    def _ensure_neighbors(self):
        if self.nbr is None:
            self.rebuild_neighbors()
            return
        d = self.state.x - self.nbr.x_build
        if float(torch.max(torch.sum(d * d, dim=-1))) \
                > (0.5 * self.skin) ** 2:
            self.rebuild_neighbors()

    def evaluate(self):
        """Forces, pe and virial at the current positions (LAMMPS setup)."""
        self._ensure_neighbors()
        st = self.state
        pe, force, W = self.pair.energy_force_virial(st.x, st.type,
                                                     self.nbr, st.box.h)
        self.state = st.replace(f=force)
        self._f_valid = True
        return pe, W

    def _setup_forces(self):
        """Make state.f valid for the next segment's first half-kick."""
        self._ensure_neighbors()
        if self._f_valid:
            return
        st = self.state
        with torch.no_grad():
            force = self.pair.forces(st.x, st.type, self.nbr, st.box.h)
        self.state = st.replace(f=force)
        self._f_valid = True

    def _thermo(self, state: State) -> dict:
        pe, W = self.pair.energy_virial(state.x, state.type, self.nbr,
                                        state.box.h)
        return thermo_row(state, pe, W, self.units)

    def run(self, nsteps: int, thermo_every: int = 0,
            on_thermo: Callable[[dict], None] | None = None):
        """Run `nsteps`; thermo rows every `thermo_every` steps, step 0
        included (like LAMMPS)."""
        self.timers.start_run(self.state.natoms)
        self._setup_forces()
        rows = []

        def emit():
            with self.timers.section("Output"):
                row = self._thermo(self.state)
            rows.append(row)
            if on_thermo:
                on_thermo(row)

        if thermo_every:
            emit()
        half_skin_sq = (0.5 * self.skin) ** 2
        done = 0
        while done < nsteps:
            span = nsteps - done
            if thermo_every:
                span = min(span, thermo_every - (done % thermo_every))
            seg = min(self.check_every, span)
            start_state = self.state
            with self.timers.section("Pair"):
                new_state, md = self._segment(self.state, self.nbr, seg)
            if md > half_skin_sq:
                # a mid-segment half-skin violation is possible: redo the
                # segment from its start with fresh lists
                self.state = start_state
                with self.timers.section("Neigh"):
                    self.rebuild_neighbors()
                with self.timers.section("Pair"):
                    new_state, md = self._segment(self.state, self.nbr, seg)
                self.state = new_state
                if md > half_skin_sq:
                    with self.timers.section("Neigh"):
                        self.rebuild_neighbors()
            else:
                self.state = new_state
                # predictive rebuild: extrapolate one segment of growth
                d_now = math.sqrt(md)
                growth = max(d_now - self._seg_dprev, 0.0)
                self._seg_dprev = d_now
                if d_now + growth > 0.95 * math.sqrt(half_skin_sq):
                    with self.timers.section("Neigh"):
                        self.rebuild_neighbors()
                    self._seg_dprev = 0.0
            done += seg
            if thermo_every and done % thermo_every == 0:
                emit()
        self.timers.end_run(nsteps)
        self.thermo_rows = rows
        return rows
