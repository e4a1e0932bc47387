"""Engine — velocity-Verlet loop with ordered fix hooks (port of
lammps_plugins_tpu/run/simulation.py).

Per step (Verlet::run): initial_integrate, post_integrate, forces,
post_force, final_integrate, end_of_step.  Steps run in segments of
`check_every` between neighbor-list checks.  Rebuild safety is exact, by
the JAX package's fused-loop rule: a segment whose displacement passes
half the skin is discarded and re-run from its start with fresh lists; a
predictive rule marks a rebuild before the next segment would trip, and
the rebuild runs when that segment starts.

Two loops apply the rule.  The device loop (run/device_loop.py; on a CUDA
state by default, `Engine.fused_loop`) runs spans of up to 16 segments
with the rebuild decided on the device: one CUDA graph per iteration, the
rebuild under a conditional node, and one host read per span of the
steps done, the rebuilds run and their max-merged flags.  An overflow
flag discards the whole span, re-sizes the plan and runs it again.  The
host loop (the CPU default, and every segment shorter than check_every)
reads the segment's maximum displacement once per segment.  Both take the
same decisions from the same numbers, so they give the same trajectory.
A failed capture or replay raises: nothing falls back to the host loop.
The host half of both loops (run(), the rule, the span protocol) is
run/driver.py's, which the sharded engine shares.

The on-device rebuild sizes its capacities from a plan, re-sizes on
overflow flags, keeps a per-tier K high-water mark and quantizes K
(`_quantize_k`).  A re-size that the device loop decides after a span
(an overflow that discards it, or a K cap to tighten) re-lists: it runs
the last rebuild again on that rebuild's own inputs at the new plan
(`_rb_in`), so the lists hold the same entries in the new shapes and the
decision state (x_build, pending, dprev) is the one the host loop has at
that point; the host loop re-sizes within its rebuild on the same
inputs.  Both loops therefore count the same rebuilds and, where the
force path sums padded slots as zeros, give the same bits.  A pair style
whose `combine` is "react" gets the reaction-combine route tables: the
first rebuild measures the route geometry, the plan then carries route
capacities (high-water marked like K), and a geometry the gate refuses
raises.  The host (numpy) build is
kept for CPU parity tests, which clear `Engine.device_rebuild`; a CUDA
state refuses it.  The Engine never moves data off the state's device on
its own; the only device-to-host copies are the per-segment displacement
or per-span control vector, the rebuild flags, the thermo rows and, once
at the end of a run that took the host loop, its steps' force seconds.
Each step stamps its force call (run/timers.device_span): the device loop
reads the seconds in its control vector, the host loop in that one copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..core.state import State
from ..core.units import UnitSystem
from ..fixes.base import Fix, StepContext
from ..neighbor import device_build
from ..neighbor.build import NeighborData, build_neighbor_data
from ..ops.react import choose_react
from ..potentials.base import PairStyle
from .device_loop import DeviceLoop, tensors
from .driver import LoopDriver, _overflowed
from .thermo import thermo_row
from .timers import Timers, device_span

def _quantize_k(target: int) -> int:
    """Neighbor-list K for a measured kmax: multiples of 4 up to 48 (the
    angular kernel is quadratic in K), multiples of 16 above; min 16."""
    if target <= 48:
        return max(16, -(-target // 4) * 4)
    return -(-target // 16) * 16


class Engine(LoopDriver):
    """Owns the state, the neighbor data and the loops (the host half of
    the loops is run/driver.LoopDriver's)."""

    n_devices = 1
    overflow_retries = 6           # JAX simulation.py:228, :514

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
        #: the device loop: None = on for a CUDA state, off on the CPU;
        #: True on the CPU runs its iteration eagerly (the parity tests)
        self.fused_loop: bool | None = None
        self._f_valid = False
        self._k_hwm = {}               # per-tier high-water mark of kmax
        # K headroom of the re-tightening target: widened to 10 once an
        # overflow recovery has run (JAX simulation.py:89-94)
        self._k_headroom = 2
        self._bnd_hwm = 0
        self._react = getattr(pair, "combine", None) == "react"
        self._react_gate = getattr(pair, "react_gate", True)
        self._react_hwm = [0, 0, 0]    # measured NW, KC, QR high-water
        self._plan = None
        self._plan_tightened = False
        self._flag_names = None        # the flags of the plan's rebuild
        self._loop = None
        self._loop_key = None
        self._rb_in = None             # (x, image) the last rebuild took
        self.rebuilds = 0
        self.timers = Timers()
        pair.prepare(state.type.cpu().numpy())
        pair.bind_charges(state.q)
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
        self._pending_rebuild = False
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
        self.nbr = self._with_pair_tables(build_neighbor_data(
            xw, st.type.cpu().numpy(), st.box, self.pair.neighbor_requests(),
            skin=self.skin, dtype=dtype, device=dev))

    def _with_pair_tables(self, nbr: NeighborData) -> NeighborData:
        """nbr with the pair style's rebuild-time tables attached
        (`rebuild_tables`, when the style has one)."""
        make = getattr(self.pair, "rebuild_tables", None)
        return (dataclasses.replace(nbr, pair_tables=make(nbr)) if make
                else nbr)

    def rebuild_lists(self, plan, x, image, types, requests):
        """device_build.device_rebuild with this Engine's box tensors and
        route option, the pair style's rebuild-time tables attached: the
        rebuild of rebuild_neighbors and of the device loop."""
        xw, image, nbr, flags = device_build.device_rebuild(
            plan, x, image, types, *self._box_dev, requests,
            react=self._react)
        return xw, image, self._with_pair_tables(nbr), flags

    def _make_plan_fast(self, slack: float = 1.25):
        """Density-based capacity estimate (no host neighbor build)."""
        self._plan = device_build.make_plan_from_density(
            self.state.box, self.pair.neighbor_requests(), self.skin,
            self.state.natoms, slack=slack,
            cell_tiers=getattr(self.pair, "cell_tiers", ()),
            mirror_tiers=getattr(self.pair, "mirror_tiers", ()))

    def _rebuild_on_device(self, _retry: int = 0, relist: bool = False):
        """A rebuild at the state's positions; relist=True runs the last
        rebuild again on its own inputs (`_rb_in`) at the current plan and
        keeps the state as it is (a re-size, not a new rebuild)."""
        if self._plan is None:
            self._make_plan_fast()
        st = self.state
        x_in, image_in = self._rb_in if relist else (st.x, st.image)
        xw, image, nbr, flags_t = self.rebuild_lists(
            self._plan, x_in, image_in, st.type,
            self.pair.neighbor_requests())
        flags = device_build.flags_to_host(flags_t)
        if _overflowed(flags):
            if _retry >= self.overflow_retries:
                raise RuntimeError(f"device rebuild overflow persists: "
                                   f"{flags}")
            # re-size from the measured counts (which a too-small capacity
            # may itself truncate, hence a few rounds) and retry
            self._k_headroom = 10
            self._resize_plan(flags, grow=1.5 * (1.3 ** _retry))
            return self._rebuild_on_device(_retry + 1, relist)
        if not self._plan_tightened:
            # the density estimate over-pads K: re-size once to the counts
            self._plan_tightened = True
            caps = dict(self._plan.k_caps)
            loose = any(caps[k.split(":", 2)[2]] > 1.6 * max(v, 8)
                        for k, v in flags.items() if k.startswith("count:k:"))
            # the route tables need capacities from a measured rebuild
            if loose or (self._react and not self._plan.react_nw):
                self._resize_plan(flags, grow=1.3)
                return self._rebuild_on_device(_retry, relist)
        elif not self._recovering and self._k_slack(flags):
            # a cap 32 or more above the target re-tightens; never while an
            # overflow recovery is in flight, which grew the cap because
            # kmax outgrew it (JAX simulation.py:264-290)
            self._resize_plan(flags, grow=1.0)
            return self._rebuild_on_device(_retry, relist)
        self._note_k_counts(flags)
        self._flag_names = sorted(flags)
        if not relist:
            # the inputs, kept for a later re-list (copies: the state's
            # tensors may be the device loop's buffers)
            self._rb_in = (x_in.clone(), image_in.clone())
            self.state = st.replace(x=xw, image=image)
        self.nbr = nbr

    def _k_slack(self, flags) -> bool:
        """True when some tier's K cap sits 32 or more above
        _quantize_k(high-water kmax + _k_headroom)."""
        self._note_k_counts(flags)
        caps = dict(self._plan.k_caps)
        for k, v in flags.items():
            if k.startswith("count:k:") and int(v) > 0:
                name = k.split(":", 2)[2]
                target = _quantize_k(max(int(v), self._k_hwm.get(name, 0))
                                     + self._k_headroom)
                if caps[name] - target >= 32:
                    return True
        return False

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
        rebuild (or one discarded span).  `grow` pads the other capacities
        only.  The K headroom widens the re-tightening target instead."""
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
    def _one_step(self, state: State, nbr: NeighborData,
                  forces_ns: torch.Tensor) -> State:
        """One step; the force call's ns are added to `forces_ns`."""
        ctx = self.ctx
        for f in self.fixes:
            state = f.initial_integrate(state, ctx)
        for f in self.fixes:
            state = f.post_integrate(state, ctx)
        with device_span(forces_ns):
            force = self.pair.forces(state.x, state.type, nbr, state.box.h)
        state = state.replace(f=force)
        for f in self.fixes:
            state = f.post_force(state, ctx)
        for f in self.fixes:
            state = f.final_integrate(state, ctx)
        for f in self.fixes:
            state = f.end_of_step(state, ctx)
        return state.replace(step=state.step + 1)

    def _segment(self, state, nbr, nsteps: int):
        """`nsteps` steps of the host loop; returns (state, max
        displacement^2 since the list build) — the one host sync of the
        segment."""
        forces_ns = self._host_span_ns()
        with torch.no_grad():
            for _ in range(nsteps):
                state = self._one_step(state, nbr, forces_ns)
            d = state.x - nbr.x_build
            return state, float(torch.max(torch.sum(d * d, dim=-1)))

    # -- LoopDriver's hooks ---------------------------------------------------
    @property
    def step(self) -> int:
        return self.state.step

    @step.setter
    def step(self, n: int):
        self.state = self.state.replace(step=n)

    @property
    def device(self) -> torch.device:
        return self.state.x.device

    @property
    def natoms(self) -> int:
        return self.state.natoms

    def _host_rebuild(self):
        self.rebuild_neighbors()

    def _host_steps(self, nsteps: int):
        return self._segment(self.state, self.nbr, nsteps)

    def _accept(self, new_state: State):
        self.state = new_state

    def _thermo_row(self) -> dict:
        return self._thermo(self.state)

    # -- the device loop ------------------------------------------------------
    def _device_loop(self) -> DeviceLoop:
        """The loop of the current plan and configuration; a plan change,
        another pair style, fix list or fix capture_key (a ramp's window),
        dt, skin or check_every, or new type or box tensors discard the
        captured graph and capture anew."""
        st = self.state
        key = (self._plan, id(self.pair), tuple(map(id, self.fixes)),
               tuple(f.capture_key() for f in self.fixes),
               self.ctx.dt, self.skin, self.check_every, id(st.type),
               id(st.mass), id(st.box.h), self._react)
        if self._loop is None or self._loop_key != key:
            if self._loop is not None:
                self._loop.close()
                self._loop = None
            self._loop = DeviceLoop(self, self._flag_names)
            self._loop_key = key
            self.timers.add("Pair.capture", self._loop.capture_s)
        return self._loop

    def _start_span(self, loop: DeviceLoop):
        self.state = loop.start(self.state, self.nbr, self._pending_rebuild,
                                self._seg_dprev)
        self.nbr = loop.nbr
        # the last rebuild's inputs follow the loop's (restore() included)
        self._rb_in = loop.rb_in

    def _resize_relist(self, flags, retry: int):
        self._k_headroom = 10
        self._resize_plan(flags, grow=1.5 * (1.3 ** retry))
        self._rebuild_on_device(relist=True)

    def _after_span(self, res):
        """Count the span's rebuilds; a K cap left loose re-tightens."""
        self.rebuilds += res.n_rb
        if res.n_rb and not self._recovering and self._k_slack(res.flags):
            self._resize_plan(res.flags, grow=1.0)
            with self.timers.section("Neigh"):
                self._rebuild_on_device(relist=True)

    # -- set-up and output --------------------------------------------------
    def _ensure_neighbors(self):
        if self.nbr is None or float(self.nbr.max_displacement_sq(
                self.state.x)) > (0.5 * self.skin) ** 2:
            with self.timers.section("Neigh"):
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

    def memory_usage(self) -> dict:
        """Device MiB by subsystem, under the JAX Engine's keys (the
        analogue of LAMMPS's per-rank 'Memory usage' line), plus graph_mb:
        the device loop's own buffers and its captured graphs' pool."""

        def mib(ts):
            return sum(t.numel() * t.element_size() for t in ts) / 2 ** 20

        st = self.state
        out = {"state_mb": mib([st.x, st.v, st.f, st.type, st.q, st.image,
                                st.mass]),
               "neighbor_mb": mib(tensors(self.nbr)) if self.nbr else 0.0,
               "pair_tables_mb": mib([v for v in vars(self.pair).values()
                                      if torch.is_tensor(v)]),
               "graph_mb": (self._loop.nbytes() / 2 ** 20 if self._loop
                            else 0.0)}
        out["total_mb"] = sum(out.values())
        return out
