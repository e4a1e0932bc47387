"""The sharded engine's per-device placement: each shard on its own device
and stream, as each JAX shard lives on its own device of a Mesh
(lammps_plugins_tpu/parallel/sharded_engine.py:191-204).

ShardedEngine(...) returns a PerDeviceEngine when its shards name more
than one distinct device, or with placement="per_device" (one device: the
CPU parity tests and the one-card checks).  Shard d keeps on devices[d]:
its rows (a ShardState of n_cap rows, `blocks[d]`), its halo tables
(`halos[d]`, HaloTables without the leading shard axis), its lists
(`nbrs[d]`), its fix state (extras; the scalars, identical on every shard,
exist once a shard) and copies of the pair style, the box, the masses and
the geometry.  Every program that spans the shards (the resettle, the
steps, the force set-up, the thermo parts) is one function of a shard run
by collectives.Lockstep, with the stacked engine's cross-shard gathers
turned into collectives:

  * the migration's movers (`_migrate_axis`, JAX :448-480) and each halo
    stage's export rows and counts (`_gather_halo`, JAX :767-778) are
    ppermutes of the rows the sender exports;
  * the resettle's flags and the segment's largest displacement
    (`_max_disp`) are pmaxes, so every shard holds the same value;
  * ctx.asum in a fix's hook (fix nvt's temperature, fix bfield's fsum) is
    a psum; each shard's hooks see its own block (ctx.shard = d), so fix
    langevin draws block d's noise under fold_in(key, d) and fix nvt's
    chain evolves identically on every shard.

Each shard's arithmetic is the stacked layout's on its block: NVE and
Langevin runs equal the stacked layout's bit for bit on one device; with
fix nvt or fix bfield only the order of the psum differs.  The thermo row
sums the shards' E and W in shard order, as the stacked layout does.

The loop is LoopDriver's host loop: one host read of the pmax'd
displacement per segment, dprev carried across spans, one host read of
the resettle's flags.  On CUDA shards (fused_loop not False) a segment of
check_every steps and the resettle are each a Program: the pieces between
collectives captured as one CUDA graph per shard, replayed in order by
the host with the collectives, which are copies ordered by events across
the streams, run between them (a graph cannot wait on an event of another
capture, and PyTorch captures one device per graph).  The resettle's
program reads its own copy of the shards' rows and keeps what it makes
(rows, halo tables, lists, flags) on its own tensors, which the next
segment's _load copies into that program's buffers.  Graph and eager runs
make the same calls, so they give the same trajectory bit for bit.
Nothing falls back: a failed capture or replay raises.

Tensors cross between the shards' streams and the caller's only at
`_crossing()`, which synchronizes the shards' devices on both sides.

Spans and counters.  Each shard has a span slot (int64 [3] on its device,
`_span_slots`): the steps of a segment stamp the pair style's force call
into slot[FORCES] on the shard's stream (inside the captured pieces), and
the segment's collectives stamp their event waits and copies into
slot[COLLECTIVE] and the copies alone into slot[COPY] on each receiving
stream (collectives.Collective).  run() zeroes the slots at its start and
reads them once at its end (_book_spans), booking each span as the mean
over the shards' streams: Pair.forces, Comm.collective and Comm.copy, and
the Comm row as Comm.collective moved out of Pair.  The resettle's
collectives are not stamped (its time is Neigh).  `captures` counts the
programs captured, segments' and resettles' (a re-size or a new plan
captures both anew), `regrows` the capacity re-sizes, and LoopDriver the
discarded segments.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch

from ..core.box import Box, matvec3
from ..core.state import State
from ..fixes.base import StepContext
from ..run.device_loop import KERNEL_MODULES, _nested, extras_items, tensors
from ..run.timers import device_span
from .collectives import COLLECTIVE, COPY, FORCES, Lockstep, ShardGroup
from .sharded_engine import (HALO_X, HALO_Y, HaloTables, ShardedEngine,
                             ShardState)

_ROWS = ("x", "v", "f", "image", "type", "q", "tag", "valid")


class PerDeviceEngine(ShardedEngine):
    """The sharded engine with every shard on its own device and stream
    (module docstring).  `shards` and `halo` are the stacked views
    (gathered on devices[0]; assigning `shards` scatters), so that the
    stacked layout's callers and checks read both placements alike."""

    #: seconds a shard may wait for its turn before the run raises
    shard_timeout = 600.0

    # -- set-up ---------------------------------------------------------------
    def _place(self, state: State, devices: List[torch.device]):
        """One stream a CUDA shard; a card the machine lacks raises."""
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        for d in devices:
            if d.type == "cuda" and (d.index is None or d.index >= n_cuda):
                raise ValueError(f"shard device {d}: the machine has {n_cuda}"
                                 " CUDA devices")
        self.group = ShardGroup(devices)
        self.device = devices[0]
        self.blocks: List[ShardState] | None = None
        self.halos: List[HaloTables] | None = None
        self._prog = None
        self._prog_key = None
        self._rs_prog = None
        self._rs_key = None
        self.captures = 0

    def _setup_geometry(self, state: State):
        """The stacked arithmetic's geometry, then each shard's copies of
        it, of the pair style (bound per shard), the box and the masses."""
        super()._setup_geometry(state)
        devs = self.group.devices
        self.box = _box_on(state.box, self.device)
        self._geo = [self._geometry(dev) for dev in devs]
        self._pairs = [self.pair.to(dev) for dev in devs]
        self._boxes = [_box_on(state.box, dev) for dev in devs]
        self._masses = [state.mass.to(dev) for dev in devs]
        self._span_slots = [torch.zeros(3, dtype=torch.int64, device=dev)
                            for dev in devs]
        self.lockstep = Lockstep(self.group, self.shard_timeout)

    def _pack_initial(self, state: State):
        cols = self._packed_np(state)
        n = self.n_cap
        blocks = []
        for d, dev in enumerate(self.group.devices):
            with self.group.on(d):
                blocks.append(ShardState(step=int(state.step), extras={}, **{
                    a: torch.as_tensor(v[d * n:(d + 1) * n], dtype=t,
                                       device=dev)
                    for a, (v, t) in cols.items()}))
        self.blocks = blocks
        self._mass = self._masses[0]
        self.ctx = StepContext(units=self.units, dt=self.dt,
                               natoms_global=self.natoms,
                               shards=(self.n_devices, self.n_cap))

    # -- the stacked views ----------------------------------------------------
    @contextlib.contextmanager
    def _crossing(self):
        """Tensors pass between the shards' streams and the caller's:
        every device of the shards synchronized before and after."""
        self.group.synchronize()
        try:
            yield
        finally:
            self.group.synchronize()

    @property
    def shards(self) -> ShardState:
        """The shards' blocks stacked on devices[0] (copies): per-atom
        extras stacked, the other extras shard 0's."""
        n = self.n_cap
        dev0 = self.device
        with self._crossing():
            cols = {a: torch.cat([getattr(b, a).to(dev0) for b in self.blocks])
                    for a in _ROWS}
            per = [dict(extras_items(b.extras)) for b in self.blocks]
            extras = _nested(
                (p, torch.cat([e[p].to(dev0) for e in per])
                 if _per_atom(t, n) else t.to(dev0))
                for p, t in per[0].items())
        return ShardState(step=self.blocks[0].step, extras=extras, **cols)

    @shards.setter
    def shards(self, ss: ShardState):
        """Scatter a stacked ShardState onto the shards (copies; per-atom
        extras split, the others copied to every shard)."""
        n = self.n_cap
        rows = self.n_devices * n
        out = []
        with self._crossing():
            for d, dev in enumerate(self.group.devices):
                sl = slice(d * n, (d + 1) * n)
                with self.group.on(d):
                    out.append(ShardState(
                        step=int(ss.step),
                        extras=_nested(
                            (p, (t[sl] if _per_atom(t, rows) else t)
                             .to(dev, copy=True))
                            for p, t in extras_items(ss.extras)),
                        **{a: getattr(ss, a)[sl].to(dev, copy=True)
                           for a in _ROWS}))
        self.blocks = out

    @property
    def halo(self) -> HaloTables:
        """The shards' halo tables stacked on devices[0] (copies)."""
        with self._crossing():
            return HaloTables(**{
                f.name: torch.stack([getattr(h, f.name).to(self.device)
                                     for h in self.halos])
                for f in dataclasses.fields(HaloTables)})

    @halo.setter
    def halo(self, value):
        if value is not None:
            raise AttributeError("the per-device halo tables are per shard "
                                 "(halos)")

    @property
    def step(self) -> int:
        return self.blocks[0].step

    @step.setter
    def step(self, n: int):
        self.blocks = [b.replace(step=n) for b in self.blocks]

    def shard_launches(self) -> List[Dict[str, int]]:
        """Each shard's kernel launches by wrapper module since the counts
        were last zeroed (reset_shard_launches)."""
        return [dict(zip(KERNEL_MODULES, c)) for c in self.group.launches]

    def reset_shard_launches(self):
        self.group.launches = [[0] * len(KERNEL_MODULES)
                               for _ in self.group.devices]

    # -- a shard's pieces -----------------------------------------------------
    def _shard_state(self, d: int, blk: ShardState) -> State:
        """Shard d's block as the State its fixes see (extras["__tag__"],
        the rows' global ids, as in _local_state)."""
        extras = dict(blk.extras)
        extras["__tag__"] = blk.tag
        return State(x=blk.x, v=blk.v, f=blk.f, type=blk.type, q=blk.q,
                     image=blk.image, mass=self._masses[d],
                     box=self._boxes[d], step=blk.step, extras=extras)

    def _shard_pair(self, d: int, halo: HaloTables):
        pair = self._pairs[d]
        return pair.with_charges(halo.q_loc) if pair.needs_charges else pair

    def _halo_block(self, d: int, comm, x, halo: HaloTables):
        """Shard d's [owned | halo] block of positions: each stage's export
        rows ppermuted from the neighbours (the halo refresh)."""
        blk = x
        for ax, names in ((0, HALO_X), (1, HALO_Y)):
            if self.grid[ax] <= 1:
                continue
            exp_hi, exp_lo, val_lo, val_hi = (getattr(halo, a) for a in names)
            from_back, from_fwd = self._sources(ax)
            lo_rows, hi_rows = comm.ppermute([(blk[exp_hi], from_back),
                                              (blk[exp_lo], from_fwd)])
            blk = self._with_halo(d, blk, lo_rows, hi_rows, val_lo, val_hi,
                                  ax, self._geo[d])
        return blk

    def _shard_forces(self, d, comm, x, valid, halo, nbr, slot=None):
        """Shard d's forces; the pair style's call stamped into
        slot[FORCES] when a span slot is given."""
        block = self._halo_block(d, comm, x, halo)
        with (device_span(slot[FORCES]) if slot is not None
              else contextlib.nullcontext()):
            f = self._shard_pair(d, halo).forces(block, halo.t_loc, nbr,
                                                 self._geo[d].h_slab)
        return f[:self.n_cap] * valid[:, None]

    def _shard_steps(self, d, comm, blk: ShardState, halo, nbr, nsteps,
                     slot=None):
        """(shard d's block after nsteps, md): _one_step and _max_disp on
        the shard's rows, ctx.asum a psum; the force calls stamped into
        `slot`."""
        ctx = dataclasses.replace(self.ctx, shards=None, shard=d,
                                  allreduce=comm.psum)
        with torch.no_grad():
            st = self._shard_state(d, blk)
            for _ in range(nsteps):
                st = self._verlet_step(st, ctx, lambda x: self._shard_forces(
                    d, comm, x, blk.valid, halo, nbr, slot))
            block = self._halo_block(d, comm, st.x, halo)
            dsp = block - nbr.x_build
            d2 = torch.sum(dsp * dsp, dim=1)
            m = torch.max(torch.where(halo.valid_loc, d2,
                                      torch.zeros_like(d2)))
            md = comm.pmax(m).double()
        return self._from_state(blk, st), md

    def _resettle_shard(self, d: int, comm, blk: ShardState,
                        into_program: bool = True):
        """Shard d's resettle (the stacked _resettle on its rows): wrap,
        migration by ppermutes, the halo stages by ppermutes, its rebuild,
        the flags pmax'd.  Returns (block, halo tables, lists, flags); the
        lists written into the segment program's when into_program."""
        g = self._geo[d]
        Px, Py = self.grid
        dev = blk.x.device
        xw, image, fw = self._wrap(blk.x, blk.image, g)
        rows = (xw, blk.v, blk.f, image, blk.type, blk.q, blk.tag)
        valid = blk.valid
        ov_mig = torch.zeros((), dtype=torch.bool, device=dev)
        lost = torch.zeros((), dtype=torch.int64, device=dev)
        n_true = valid.sum()
        ar = torch.arange(self.n_cap, device=dev)
        for ax, P in ((0, Px), (1, Py)):
            if P <= 1:
                continue
            f_ax = fw[:, 0] if ax == 0 else \
                matvec3(rows[0] - g.lo_glob, g.hinv_glob)[:, 1]
            slab = torch.clamp((f_ax * P).to(torch.int64), 0, P - 1)
            kept, nk, ov, l_, fwd, bwd = self._emigrants(d, rows, valid, slab,
                                                         ax)
            from_back, from_fwd = self._sources(ax)
            fwd, bwd = list(fwd[0]) + [fwd[1]], list(bwd[0]) + [bwd[1]]
            got = comm.ppermute([(t, from_back) for t in fwd]
                                + [(t, from_fwd) for t in bwd])
            m = len(fwd)
            rows, n_new, ov2 = self._immigrants(
                kept, nk, (got[:m - 1], got[m - 1]),
                (got[m:2 * m - 1], got[2 * m - 1]))
            valid = ar < n_new
            n_true = n_new
            ov_mig = ov_mig | (ov | ov2)
            lost = lost + l_

        x2 = torch.where(valid[:, None], rows[0], g.park[None, :])
        t2 = torch.where(valid, rows[4], torch.ones_like(rows[4]))
        tag2 = torch.where(valid, rows[6], torch.full_like(rows[6], -1))
        q2 = rows[5]

        xb, tb, qb, vb = x2, t2, q2, valid
        tabs = {}
        nch = [torch.zeros((), dtype=torch.int64, device=dev)] * 2
        ov_h = torch.zeros((), dtype=torch.bool, device=dev)
        for ax, P, Bh, names in ((0, Px, self.Bhx, HALO_X),
                                 (1, Py, self.Bhy, HALO_Y)):
            if P <= 1:
                empty_i = torch.zeros((0,), dtype=torch.int64, device=dev)
                empty_b = torch.zeros((0,), dtype=torch.bool, device=dev)
                tabs.update(zip(names, (empty_i, empty_i, empty_b, empty_b)))
                continue
            hi, lo, nchi, nclo, nmax, ov = self._export(d, xb, vb, ax, Bh, g)
            from_back, from_fwd = self._sources(ax)
            c_lo, c_hi, x_lo, x_hi, t_lo, t_hi, q_lo, q_hi = comm.ppermute([
                (nchi, from_back), (nclo, from_fwd),
                (xb[hi], from_back), (xb[lo], from_fwd),
                (tb[hi], from_back), (tb[lo], from_fwd),
                (qb[hi], from_back), (qb[lo], from_fwd)])
            ar_h = torch.arange(Bh, device=dev)
            val_lo, val_hi = ar_h < c_lo, ar_h < c_hi
            nch[ax] = nmax
            ov_h = ov_h | ov
            xb_new = self._with_halo(d, xb, x_lo, x_hi, val_lo, val_hi, ax, g)
            tb = self._with_halo(d, tb, t_lo, t_hi, val_lo, val_hi, ax, g,
                                 fill=1, shift=False)
            qb = self._with_halo(d, qb, q_lo, q_hi, val_lo, val_hi, ax, g,
                                 fill=0.0, shift=False)
            vb = torch.cat([vb, val_lo, val_hi])
            xb = xb_new
            tabs.update(zip(names, (hi, lo, val_lo, val_hi)))
        halo = HaloTables(t_loc=tb, q_loc=qb, valid_loc=vb, **tabs)

        nbr, fl = self._rebuild_shard(d, self._pairs[d], xb, tb, vb, g)
        if into_program:
            nbr = self._into_program_lists(d, nbr)
        fl.update({"mig_overflow": ov_mig, "halo_overflow": ov_h,
                   "lost_atoms": lost, "count:slab": n_true,
                   "count:halo": nch[0], "count:haloy": nch[1]})
        names = sorted(fl)
        vec = comm.pmax(torch.stack([fl[k].to(torch.int64).reshape(())
                                     for k in names]))
        new = blk.replace(x=x2, v=rows[1], f=rows[2], image=rows[3], type=t2,
                          q=q2, tag=tag2, valid=valid)
        return new, halo, nbr, dict(zip(names, vec.unbind()))

    # -- ShardedEngine's hooks ------------------------------------------------
    def _resettle_now(self):
        blocks = self.blocks
        prog = self._resettle_program()
        if prog is None:
            out = self.lockstep.run(
                lambda d, comm: self._resettle_shard(d, comm, blocks[d]))
        else:
            for d, (blk, buf) in enumerate(zip(blocks, prog.inputs)):
                with self.group.on(d):
                    for a in _ROWS:
                        getattr(buf, a).copy_(getattr(blk, a))
            prog.replay()
            out = [(r[0].replace(step=b.step, extras=b.extras),) + r[1:]
                   for r, b in zip(prog.results, blocks)]
        new, halos, nbrs, flags = (list(c) for c in zip(*out))
        self.group.synchronize()      # the caller reads the flags
        return new, halos, nbrs, flags[0]

    def _install(self, new, halos, nbrs):
        self.blocks, self.halos, self.nbrs = new, halos, nbrs

    def _setup_forces(self):
        if self.nbrs is None:
            self.resettle()
        if self._f_valid:
            return
        blocks, halos, nbrs = self.blocks, self.halos, self.nbrs

        def shard(d, comm):
            with torch.no_grad():
                return blocks[d].replace(f=self._shard_forces(
                    d, comm, blocks[d].x, blocks[d].valid, halos[d],
                    nbrs[d]))

        self.blocks = self.lockstep.run(shard)
        self._f_valid = True

    def _per_shard(self, method: str) -> list:
        """The style's `method` on each shard's block with its centre mask
        (the stacked _per_shard), moved to devices[0]."""
        if self.nbrs is None:
            self.resettle()
        blocks, halos, nbrs = self.blocks, self.halos, self.nbrs
        n_halo = self.n_loc - self.n_cap

        def shard(d, comm):
            with torch.no_grad():
                h = halos[d]
                v = blocks[d].valid
                return getattr(self._shard_pair(d, h), method)(
                    self._halo_block(d, comm, blocks[d].x, h), h.t_loc,
                    nbrs[d], self._geo[d].h_slab,
                    center_mask=torch.cat([v, v.new_zeros(n_halo)]))

        out = self.lockstep.run(shard)
        with self._crossing():
            return [_to(r, self.device) for r in out]

    def _fused(self) -> bool:
        """The host loop (one read a segment); its segments are captured
        programs on CUDA shards (_host_steps)."""
        return False

    def _host_steps(self, nsteps: int):
        prog = self._program(nsteps)
        if prog is None:
            blocks, halos, nbrs = self.blocks, self.halos, self.nbrs
            slots = self._span_slots
            out = self.lockstep.run(lambda d, comm: self._shard_steps(
                d, comm, blocks[d], halos[d], nbrs[d], nsteps, slots[d]),
                slots=slots)
            new = [b for b, _ in out]
            md = out[0][1]
        else:
            self._load(prog)
            prog.replay()
            step = self.step + nsteps
            new = _ProgramBlocks(b.replace(step=step)
                                 for b in prog.new_blocks)
            md = prog.results[0][1]
        with self.group.on(0):
            return new, float(md)

    def _accept(self, new):
        if isinstance(new, _ProgramBlocks):
            # the program's outputs are rewritten by its next replay: keep
            # them in its input buffers, which the engine then holds
            inputs = self._prog.inputs
            for d, (src, buf) in enumerate(zip(new, inputs)):
                with self.group.on(d):
                    for (_, t), (_, u) in zip(_stepped(src), _stepped(buf),
                                              strict=True):
                        u.copy_(t)
            new = [b.replace(step=n.step) for b, n in zip(inputs, new)]
        self.blocks = list(new)

    def _advanced(self, nsteps: int):
        """Nothing to move: the Comm row is the stamped collectives'
        (_book_spans)."""

    def _book_spans(self):
        """The run's stamped spans, the mean over the shards' streams, read
        once: Pair.forces, Comm.collective, Comm.copy, and the collectives
        moved from Pair to Comm."""
        self.group.synchronize()
        ns = torch.stack([s.cpu() for s in self._span_slots]).double()
        sec = (1e-9 * ns.mean(0)).tolist()
        self.timers.add("Pair.forces", sec[FORCES])
        self.timers.add("Comm.collective", sec[COLLECTIVE])
        self.timers.add("Comm.copy", sec[COPY])
        self.timers.transfer("Pair", "Comm", sec[COLLECTIVE])

    def _start_spans(self):
        for d, s in enumerate(self._span_slots):
            with self.group.on(d):
                s.zero_()

    # -- the captured programs ------------------------------------------------
    def _resettle_program(self):
        """The captured resettle (None: run eagerly): on CUDA shards unless
        fused_loop is False, once the first resettle has fitted the plan
        to the counts; captured anew when the plan, the capacities or the
        configuration change."""
        if (not self.group.cuda or self.fused_loop is False
                or not self._plan_tightened):
            return None
        key = (self._plan, self.n_cap, self.Bhx, self.Bhy, self.B_mig,
               id(self.pair), self.skin, self.grid)
        if self._rs_prog is not None and self._rs_key == key:
            return self._rs_prog
        if self._rs_prog is not None:
            self._rs_prog.close()
            self._rs_prog = None
        self._rs_prog = _capture_resettle(self)
        self._rs_key = key
        self.captures += 1
        return self._rs_prog

    def _program(self, nsteps: int):
        """The captured program of an nsteps segment (None: run eagerly):
        on CUDA shards for segments of check_every steps unless
        fused_loop is False; captured anew when the plan, the capacities
        or the configuration change."""
        if (not self.group.cuda or self.fused_loop is False
                or nsteps != self.check_every):
            return None
        key = (self._plan, self.n_cap, self.Bhx, self.Bhy, self.B_mig,
               id(self.pair), tuple(map(id, self.fixes)),
               tuple(f.capture_key() for f in self.fixes), self.ctx.dt,
               self.skin, self.check_every, self.grid)
        if self._prog is not None and self._prog_key == key:
            return self._prog
        if self._prog is not None:
            self._prog.close()
            self._prog = None
        self._prog = _capture_segment(self, nsteps)
        self._prog_key = key
        self.captures += 1
        return self._prog

    def _load(self, prog):
        """The engine's blocks, halo tables and lists into the program's
        buffers where they are not already those buffers; the engine then
        holds the buffers."""
        for d in range(self.n_devices):
            with self.group.on(d):
                for a, b in ((self.blocks[d], prog.inputs[d]),
                             (self.halos[d], prog.halos[d])):
                    if a is b:
                        continue
                    for t, u in zip(_all_tensors(a), _all_tensors(b),
                                    strict=True):
                        if t is not u:
                            u.copy_(t)
                if self.nbrs[d] is not prog.nbrs[d]:
                    for t, u in zip(tensors(self.nbrs[d]),
                                    tensors(prog.nbrs[d]), strict=True):
                        u.copy_(t)
        self.blocks = [b.replace(step=s.step)
                       for b, s in zip(prog.inputs, self.blocks)]
        self.halos, self.nbrs = list(prog.halos), list(prog.nbrs)

    def _into_program_lists(self, d: int, nbr):
        """A resettle's lists of shard d copied into the program's list
        buffers when their shapes match (one shard's new lists alive at a
        time: at 8M atoms they are ~2 GB a shard)."""
        prog = self._prog
        if prog is None:
            return nbr
        old = list(tensors(prog.nbrs[d]))
        new = list(tensors(nbr))
        if len(old) != len(new) or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(old, new)):
            return nbr
        for a, b in zip(old, new):
            a.copy_(b)
        return prog.nbrs[d]

    def close(self):
        """Release the captured programs (their graphs and pools)."""
        for a in ("_prog", "_rs_prog"):
            if getattr(self, a) is not None:
                getattr(self, a).close()
                setattr(self, a, None)


def _capture_segment(eng: PerDeviceEngine, nsteps: int):
    """The segment's Program: buffers cloned from the engine's blocks and
    halo tables (its lists adopted as they are), one eager run of the
    segment on them (kernels built, caches filled; its spans stamped into
    slots that are dropped), then the capture, stamping into the engine's
    span slots at each replay."""
    n = eng.n_devices
    inputs, halos = [], []
    for d in range(n):
        with eng.group.on(d):
            inputs.append(_cloned_block(eng.blocks[d]))
            halos.append(HaloTables(**{
                f.name: getattr(eng.halos[d], f.name).clone()
                for f in dataclasses.fields(HaloTables)}))
    nbrs = list(eng.nbrs)

    def body(slots):
        return lambda d, comm: eng._shard_steps(
            d, comm, inputs[d], halos[d], nbrs[d], nsteps, slots[d])

    warm = [torch.zeros_like(s) for s in eng._span_slots]
    eng.lockstep.run(body(warm), slots=warm)   # warm-up, results dropped
    prog = eng.lockstep.capture(body(eng._span_slots),
                                slots=eng._span_slots)
    for d, (blk, _) in enumerate(prog.results):
        if [p for p, _ in extras_items(blk.extras)] != \
                [p for p, _ in extras_items(inputs[d].extras)]:
            raise RuntimeError("a captured segment changed the keys of "
                               "extras")
    prog.inputs, prog.halos, prog.nbrs = inputs, halos, nbrs
    prog.new_blocks = [b for b, _ in prog.results]
    return prog


def _capture_resettle(eng: PerDeviceEngine):
    """The resettle's Program: the rows of the engine's blocks cloned into
    its input buffers (`inputs`, extras left out: the resettle passes them
    through), one eager run on them (kernels built, the rebuild's
    constants made), then the capture."""
    inputs = []
    for d, blk in enumerate(eng.blocks):
        with eng.group.on(d):
            inputs.append(blk.replace(extras={}, **{
                a: getattr(blk, a).clone() for a in _ROWS}))

    def body(d, comm):
        return eng._resettle_shard(d, comm, inputs[d], into_program=False)

    eng.lockstep.run(body)                     # warm-up, results dropped
    prog = eng.lockstep.capture(body)
    prog.inputs = inputs
    return prog


def _stepped(blk: ShardState):
    """(key, tensor) of what a step changes: x, v, f and every extras
    tensor."""
    return ([(a, getattr(blk, a)) for a in ("x", "v", "f")]
            + extras_items(blk.extras))


def _all_tensors(obj):
    if isinstance(obj, ShardState):
        return [getattr(obj, a) for a in _ROWS] + [
            t for _, t in extras_items(obj.extras)]
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def _cloned_block(blk: ShardState) -> ShardState:
    return blk.replace(
        extras=_nested((p, t.clone()) for p, t in extras_items(blk.extras)),
        **{a: getattr(blk, a).clone() for a in _ROWS})


def _per_atom(t: torch.Tensor, rows: int) -> bool:
    """A per-atom extras tensor of a block of `rows` rows (the test the
    stacked _grow makes)."""
    return t.dim() >= 1 and t.shape[0] == rows


def _to(r, dev):
    if torch.is_tensor(r):
        return r.to(dev)
    return type(r)(_to(x, dev) for x in r)


def _box_on(box: Box, dev) -> Box:
    return dataclasses.replace(box, h=box.h.to(dev), lo=box.lo.to(dev))


class _ProgramBlocks(list):
    """A captured segment's output blocks (on the program's own tensors,
    which its next replay rewrites)."""
