"""The host half of the MD loop, shared by run/simulation.Engine and
parallel/sharded_engine.ShardedEngine (the JAX package keeps a copy in
each): run()'s span loop with its thermo rows and callbacks, the host
loop's rebuild rule, and the device loop's span protocol (replays, one
read, and on an overflow: discard the span, re-size, re-list, run it
again).  The device half, one iteration of the loop body, is
run/device_loop.GraphIteration.

A subclass holds the state and the lists and provides:

  step (property with a setter)    the state's step count
  device                           the state's device
  natoms, n_devices                for the timers
  device_rebuild                   False takes the host loop only
  overflow_retries                 re-sizes before an overflow raises
  _setup_forces()                  forces valid for the first half-kick
  _thermo_row() -> dict            a thermo row at the current state
  state                            the global State that callbacks get
  _host_rebuild()                  a rebuild at the current positions
  _host_steps(n) -> (new, md)      n steps from the current state, not
                                   kept yet; md the largest squared
                                   displacement since the rebuild (float);
                                   a step may stamp its force call into
                                   _host_span_ns()
  _accept(new)                     keep what _host_steps made
  _device_loop() -> GraphIteration the loop of the current plan
  _start_span(loop)                load the state into the loop and take
                                   the loop's buffers as the state
  _resize_relist(flags, retry)     re-size after an overflowed span and
                                   re-list the last rebuild before it
  _after_span(res)                 count the span's rebuilds, tighten
  _advanced(n)                     n more steps kept (optional)
  _start_spans(), _book_spans()    zero the run's device span slots at its
                                   start, read and book them at its end
                                   (optional; by default _host_span_ns())

A segment that the rebuild rule discards is counted on the host:
timers.counts["redone_segments"] and ["redone_steps"].
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

#: segments per span of the device loop at most: a span that overflows is
#: run again whole, so this bounds the redone work (JAX simulation.py:720)
SPAN_SEGMENTS = 16


def _overflowed(flags) -> bool:
    return any(v for k, v in flags.items() if "overflow" in k)


class LoopDriver:
    """run(), the host loop's segment and the device loop's span."""

    device_rebuild = True
    _pending_rebuild = False       # the rebuild rule's state (host side)
    _seg_dprev = 0.0
    _recovering = False            # a span-overflow recovery in flight
    _host_ns = None                # the host loop's force spans in run()

    def _host_span_ns(self) -> torch.Tensor:
        """The slot (ns, on the state's device) that the host loop's steps
        stamp their force calls into; run() books it with one read."""
        if self._host_ns is None:
            self._host_ns = torch.zeros((), dtype=torch.int64,
                                        device=self.device)
        return self._host_ns

    def _advanced(self, nsteps: int):
        pass

    def _start_spans(self):
        self._host_ns = None

    def _book_spans(self):
        if self._host_ns is not None:
            self.timers.add("Pair.forces", 1e-9 * int(self._host_ns))

    def _fused(self) -> bool:
        fused = self.fused_loop
        if fused is None:
            fused = self.device.type == "cuda"
        return bool(fused) and self.device_rebuild

    # -- the host loop ----------------------------------------------------
    def _host_segment(self, nsteps: int) -> int:
        """One iteration of the rebuild rule on the host; returns the steps
        it advanced (0 for a discarded segment)."""
        pending = self._pending_rebuild
        if pending:
            with self.timers.section("Neigh"):
                self._host_rebuild()
        half2 = (0.5 * self.skin) ** 2
        with self.timers.section("Pair"):
            new, md = self._host_steps(nsteps)
        tripped = md > half2
        if pending or not tripped:
            self._accept(new)
        else:
            self.timers.count("redone_segments")
            self.timers.count("redone_steps", nsteps)
        # a discarded segment re-runs from its start after the rebuild that
        # `tripped` asks for; a fresh-list segment that trips is kept, and
        # the next one rebuilds first
        d = math.sqrt(md)
        growth = max(d - self._seg_dprev, 0.0)
        self._pending_rebuild = d + growth > 0.95 * math.sqrt(half2) \
            or tripped
        self._seg_dprev = d
        return nsteps if pending or not tripped else 0

    # -- the device loop --------------------------------------------------
    def _run_span_device(self, nsteps: int, _retry: int = 0):
        """Advance `nsteps` (a multiple of check_every): iterations of the
        device loop, one host read of the control vector per batch of
        them, more iterations while discarded segments leave steps to do.
        A lost atom raises.  An overflow flag discards the span, re-sizes,
        re-lists and runs the span again (JAX simulation.py:503-557,
        sharded_engine.py:1096-1131)."""
        loop = self._device_loop()
        step0 = self.step
        self._start_span(loop)
        reps = nsteps // self.check_every
        while True:
            loop.replay(reps)
            res = loop.read()
            if _overflowed(res.flags) or res.done >= nsteps:
                break
            reps = (nsteps - res.done) // self.check_every
        # the span's device time, a discarded one's too: its rebuilds are
        # Neigh, not the Pair section open around it; its force calls (the
        # Engine's steps stamp theirs, the sharded engine's none) Pair.forces
        self.timers.inner("Neigh", res.rebuild_s)
        if res.forces_s:
            self.timers.add("Pair.forces", res.forces_s)
        if res.n_rb and res.flags.get("lost_atoms"):
            raise RuntimeError(
                f"{res.flags['lost_atoms']} atoms moved more than one slab "
                "between reneighbor events: check_every too large")
        if _overflowed(res.flags):
            if _retry >= self.overflow_retries:
                raise RuntimeError(f"device rebuild overflow persists: "
                                   f"{res.flags}")
            # a truncated list stepped physics: discard the whole span,
            # re-size from the measured counts, re-list the last rebuild
            # before the span, run it again
            loop.restore()
            self.step = step0
            self._recovering = True
            try:
                with self.timers.section("Neigh"):
                    self._resize_relist(res.flags, _retry)
                return self._run_span_device(nsteps, _retry + 1)
            finally:
                self._recovering = False
        self.step = step0 + res.done
        self._pending_rebuild, self._seg_dprev = res.pending, res.dprev
        self._f_valid = True
        self._after_span(res)

    # -- the run ----------------------------------------------------------
    def run(self, nsteps: int, thermo_every: int = 0,
            on_thermo: Callable[[dict], None] | None = None,
            callbacks: Sequence[tuple] = ()):
        """Run `nsteps`; thermo rows every `thermo_every` steps, step 0
        included (like LAMMPS).  callbacks: (every, fn) pairs; fn(state)
        runs at the start and whenever the step count reaches a multiple
        of `every` (dumps, restarts), with the global State."""
        self.timers.start_run(self.natoms, chips=self.n_devices)
        self._start_spans()
        self._setup_forces()
        rows = []

        def boundaries(done):
            if thermo_every and done % thermo_every == 0:
                with self.timers.section("Output"), \
                        self.timers.section("Output.thermo"):
                    row = self._thermo_row()
                rows.append(row)
                if on_thermo:
                    on_thermo(row)
            st = None
            for every, fn in callbacks:
                if done % every == 0:
                    with self.timers.section("Output"):
                        if st is None:
                            st = self.state
                        fn(st)

        boundaries(0)
        done = 0
        while done < nsteps:
            span = nsteps - done
            if thermo_every:
                span = min(span, thermo_every - (done % thermo_every))
            for every, _ in callbacks:
                span = min(span, every - (done % every))
            if self._fused() and span >= self.check_every:
                m = min((span // self.check_every) * self.check_every,
                        SPAN_SEGMENTS * self.check_every)
                with self.timers.section("Pair"):
                    self._run_span_device(m)
                adv = m
            else:
                adv = self._host_segment(min(self.check_every, span))
            if adv:
                self._advanced(adv)
                done += adv
                boundaries(done)
        self._book_spans()
        self.timers.end_run(nsteps)
        self.thermo_rows = rows
        return rows
