"""Per-section wall-time breakdown and performance summary (the port's own
copy of lammps_plugins_tpu/run/timers.py, which the port does not import).

The reference host prints a timing breakdown (Pair/Neigh/Comm/Output/
Modify, log.rebomos-bulk.1:62-70) and a performance line in ns/day,
timesteps/s and katom-step/s (log.rebomos-bulk.1:59); this module
reproduces both for the Engine's host loop:

  * Pair   -> the step segments and device-loop spans (force evaluation
              dominates)
  * Neigh  -> neighbor rebuilds: eager ones in sections of their own,
              the device loop's measured on the device (`inner`)
  * Comm   -> zero on one device
  * Output -> thermo rows and dump frames
  * Other  -> host orchestration

Parts of a section are dotted keys under it, never summed into the
breakdown: `Pair.forces` (the pair style's force call of each step, device
seconds), `Pair.capture` (the host wall of capturing a device loop),
`Output.thermo` and `Output.dump.{compute,copy,text}`.  Every section and
part timed on the host also opens a torch.profiler range `lpt.<key>`, so
that a trace puts the program's spans on the device ops' timeline.  The
range is a host op (`_RecordFunctionFast`), not a user annotation: Kineto
mirrors a user annotation on the device's timeline as one span over the
kernels launched inside it, which a trace would count as busy device
time through every gap between them.

Spans on the device are stamps: `stamp` adds minus the clock (ns) to an
int64 slot at a span's start and plus at its end, on a CUDA slot by a
one-thread kernel on the current stream that reads %globaltimer (a CUDA
graph captures it with the span's work), on a CPU slot from
perf_counter_ns.  The slot sums its spans; its owner reads it with a copy
it already makes and books the seconds.

Counts of events the loop decides on the host sit beside the seconds in
`counts` (`count`): `redone_segments` and `redone_steps`, the host loop's
segments discarded by the rebuild rule and run again.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import torch

from ..ops import build


def stamp(slot: torch.Tensor, sign: int):
    """slot += sign * the clock in ns (slot: a 0-d int64 tensor)."""
    if slot.is_cuda:
        build.raise_on_error(build.lib().lpt_stamp(
            slot.data_ptr(), sign, build.stream(slot.device)), "lpt_stamp")
    else:
        slot.add_(sign * time.perf_counter_ns())


@contextmanager
def device_span(slot: torch.Tensor):
    """Add the ns of the block's work to `slot`, on the slot's device."""
    stamp(slot, -1)
    yield
    stamp(slot, 1)


class Timers:
    SECTIONS = ("Pair", "Neigh", "Comm", "Output", "Other")

    def __init__(self):
        self.acc: Dict[str, float] = {s: 0.0 for s in self.SECTIONS}
        self.counts: Dict[str, int] = dict(redone_segments=0,
                                           redone_steps=0)
        self._open = []            # per open section: seconds booked inside
        self._wall_start = None
        self.steps = 0
        self.natoms = 0

    @contextmanager
    def section(self, name: str):
        """Book the block's wall time under `name`.  A section opened
        inside another keeps its time from the outer one (a re-list inside
        a Pair span is Neigh); a dotted part is inside its section's."""
        part = "." in name
        if not part:
            self._open.append(0.0)
        t0 = time.perf_counter()
        try:
            with torch._C._profiler._RecordFunctionFast("lpt." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            if not part:
                inside = self._open.pop()
                if self._open:
                    self._open[-1] += dt
                dt -= inside
            self.add(name, dt)

    def inner(self, name: str, seconds: float):
        """Book `seconds` measured inside the innermost open section under
        the section `name`, as a section opened there would be booked."""
        self.add(name, seconds)
        if self._open:
            self._open[-1] += seconds

    def add(self, key: str, seconds: float):
        self.acc[key] = self.acc.get(key, 0.0) + seconds

    def count(self, key: str, n: int = 1):
        self.counts[key] = self.counts.get(key, 0) + n

    def transfer(self, src: str, dst: str, seconds: float):
        """Re-attribute time between sections (e.g. the sharded engine's
        halo refresh booked under Pair -> Comm)."""
        seconds = max(0.0, min(seconds, self.acc.get(src, 0.0)))
        self.acc[src] = self.acc.get(src, 0.0) - seconds
        self.acc[dst] = self.acc.get(dst, 0.0) + seconds

    def start_run(self, natoms: int, chips: int = 1):
        self._wall_start = time.perf_counter()
        self.natoms = natoms
        self.chips = chips

    def end_run(self, nsteps: int):
        self.steps += nsteps
        self.wall = time.perf_counter() - self._wall_start

    # -- report ------------------------------------------------------------
    def performance_summary(self, dt: float) -> str:
        """The reference's Performance + breakdown lines (log:57-70)."""
        wall = max(self.wall, 1e-12)
        steps_s = self.steps / wall
        atom_steps = steps_s * self.natoms
        ns_day = self.steps * dt * 1e-3 * 86400 / wall   # dt in ps
        chips = getattr(self, "chips", 1)
        lines = [
            f"Loop time of {wall:.6g} on {chips} chip"
            f"{'s' if chips != 1 else ''} for {self.steps} steps "
            f"with {self.natoms} atoms",
            "",
            f"Performance: {ns_day:.3f} ns/day, {steps_s:.3f} timesteps/s, "
            f"{atom_steps/1000:.3f} katom-step/s",
            "",
            "Section |  time  | %total",
            "-------------------------",
        ]
        rows = {s: self.acc.get(s, 0.0) for s in self.SECTIONS}
        rows["Other"] += max(wall - sum(rows.values()), 0.0)
        for name in self.SECTIONS:
            t = rows[name]
            lines.append(f"{name:<7} | {t:6.4g} | {100*t/wall:5.2f}")
        return "\n".join(lines)
