"""Per-section wall-time breakdown and performance summary (the port's own
copy of lammps_plugins_tpu/run/timers.py, which the port does not import).

The reference host prints a timing breakdown (Pair/Neigh/Comm/Output/
Modify, log.rebomos-bulk.1:62-70) and a performance line in ns/day,
timesteps/s and katom-step/s (log.rebomos-bulk.1:59); this module
reproduces both for the Engine's host loop:

  * Pair   -> the step segments and device-loop spans (force evaluation
              dominates)
  * Neigh  -> neighbor rebuilds (in-loop ones moved out of Pair with
              `transfer`)
  * Comm   -> zero on one device
  * Output -> thermo rows
  * Other  -> host orchestration
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class Timers:
    SECTIONS = ("Pair", "Neigh", "Comm", "Output", "Other")

    def __init__(self):
        self.acc: Dict[str, float] = {s: 0.0 for s in self.SECTIONS}
        self._wall_start = None
        self.steps = 0
        self.natoms = 0

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] = self.acc.get(name, 0.0) + time.perf_counter() - t0

    def transfer(self, src: str, dst: str, seconds: float):
        """Re-attribute time between sections (e.g. in-loop neighbor
        rebuilds booked under a fused span's Pair time -> Neigh)."""
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
        other = wall - sum(self.acc.values())
        rows = dict(self.acc)
        rows["Other"] = rows.get("Other", 0.0) + max(other, 0.0)
        for name in ("Pair", "Neigh", "Comm", "Output", "Other"):
            t = rows.get(name, 0.0)
            lines.append(f"{name:<7} | {t:6.4g} | {100*t/wall:5.2f}")
        return "\n".join(lines)
